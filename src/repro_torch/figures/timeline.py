"""Figures 5 / 7a — interleaving timelines and time to interleave
(``benchmarks/timeline.py``).

The paper's dynamic claim: MLTCP flows "stabilize into an interleaved
state within a few training iterations".  This suite arms the probes
(`netsim.telemetry`): decimated per-flow cwnd / rate and per-link queue
series, and the streaming interleave detector whose time to interleave is
the claim as a number, for MLTCP-Reno, MLTCP-CUBIC and MLQCN against their
unmodified baselines on a 2-job dumbbell.  On the card the probes and the
detector run inside the chunk kernel's armed specializations.

The suite holds the paper's shape: every MLTCP variant converges within
``MAX_TTI_ITERS`` training iterations, the baselines never do.  The
timelines land in ``results/timelines_torch/<algo>.npz`` for plotting, and
the run records `PlanResult.profile` (per-group time split and device
footprint).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch import netsim
from repro_torch.figures import common

# the paper's "within a few training iterations" bound we hold MLTCP to
MAX_TTI_ITERS = 10.0

TIMELINES_DIR = os.path.join("results", "timelines_torch")


def _telemetry_spec(sim_time: float) -> netsim.TelemetrySpec:
    n_ticks = int(round(sim_time / common.DT))
    stride = max(1, n_ticks // 1000)
    return netsim.TelemetrySpec(
        probes=("flow_cwnd", "flow_rate", "link_queue", "link_mark_rate",
                "job_incomm", "job_iter", "interleave_overlap"),
        stride=stride)


def telemetry_spec() -> netsim.TelemetrySpec:
    """The suite's probe arming: Fig. 5/7a series + both detectors.

    The stride targets ~1000 samples per run at any SIM_TIME, so the
    capture's footprint is flat whether smoke (1.5 s) or full (20 s).
    """
    return _telemetry_spec(common.SIM_TIME)


def _mean_finite(xs: list[float]) -> float:
    xs = [x for x in xs if np.isfinite(x)]
    return float(np.mean(xs)) if xs else float("inf")


def _jsonable(x: float):
    return x if np.isfinite(x) else None      # inf: keep the JSON strict


def _save_timeline(algo: str, res: netsim.SimResult) -> str:
    tl = res.telemetry
    os.makedirs(TIMELINES_DIR, exist_ok=True)
    path = os.path.join(TIMELINES_DIR, f"{algo}.npz")
    np.savez_compressed(
        path, t=tl.t,
        flow_cwnd=tl.series["flow_cwnd"],
        flow_rate=tl.series["flow_rate"],
        link_queue=tl.series["link_queue"],
        job_incomm=tl.series["job_incomm"],
        overlap=tl.series["interleave_overlap"],
        time_to_interleave_s=tl.time_to_interleave_s,
        time_to_interleave_iters=tl.time_to_interleave_iters)
    return path


def _failures(algo: str, tti_ml: list[float], base_converged: list[bool],
              tti_base: list[float]) -> list[str]:
    """The suite's claim on one algorithm, failed assertion by assertion
    (empty when it holds): every MLTCP run interleaves within
    MAX_TTI_ITERS iterations (``tti_ml``, inf for never), and no baseline
    run converges."""
    failed = []
    if not all(np.isfinite(x) and x <= MAX_TTI_ITERS for x in tti_ml):
        failed.append(f"{algo}: MLTCP time-to-interleave {tti_ml} exceeds "
                      f"{MAX_TTI_ITERS}")
    if any(base_converged):
        failed.append(f"{algo}: unmodified baseline unexpectedly "
                      f"interleaved {tti_base}")
    return failed


def _summarize(algo: str, base: list[netsim.SimResult],
               ml: list[netsim.SimResult]) -> dict:
    tti_ml = [netsim.convergence_iteration(r) for r in ml]
    tti_base = [netsim.convergence_iteration(r) for r in base]
    peak_q = float(np.max([r.telemetry.series["link_queue"].max()
                           for r in ml]))
    out = {
        "algo": algo,
        "tti_iters": _jsonable(_mean_finite(tti_ml)),
        "tti_seconds": _jsonable(_mean_finite(
            [netsim.time_to_interleave(r) for r in ml])),
        "baseline_tti_iters": _jsonable(_mean_finite(tti_base)),
        "converged_frac": float(np.mean(
            [r.telemetry.converged for r in ml])),
        "baseline_converged_frac": float(np.mean(
            [r.telemetry.converged for r in base])),
        "interleave_stability": float(np.mean(
            [r.telemetry.interleave_stability for r in ml])),
        "p50_iter_s": netsim.iter_time_quantile(ml[0], 0.50),
        "p99_iter_s": netsim.iter_time_quantile(ml[0], 0.99),
        "baseline_p99_iter_s": netsim.iter_time_quantile(base[0], 0.99),
        "peak_queue_bytes": peak_q,
        "timeline_npz": _save_timeline(algo, ml[0]),
    }
    # the paper's claim, enforced: MLTCP interleaves within a few
    # iterations; the unmodified baseline stays synchronized
    failed = _failures(algo, tti_ml, [r.telemetry.converged for r in base],
                       tti_base)
    if failed:
        raise AssertionError(failed[0])
    return out


# paper §4.1: TCP jobs open parallel sockets, RoCE uses a single QP — and
# MLQCN's rate-based adjustment needs the single-QP setup to interleave
# within a few iterations (multi-QP splits the per-flow signal)
SOCKETS = {"reno": 2, "cubic": 2, "dcqcn": 1}


def make_plan(algos=("reno", "cubic", "dcqcn"), sockets=None) -> netsim.Plan:
    """The fig 5 grid as a plan (lintable via ``python -m
    repro_torch.analysis --plan fig5``; the verifier stamps
    `telemetry_spec()` on to lint the armed runs)."""
    profs = common.gpt2(2)

    def build(pt):
        n_sock = SOCKETS[pt["algo"]] if sockets is None else sockets
        topo = netsim.dumbbell(2, sockets_per_job=n_sock)
        return common.build_cfg(topo, profs,
                                common.protocol(pt["algo"], pt["variant"]))

    return common.plan(
        build, name="fig5-timeline",
        algo=tuple(algos), variant=("OFF", "WI"), seed=common.seed_axis())


def run(algos=("reno", "cubic", "dcqcn"), sockets=None, device=None
        ) -> tuple[dict, int]:
    pr = common.run_plan(make_plan(algos, sockets), device=device,
                         telemetry=telemetry_spec(), profile=True)
    out = {algo: _summarize(algo,
                            pr.select(algo=algo, variant="OFF"),
                            pr.select(algo=algo, variant="WI"))
           for algo in algos}
    out["_profile"] = pr.profile.summary()
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    res, _ = run()
    print(json.dumps(res, indent=1))
