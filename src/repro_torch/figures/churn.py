"""Fault-injection gauntlet — re-convergence under churn, flaps and
blackholes (``benchmarks/churn.py``).

The paper's robustness claim (§1, §5.4) is that MLTCP interleaves
"regardless of the number of competing flows or the start time of each
flow": a claim about re-convergence, not only cold starts.  This suite runs
a 3-job contended dumbbell through a scripted gauntlet (arrival ->
first-hop blackhole -> departure -> re-arrival -> bottleneck flap) and
measures, per fault-event window, how many training iterations MLTCP needs
to re-interleave (`netsim.telemetry`'s "reinterleave" detector), for
MLTCP-Reno / MLTCP-CUBIC / MLQCN against their unmodified baselines.  On
the card the faults and detectors run inside the chunk kernel's armed
specializations.

The suite holds the robustness shape: after every fault boundary MLTCP
re-stabilizes within ``MAX_REINTERLEAVE_ITERS`` training iterations (the
window while a socket blackhole is null-routing is reported but exempt)
and keeps interleave stability >= 0.95 across the gauntlet; the baselines
never shake off their synchronized episodes (at least one fault window
never re-converges, and their stability sits below MLTCP's).  The JAX
reference itself fails the Reno re-interleave bound at seeds 1-3, so
``run()`` raises there as it does; ``run(algos=("cubic", "dcqcn"))``
holds.  Fault schedules are sweep leaves through an ``Axis(field="*")``,
so the schedule grid runs as one group per (algo, variant).
"""
from __future__ import annotations

import numpy as np

from repro_torch import netsim
from repro_torch.figures import common

# the paper's "within a few training iterations" bound, held per fault event
MAX_REINTERLEAVE_ITERS = 10.0

# §4.1 socket counts (multi-socket TCP, single-QP RoCE), as in timeline.py
SOCKETS = {"reno": 2, "cubic": 2, "dcqcn": 1}

N_JOBS = 3

# The gauntlet runs on the iteration clock: event times are fractions of
# the run, and the per-event bound only means the same thing at every
# scale if each window spans the same number of iterations.  Iterations
# scale with common.WORK_SCALE, so the run does too: 4.5 s at the 0.25x
# workload (each window spans ~4-8 iterations), 18 s at full.
SIM_TIME = 18.0 * common.WORK_SCALE

# Double the bottleneck: three gpt2 comm phases cannot slot into 50 Gbps;
# at 100 Gbps the sum duty is ~0.75 and every post-event window has slack
# to re-lock in bounded iterations.  The degraded-optic flap (to ~0.9x)
# is the saturated-contention window.
CAP_GBPS = 100.0

# 8 boundary rows (t=0 baseline, arrival, blackhole open/close, departure,
# re-arrival, flap open/close): one spec, one group per (algo, variant)
# across all schedules.
SPEC = netsim.FaultSpec(n_events=8, churn=True, link_flaps=True,
                        blackholes=True)

SCHEDULES = ("gauntlet", "staggered")


def _job_flows(cfg: netsim.SimConfig, job: int) -> list[int]:
    return [int(f) for f in
            np.nonzero(np.asarray(cfg.topo.flow_to_job) == job)[0]]


def _events(cfg: netsim.SimConfig, label: str) -> list:
    """The labeled gauntlet on ``cfg``'s fabric, timed as fractions of the
    run so smoke and full scale exercise the same shape.

    The churned job is absent at t=0 (a departure folded into row 0), so
    the steady fabric is 2 resident jobs; the third arrives, one resident
    socket is blackholed, the churned job departs, re-arrives, and a
    degraded-optic flap hits the second 3-job episode.  Every perturbation
    lands while the fabric is contended, and every held window is bounded
    by the next event."""
    T = cfg.sim_time
    if label == "gauntlet":
        churn_job, bh_job = 2, 0
        arr, dep, rearr = 0.08 * T, 0.30 * T, 0.38 * T
        bh = (0.18 * T, 0.22 * T)
        flap = (0.50 * T, 0.64 * T, 0.88)
    elif label == "staggered":
        churn_job, bh_job = 1, 2
        arr, dep, rearr = 0.10 * T, 0.32 * T, 0.40 * T
        bh = (0.20 * T, 0.24 * T)
        flap = (0.52 * T, 0.66 * T, 0.9)
    else:
        raise ValueError(f"unknown schedule label {label!r}")
    return [
        netsim.job_departs(0.0, churn_job),
        netsim.job_arrives(arr, churn_job),
        netsim.job_departs(dep, churn_job),
        netsim.job_arrives(rearr, churn_job),
        netsim.link_flap(flap[0], flap[1], 0, flap[2]),
        # null-route ONE socket of a resident job while the 3-job episode
        # is live: the loss-signal + retransmit path, with headroom to
        # re-lock
        netsim.blackhole(bh[0], bh[1], _job_flows(cfg, bh_job)[:1]),
    ]


def _window_names(cfg: netsim.SimConfig, label: str) -> dict[int, str]:
    """start tick -> semantic window name, for per-event-type asserts."""
    _, arr, dep, rearr, flap, bh = _events(cfg, label)

    def to_tick(t):
        return max(0, int(round(t / cfg.dt)))
    return {
        0: "cold-start",
        to_tick(arr.t): "arrival",
        to_tick(dep.t): "departure",
        to_tick(rearr.t): "re-arrival",
        to_tick(flap.t): "flap",
        to_tick(flap.t_end): "flap-clear",
        to_tick(bh.t): "blackhole-active",
        to_tick(bh.t_end): "blackhole-clear",
    }


def make_schedule(cfg: netsim.SimConfig, label: str) -> netsim.FaultSchedule:
    return netsim.fault_schedule(cfg, _events(cfg, label), spec=SPEC)


def _telemetry_spec(sim_time: float) -> netsim.TelemetrySpec:
    n_ticks = int(round(sim_time / common.DT))
    return netsim.TelemetrySpec(
        probes=("interleave_overlap", "job_iter"),
        detectors=("interleave", "iter_sketch", "reinterleave"),
        # the 3-way interleaved band oscillates at 0.2-0.55 pairwise
        # overlap with brush-ups to ~0.75; synchronized baselines sit near
        # 1.0: 0.8 lies between the two regimes
        overlap_threshold=0.8,
        stride=max(1, n_ticks // 1000))


def telemetry_spec() -> netsim.TelemetrySpec:
    """The overlap machinery plus the per-event re-interleave detector
    (needs ``cfg.faults``), at the timeline suite's ~1000 samples a run."""
    return _telemetry_spec(SIM_TIME)


def make_plan(algos=("reno", "cubic", "dcqcn")) -> netsim.Plan:
    """algo x {OFF, WI} x schedule x seed.  The schedule axis targets
    ``field="*"``: each label resolves, per point config (blackhole tables
    are [E, n_flows] and n_flows follows the socket count), to the whole
    `FaultSchedule.overrides()` dict, so schedules ride the sweep and the
    grid stays at one group per (algo, variant).  The reference's
    ``use_pallas_kernel=True`` has no counterpart: on the card every group
    takes the armed chunk kernel."""
    profs = common.gpt2(N_JOBS)

    def build(pt):
        topo = netsim.dumbbell(N_JOBS, sockets_per_job=SOCKETS[pt["algo"]],
                               cap_gbps=CAP_GBPS)
        return common.build_cfg(
            topo, profs, common.protocol(pt["algo"], pt["variant"]),
            sim_time=SIM_TIME, faults=SPEC, telemetry=telemetry_spec())

    return common.plan(
        build, name="churn-gauntlet",
        algo=tuple(algos), variant=("OFF", "WI"),
        schedule=netsim.Axis(
            "schedule", SCHEDULES, field="*",
            resolve=lambda label: (
                lambda cfg: make_schedule(cfg, label).overrides())),
        seed=common.seed_axis())


def _event_rows(res: netsim.SimResult, label: str) -> list[dict]:
    """Per-event report rows with semantic names (pad rows in the event
    table duplicate the last boundary, so names match on start tick)."""
    names = _window_names(res.cfg, label)
    rows = []
    for rep in res.telemetry.fault_events:
        rows.append({
            "window": names.get(rep.start_tick,
                                f"tick{rep.start_tick}"),
            "start_t": rep.start_t,
            "disrupted": rep.disrupted,
            "reconverged": rep.reconverged,
            "reinterleave_iters": (
                rep.reinterleave_iters
                if np.isfinite(rep.reinterleave_iters) else None),
        })
    return rows


# windows exempt from the MLTCP re-convergence bound: while flows are
# null-routed their job cannot interleave (the claim is that MLTCP
# re-interleaves once the hole closes), and the row-0 window is the t=0
# baseline, not a fault (cold-start convergence is the convergence
# suite's claim)
_EXEMPT = ("blackhole-active", "cold-start")

# every fault type must appear among the held (non-exempt) windows
_REQUIRED = ("departure", "arrival", "re-arrival", "flap", "flap-clear",
             "blackhole-clear")

# The baseline contrast is distributional: at partial contention an
# unmodified baseline oscillates into and out of synchronized episodes, so
# a single window can read as re-converged; what never happens is the
# episodes dying out (every baseline run has a window it never
# re-converges from), and the TCP baselines' stability sits below MLTCP's.
# DCQCN is exempt from the stability margin only: its ECN marks slowly
# de-phase single-QP flows regardless of MLTCP.
_ML_MIN_STABILITY = 0.95
_BASE_STABILITY_MARGIN = {"reno": 0.02, "cubic": 0.02, "dcqcn": 0.0}


def _worst(rows_per_run: list[list[dict]]) -> dict[str, float]:
    """Window name -> the worst re-interleave iterations over the runs'
    event rows (`_event_rows`; inf where a run never re-converged)."""
    worst: dict[str, float] = {}
    for rows in rows_per_run:
        for row in rows:
            it = (row["reinterleave_iters"]
                  if row["reinterleave_iters"] is not None else float("inf"))
            worst[row["window"]] = max(worst.get(row["window"], 0.0), it)
    return worst


def _failures(algo: str, label: str, worst: dict, ml_stability: float,
              baseline_stability: float, baseline_reconverged: bool
              ) -> list[dict]:
    """The suite's claim on one (algo, schedule), failed assertion by
    assertion in the order the suite asserts them (empty when it holds):
    each a dict of ``kind``, the ``windows`` for the first two kinds, and
    the assertion's message ``msg``.  ``worst`` is `_worst` over the
    MLTCP runs, ``ml_stability`` their least stability,
    ``baseline_stability`` the baseline runs' greatest, and
    ``baseline_reconverged`` whether a baseline run re-converged after
    every fault window."""
    held = {k: v for k, v in worst.items() if k not in _EXEMPT}
    failed = []
    missing = [w for w in _REQUIRED if w not in held]
    if missing:
        failed.append(dict(kind="missing", windows=missing,
                           msg=f"{algo}/{label}: fault windows never "
                               f"observed: {missing}"))
    bad = {k: v for k, v in held.items() if v > MAX_REINTERLEAVE_ITERS}
    if bad:
        failed.append(dict(kind="reinterleave", windows=sorted(bad),
                           msg=f"{algo}/{label}: MLTCP re-interleave "
                               f"exceeded {MAX_REINTERLEAVE_ITERS} iters: "
                               f"{bad}"))
    if not ml_stability >= _ML_MIN_STABILITY:
        failed.append(dict(kind="ml_stability",
                           msg=f"{algo}/{label}: MLTCP interleave stability "
                               f"{ml_stability:.3f} < {_ML_MIN_STABILITY}"))
    if baseline_reconverged:
        failed.append(dict(kind="baseline_reconverged",
                           msg=f"{algo}/{label}: unmodified baseline "
                               f"re-converged after faults"))
    margin = _BASE_STABILITY_MARGIN[algo]
    if not baseline_stability <= ml_stability - margin:
        failed.append(dict(kind="margin",
                           msg=f"{algo}/{label}: baseline interleave "
                               f"stability {baseline_stability:.3f} not "
                               f"below MLTCP's {ml_stability:.3f} by "
                               f"{margin}"))
    return failed


def _summarize(algo: str, label: str, base: list[netsim.SimResult],
               ml: list[netsim.SimResult]) -> dict:
    ml_rows = [_event_rows(r, label) for r in ml]
    base_rows = [_event_rows(r, label) for r in base]
    worst = _worst(ml_rows)
    out = {
        "algo": algo, "schedule": label,
        "worst_reinterleave_iters": {
            k: (v if np.isfinite(v) else None) for k, v in worst.items()},
        "events": ml_rows[0],
        "baseline_events": base_rows[0],
        "ml_stability": float(min(
            r.telemetry.interleave_stability for r in ml)),
        "baseline_stability": float(max(
            r.telemetry.interleave_stability for r in base)),
        "baseline_reconverged_frac": float(np.mean(
            [row["reconverged"] for rows in base_rows for row in rows])),
    }
    # the robustness claim, enforced per fault event: MLTCP re-interleaves
    # within a few training iterations after every boundary (worst case
    # over seeds) and stays interleaved between them; the baseline never
    # shakes off its synchronized episodes
    failed = _failures(
        algo, label, worst, out["ml_stability"], out["baseline_stability"],
        any(r.telemetry.all_events_reconverged for r in base))
    if failed:
        raise AssertionError(failed[0]["msg"])
    return out


def run(algos=("reno", "cubic", "dcqcn"), device=None) -> tuple[dict, int]:
    pr = common.run_plan(make_plan(algos), device=device)
    out: dict = {}
    for algo in algos:
        for label in SCHEDULES:
            out[f"{algo}/{label}"] = _summarize(
                algo, label,
                pr.select(algo=algo, variant="OFF", schedule=label),
                pr.select(algo=algo, variant="WI", schedule=label))
    worst = max(v for s in out.values()
                for v in s["worst_reinterleave_iters"].values()
                if v is not None)
    out["_worst_reinterleave_iters"] = worst
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    res, _ = run()
    print(json.dumps(res, indent=1))
