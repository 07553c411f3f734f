"""Visualize MLTCP's convergence from real probe data: per-job comm
phases, per-flow cwnd and the interleave detector's overlap signal as
ASCII timelines (the paper's Figures 5 / 7a), before and after enabling
MLTCP, captured by the probe subsystem (`netsim.telemetry`) instead of the
chunk-averaged trace channels.

The port of ``examples/interleave_demo.py``.  On the card both schemes
run through the armed chunk kernel (Reno OFF and WI with the probes and
detectors armed), one launch a chunk; ``--device cpu`` runs the plain
per-tick path.  ``--sim-time`` cuts the run (the probes keep ~600
samples).

    PYTHONPATH=src python -m repro_torch.examples.interleave_demo
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import netsim, workload
from repro_torch.core import Algo, CCParams, MLTCPConfig, Variant

DT = 2e-5
SIM_TIME = 3.0
SAMPLES = 600


def telemetry_spec(sim_time: float = SIM_TIME) -> netsim.TelemetrySpec:
    """The Fig. 5 probes and both detectors; ~SAMPLES samples across the
    run."""
    return netsim.TelemetrySpec(
        probes=("flow_cwnd", "job_incomm", "interleave_overlap"),
        stride=int(round(sim_time / DT)) // SAMPLES)


def make_plan(sim_time: float = SIM_TIME) -> netsim.Plan:
    """The scheme axis (default Reno against MLTCP-Reno WI): two GPT-2 jobs
    at a quarter of their work on dumbbell(2, 2)."""
    topo = netsim.dumbbell(2, sockets_per_job=2)
    prof = workload.profile_for("gpt2").scaled(0.25)
    jobs = workload.jobspec_from_profiles([prof, prof])

    def build(pt):
        variant = Variant.WI if pt["scheme"] == "mltcp" else Variant.OFF
        proto = MLTCPConfig(cc=CCParams(algo=int(Algo.RENO),
                                        variant=int(variant), tick_dt=DT,
                                        rtt=100e-6),
                            slope=1.75, intercept=0.25)
        return netsim.SimConfig(topo=topo, jobs=jobs, protocol=proto,
                                sim_time=sim_time, dt=DT, seed=1)

    return netsim.Plan(name="interleave-demo",
                       axes=(netsim.Axis("scheme", ("default", "mltcp")),),
                       build=build)


def _cols(series: np.ndarray, width: int = 120) -> np.ndarray:
    """Average a [S, ...] probe series down to `width` display columns."""
    s = series.shape[0] // width * width
    return series[:s].reshape(width, -1, *series.shape[1:]).mean(axis=1)


def shade(u: float) -> str:
    return " .:-=+*#%@"[min(int(u * 9.99), 9)]


def comm_phases(res, title, sim_time: float, width=120):
    ic = _cols(res.telemetry.series["job_incomm"], width)
    print(f"\n{title}  (comm-phase probe; each column ~"
          f"{sim_time / width * 1e3:.0f} ms)")
    for j in range(ic.shape[1]):
        print(f"  job{j} |{''.join(shade(u) for u in ic[:, j])}|")
    ov = _cols(res.telemetry.series["interleave_overlap"], width)
    print(f"  ovlp |{''.join(shade(u) for u in ov)}|")


def cwnd_timeline(res, title, width=120):
    cw = _cols(res.telemetry.series["flow_cwnd"], width)
    cw = cw / max(cw.max(), 1e-9)
    print(f"\n{title}  (per-flow cwnd probe, normalized)")
    for n in range(cw.shape[1]):
        print(f"  flow{n}|{''.join(shade(u) for u in cw[:, n])}|")


def main(argv=None) -> dict:
    """Run the plan with telemetry armed, print the timelines and the
    detectors' numbers; returns those numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sim-time", type=float, default=SIM_TIME,
                    help="simulated seconds (default %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    # the scheme axis is static (the CC variant differs), so run_plan runs
    # two groups and labels both results; telemetry= arms the probes on
    # every point
    result = netsim.run_plan(make_plan(args.sim_time),
                             telemetry=telemetry_spec(args.sim_time),
                             device=args.device)
    (base,), (ml,) = (result.select(scheme="default"),
                      result.select(scheme="mltcp"))
    comm_phases(base, "default Reno — comm phases collide", args.sim_time)
    comm_phases(ml, "MLTCP-Reno — comm phases interleave", args.sim_time)
    cwnd_timeline(ml, "MLTCP-Reno")

    out = dict(
        tti_s=netsim.time_to_interleave(ml),
        tti_iters=netsim.convergence_iteration(ml),
        default_converged=bool(base.telemetry.converged),
        stability=(base.telemetry.interleave_stability,
                   ml.telemetry.interleave_stability),
        avg_iter_s=(base.avg_iter(0), ml.avg_iter(0)),
        p99_sketch_s=(netsim.iter_time_quantile(base, 0.99),
                      netsim.iter_time_quantile(ml, 0.99)),
        n_compile_groups=result.n_compile_groups,
        n_kernel_launches=result.n_kernel_launches,
        n_kernel_fallbacks=result.n_kernel_fallbacks)
    print(f"\ntime-to-interleave: MLTCP converges after "
          f"{out['tti_s'] * 1e3:.0f} ms "
          f"({out['tti_iters']:.0f} training iterations); "
          f"default Reno: {'yes' if out['default_converged'] else 'never'}")
    print(f"interleave stability (tail): "
          f"{out['stability'][0]:.2f} -> "
          f"{out['stability'][1]:.2f} (1 = stays interleaved)")
    print(f"avg iteration: {out['avg_iter_s'][0] * 1e3:.1f} ms -> "
          f"{out['avg_iter_s'][1] * 1e3:.1f} ms; streaming p99 sketch: "
          f"{out['p99_sketch_s'][0] * 1e3:.1f} ms -> "
          f"{out['p99_sketch_s'][1] * 1e3:.1f} ms")
    return out


if __name__ == "__main__":
    main()
