"""Figure 14 — circular dependency across jobs and links
(``benchmarks/circular.py``; the paper's Figure 2 topology).

Three GPT-2 jobs on the triangle: each competes with a different job on
each of its two links; the affinity graph has a loop, so Cassini has no
feasible schedule and Static no consistent unfairness.  MLQCN converges
anyway (the favoritism signal is per-flow local).

One plan: scheme x seed.  The Cassini schedule rides the sweep's Cassini
leaves (period <= 0 = off), so base and cassini share the OFF group.
"""
from __future__ import annotations

import numpy as np

from repro_torch import netsim, workload
from repro_torch.figures import common


def _schedule():
    """(fabric, profiles, Cassini schedule, whether it is feasible)."""
    topo = netsim.triangle(sockets_per_job=2)
    profs = common.gpt2(3)
    sched, feasible = workload.cassini_schedule(
        topo, [p.scaled(common.WORK_SCALE) for p in profs])
    return topo, profs, sched, feasible


def make_plan() -> netsim.Plan:
    """The fig 14 grid as a plan, buildable without running."""
    topo, profs, sched, _ = _schedule()

    def build(pt):
        variant = "WI" if pt["scheme"] == "mlqcn" else "OFF"
        return common.build_cfg(
            topo, profs, common.protocol("dcqcn", variant),
            cassini=sched if pt["scheme"] == "cassini" else None)

    return common.plan(build, name="fig14",
                       scheme=("base", "mlqcn", "cassini"),
                       seed=common.seed_axis())


def run(device=None) -> tuple[dict, int]:
    feasible = _schedule()[3]
    pr = common.run_plan(make_plan(), device=device)
    base = pr.select(scheme="base")
    ml = pr.select(scheme="mlqcn")
    sp = netsim.sweep_speedup_stats(base, ml)
    sp_cas = netsim.sweep_speedup_stats(base, pr.select(scheme="cassini"))
    out = {
        "cassini_has_schedule": feasible,       # False: loop detected
        "base_interleave": round(float(np.mean(
            [netsim.mean_pairwise_interleave(r) for r in base])), 3),
        "mlqcn_interleave": round(float(np.mean(
            [netsim.mean_pairwise_interleave(r) for r in ml])), 3),
        "mlqcn_avg_speedup": round(sp["avg_speedup"], 3),
        "mlqcn_avg_speedup_std": round(sp["avg_speedup_std"], 3),
        "mlqcn_p99_speedup": round(sp["p99_speedup"], 3),
        "cassini_avg_speedup": round(sp_cas["avg_speedup"], 3),
        "mean_link_util_mlqcn": round(float(np.mean(
            [np.mean(r.trace_util) for r in ml])), 3),
    }
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    print(json.dumps(run()[0], indent=1))
