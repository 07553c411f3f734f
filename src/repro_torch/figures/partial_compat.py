"""Figure 13 — partially compatible jobs: MLQCN against Static [67]
(``benchmarks/partial_compat.py``).

Compatibility is swept by the jobs' compute:comm ratio (the paper varies
the batch size).  Static = fixed unfair per-job factors; MLQCN adapts.  The
paper: below compatibility ~0.7 Static's p99 drops under 1.0 while MLQCN
stays >= 1.

One plan: compute scale x scheme x seed.  The compute scale changes only
workload values (sweep leaves) and the Static factors ride the WI group
through the adaptive sentinel (a factor < 0 keeps F), so the grid is two
groups: base (OFF) and {mlqcn, static} (WI).
"""
from __future__ import annotations

import numpy as np

from repro_torch import netsim, workload
from repro_torch.figures import common

STATIC_FACTORS = np.asarray([1.3, 1.0, 0.7])


def _profs_for(cs):
    base_prof = workload.profile_for("gpt2")
    return [base_prof.compute_scaled(cs) for _ in range(3)]


def make_plan(compute_scales=(1.5, 1.0, 0.7, 0.45, 0.25)) -> netsim.Plan:
    """The fig 13 grid as a plan, buildable without running (lintable via
    ``python -m repro_torch.analysis --plan fig13``)."""
    topo = netsim.dumbbell(3, sockets_per_job=2)

    def build(pt):
        # Static [67]: constant per-job factors replace F; needs a non-OFF
        # variant so the factors reach the increase hook
        variant = "OFF" if pt["scheme"] == "base" else "WI"
        return common.build_cfg(
            topo, _profs_for(pt["cs"]), common.protocol("dcqcn", variant),
            static_job_factors=(STATIC_FACTORS if pt["scheme"] == "static"
                                else None))

    return common.plan(
        build, name="fig13",
        cs=tuple(compute_scales), scheme=("base", "mlqcn", "static"),
        seed=common.seed_axis())


def run(compute_scales=(1.5, 1.0, 0.7, 0.45, 0.25), device=None
        ) -> tuple[dict, int]:
    pr = common.run_plan(make_plan(compute_scales), device=device)
    if not pr.n_compile_groups <= 2:
        raise AssertionError(pr.n_compile_groups)
    if pr.n_kernel_fallbacks != 0:
        raise AssertionError()
    out = {}
    for cs in compute_scales:
        compat = workload.compatibility_score(
            _profs_for(cs)[0].scaled(common.WORK_SCALE),
            _profs_for(cs)[1].scaled(common.WORK_SCALE))
        base = pr.select(cs=cs, scheme="base")
        sp_ml = netsim.sweep_speedup_stats(base,
                                           pr.select(cs=cs, scheme="mlqcn"))
        sp_st = netsim.sweep_speedup_stats(base,
                                           pr.select(cs=cs, scheme="static"))
        out[f"compat={compat:.2f}"] = {
            "mlqcn_avg": round(sp_ml["avg_speedup"], 3),
            "mlqcn_p99": round(sp_ml["p99_speedup"], 3),
            "static_avg": round(sp_st["avg_speedup"], 3),
            "static_p99": round(sp_st["p99_speedup"], 3),
        }
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    print(json.dumps(run()[0], indent=1))
