"""Figure 10 — training-iteration speedup as the competing-job count grows
(``benchmarks/speedup_vs_jobs.py``).

The paper: MLTCP-Reno plateaus ~1.3x avg / 1.5x p99; MLQCN reaches 2x / 4x
as DCQCN's congestion collapse worsens with more jobs.

One plan per algorithm: variant x job count x seed.  The job-count axis is
padded: every count runs on the largest dumbbell with the trailing jobs
masked off (`SweepParams.job_active`), so the grid runs as two groups (one
per variant).
"""
from __future__ import annotations

from repro_torch import netsim
from repro_torch.figures import common

JOB_COUNTS = (2, 3, 4, 5, 6)


def _plan(algo: str, job_counts) -> netsim.Plan:
    def build(pt):
        n = pt["n_jobs"]
        return common.build_cfg(netsim.dumbbell(n, sockets_per_job=2),
                                common.gpt2(n),
                                common.protocol(algo, pt["variant"]))
    return common.plan(build, name=f"fig10-{algo}",
                       variant=("OFF", "WI"),
                       n_jobs=tuple(job_counts),
                       seed=common.seed_axis())


def run(algos=("reno", "dcqcn"), job_counts=JOB_COUNTS,
        device=None) -> tuple[dict, int]:
    out = {}
    n_ticks = 0
    for algo in algos:
        pr = common.run_plan(_plan(algo, job_counts), device=device)
        if pr.n_compile_groups != 2:
            raise AssertionError(pr.n_compile_groups)
        for n in job_counts:
            sp = netsim.sweep_speedup_stats(
                pr.select(variant="OFF", n_jobs=n),
                pr.select(variant="WI", n_jobs=n))
            out[f"{algo}_{n}jobs"] = {
                "avg_speedup": round(sp["avg_speedup"], 3),
                "p99_speedup": round(sp["p99_speedup"], 3),
                "avg_speedup_std": round(sp["avg_speedup_std"], 3),
            }
        n_ticks += pr.n_ticks
    return out, n_ticks


if __name__ == "__main__":
    import json
    print(json.dumps(run()[0], indent=1))
