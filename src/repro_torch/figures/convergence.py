"""Figures 7, 8, 9 — convergence (``benchmarks/convergence.py``).

Two GPT-2 data-parallel jobs share the dumbbell; default Reno / CUBIC /
DCQCN against their MLTCP variants on interleave convergence (iterations
until the comm phases separate), drop / ECN-mark rate, and avg / p99
training-iteration times.  One plan: algo x variant x seed; each (algo,
variant) scheme is its own group, the seeds ride each group's sweep.
"""
from __future__ import annotations

import numpy as np

from repro_torch import netsim
from repro_torch.figures import common


def _converged_iteration(res: netsim.SimResult) -> float:
    """First iteration index after which per-iteration times stay within 10%
    of the tail median (the paper's 'stabilizes after ~N iterations')."""
    xs = res.iter_times[0]
    if xs.size < 10:
        return float("nan")
    tail = np.median(xs[len(xs) // 2:])
    ok = np.abs(xs - tail) <= 0.1 * tail
    for i in range(len(ok)):
        if ok[i:].all():
            return float(i)
    return float(len(ok))


def _ratio(nums, dens) -> float:
    nums, dens = float(np.mean(nums)), float(np.mean(dens))
    return nums / dens if dens > 0 else float("inf")


def _summarize(algo: str, base: list[netsim.SimResult],
               ml: list[netsim.SimResult]) -> dict:
    sp = netsim.sweep_speedup_stats(base, ml)
    return {
        "algo": algo,
        "baseline_interleave": float(np.mean(
            [netsim.mean_pairwise_interleave(r) for r in base])),
        "mltcp_interleave": float(np.mean(
            [netsim.mean_pairwise_interleave(r) for r in ml])),
        "converged_at_iter": float(np.nanmean(
            [_converged_iteration(r) for r in ml])),
        "drop_reduction": _ratio([r.drops_per_s for r in base],
                                 [r.drops_per_s for r in ml]),
        "mark_reduction": _ratio([r.marks_per_s for r in base],
                                 [r.marks_per_s for r in ml]),
        "avg_speedup": sp["avg_speedup"],
        "avg_speedup_std": sp["avg_speedup_std"],
        "p99_speedup": sp["p99_speedup"],
    }


def make_plan(algos=("reno", "cubic", "dcqcn"), sockets: int = 2
              ) -> netsim.Plan:
    """The fig 7-9 grid as a plan, buildable without running."""
    topo = netsim.dumbbell(2, sockets_per_job=sockets)
    profs = common.gpt2(2)
    return common.plan(
        lambda pt: common.build_cfg(topo, profs,
                                    common.protocol(pt["algo"], pt["variant"])),
        name="fig7-9",
        algo=tuple(algos), variant=("OFF", "WI"), seed=common.seed_axis())


def run(algos=("reno", "cubic", "dcqcn"), sockets: int = 2,
        device=None) -> tuple[dict, int]:
    pr = common.run_plan(make_plan(algos, sockets), device=device)
    out = {algo: _summarize(algo,
                            pr.select(algo=algo, variant="OFF"),
                            pr.select(algo=algo, variant="WI"))
           for algo in algos}
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    res, _ = run()
    print(json.dumps(res, indent=1))
