"""Figures 15, 16, 17 — parameter guidelines (``benchmarks/parameters.py``).

  fig15: aggressiveness functions F1..F4 (increasing) interleave and speed
         up; F5, F6 (decreasing) do not — the SRPT-reinforcement claim;
         F1..F6 run inside the CC kernels (the launch's F id);
  fig16: S x I heatmap of MLTCP-Reno speedups — slope and intercept are
         sweep fields, so the heatmap and its baseline are one plan of two
         groups (OFF, WI);
  fig17: WI and MD variants perform alike (Reno and CUBIC).

Each is one plan; static axes (F family, variant, algorithm) become groups,
dynamic axes (slope, intercept, seed) ride each group's sweep, and
selections by axis label pair the seeds for the error bars.
"""
from __future__ import annotations

import numpy as np

from repro_torch import netsim
from repro_torch.figures import common


def fig15_plan(fns=("F1", "F2", "F3", "F4", "F5", "F6")) -> netsim.Plan:
    """The fig 15 grid as a plan: OFF and WI under each F, x seed."""
    topo = netsim.dumbbell(3, sockets_per_job=2)
    profs = common.gpt2(3)

    def build(pt):
        s = pt["scheme"]
        proto = (common.protocol("reno", "OFF") if s == "OFF"
                 else common.protocol("reno", "WI", f_spec=s))
        return common.build_cfg(topo, profs, proto)

    return common.plan(build, name="fig15",
                       scheme=("OFF",) + tuple(fns), seed=common.seed_axis())


def fig15_agg_functions(fns=("F1", "F2", "F3", "F4", "F5", "F6"),
                        device=None) -> tuple[dict, int]:
    pr = common.run_plan(fig15_plan(fns), device=device)
    base = pr.select(scheme="OFF")
    out = {}
    for f in fns:
        res = pr.select(scheme=f)
        sp = netsim.sweep_speedup_stats(base, res)
        inter = [netsim.mean_pairwise_interleave(r) for r in res]
        out[f] = {
            "avg_speedup": round(sp["avg_speedup"], 3),
            "avg_speedup_std": round(sp["avg_speedup_std"], 3),
            "interleave": round(float(np.mean(inter)), 3),
        }
    return out, pr.n_ticks


def fig16_plan(slopes=(0.5, 1.0, 1.75, 2.5),
               intercepts=(0.1, 0.25, 0.5, 1.0)) -> netsim.Plan:
    """The fig 16 grid as a plan: the WI group's full S x I x seed grid and
    the baseline, which ignores S and I, pruned to the first (S, I)."""
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = common.gpt2(2)
    return common.plan(
        lambda pt: common.build_cfg(topo, profs,
                                    common.protocol("reno", pt["variant"])),
        name="fig16",
        where=lambda pt: pt["variant"] == "WI" or (
            pt["slope"] == slopes[0] and pt["intercept"] == intercepts[0]),
        variant=("OFF", "WI"), slope=tuple(slopes),
        intercept=tuple(intercepts), seed=common.seed_axis())


def fig16_heatmap(slopes=(0.5, 1.0, 1.75, 2.5),
                  intercepts=(0.1, 0.25, 0.5, 1.0),
                  device=None) -> tuple[dict, int]:
    pr = common.run_plan(fig16_plan(slopes, intercepts), device=device)
    if pr.n_compile_groups != 2:
        raise AssertionError(pr.n_compile_groups)
    if pr.n_kernel_fallbacks != 0:
        raise AssertionError()

    base = pr.select(variant="OFF")
    grid = {}
    for s in slopes:
        for i in intercepts:
            # seed-paired: selections share the (fastest) seed axis order
            sp = netsim.sweep_speedup_stats(
                base, pr.select(variant="WI", slope=s, intercept=i))
            grid[f"S={s},I={i}"] = {
                "avg_speedup": round(sp["avg_speedup"], 3),
                "p99_speedup": round(sp["p99_speedup"], 3),
                "avg_speedup_std": round(sp["avg_speedup_std"], 3),
            }
    best = max(grid, key=lambda k: grid[k]["avg_speedup"])
    grid["best"] = {"at": best, **grid[best]}
    return grid, pr.n_ticks


def fig17_plan() -> netsim.Plan:
    """The fig 17 grid as a plan: algo x variant (OFF / WI / MD) x seed."""
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = common.gpt2(2)
    return common.plan(
        lambda pt: common.build_cfg(topo, profs,
                                    common.protocol(pt["algo"], pt["variant"])),
        name="fig17",
        algo=("reno", "cubic"), variant=("OFF", "WI", "MD"),
        seed=common.seed_axis())


def fig17_wi_vs_md(device=None) -> tuple[dict, int]:
    pr = common.run_plan(fig17_plan(), device=device)
    out = {}
    for algo in ("reno", "cubic"):
        base = pr.select(algo=algo, variant="OFF")
        for variant in ("WI", "MD"):
            sp = netsim.sweep_speedup_stats(
                base, pr.select(algo=algo, variant=variant))
            out[f"{algo}-{variant}"] = {
                "avg_speedup": round(sp["avg_speedup"], 3),
                "p99_speedup": round(sp["p99_speedup"], 3),
                "avg_speedup_std": round(sp["avg_speedup_std"], 3),
            }
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    print(json.dumps({"fig15": fig15_agg_functions()[0],
                      "fig16": fig16_heatmap()[0],
                      "fig17": fig17_wi_vs_md()[0]}, indent=1))
