"""Figure 12 — robustness to stragglers (``benchmarks/stragglers.py``).

Two GPT-2 jobs with per-iteration straggle probability p (sleep 5-10% of
the isolation time).  MLQCN and Cassini, both over default DCQCN.  The
paper: MLQCN's speedup is flat in p; Cassini's tail collapses beyond
p ~ 10%.

One plan: p x scheme x seed.  The straggle probability is a sweep field
and the Cassini schedule rides the sweep's Cassini leaves, so the grid is
two groups: {base, cassini} x all p (OFF) and mlqcn x all p (WI).
"""
from __future__ import annotations

from repro_torch import netsim, workload
from repro_torch.figures import common


def make_plan(probs=(0.0, 0.05, 0.10, 0.20, 0.30)) -> netsim.Plan:
    """The fig 12 grid as a plan, buildable without running (the static
    verifier lints exactly this object: ``python -m repro_torch.analysis
    --plan fig12``)."""
    topo = netsim.dumbbell(2, sockets_per_job=2)
    profs = common.gpt2(2)
    sched, _ = workload.cassini_schedule(
        topo, [pr.scaled(common.WORK_SCALE) for pr in profs])

    def build(pt):
        variant = "WI" if pt["scheme"] == "mlqcn" else "OFF"
        return common.build_cfg(
            topo, profs, common.protocol("dcqcn", variant),
            cassini=sched if pt["scheme"] == "cassini" else None)

    return common.plan(
        build, name="fig12",
        p=netsim.Axis("p", tuple(probs), field="straggle_prob"),
        scheme=("base", "mlqcn", "cassini"),
        seed=common.seed_axis())


def run(probs=(0.0, 0.05, 0.10, 0.20, 0.30), device=None
        ) -> tuple[dict, int]:
    pr = common.run_plan(make_plan(probs), device=device)
    if not pr.n_compile_groups <= 2:
        raise AssertionError(pr.n_compile_groups)
    if pr.n_kernel_fallbacks != 0:
        raise AssertionError()
    out = {}
    for p in probs:
        base = pr.select(p=p, scheme="base")
        sp_ml = netsim.sweep_speedup_stats(base, pr.select(p=p, scheme="mlqcn"))
        sp_cas = netsim.sweep_speedup_stats(base,
                                            pr.select(p=p, scheme="cassini"))
        out[f"p={p}"] = {
            "mlqcn_avg": round(sp_ml["avg_speedup"], 3),
            "mlqcn_p99": round(sp_ml["p99_speedup"], 3),
            "cassini_avg": round(sp_cas["avg_speedup"], 3),
            "cassini_p99": round(sp_cas["p99_speedup"], 3),
        }
    return out, pr.n_ticks


if __name__ == "__main__":
    import json
    print(json.dumps(run()[0], indent=1))
