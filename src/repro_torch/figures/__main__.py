"""The paper-figure harness: one entry per paper table or figure
(``benchmarks/run.py`` on the port).

    REPRO_SMOKE=1 PYTHONPATH=src python -m repro_torch.figures

Runs every suite on the card in the reference's order under its names,
prints ``name,us_per_call,derived`` CSV (us_per_call = wall time per
simulated tick across the suite's runs) and merges each suite's derived
metrics and its ``_health`` block into ``results/figures_torch.json`` as
the suite finishes (the other suites' entries from earlier runs stay).

Depth: ``REPRO_SMOKE=1`` 1.5 s and one seed, ``REPRO_FULL=1`` the paper's
scale, else 4 s and two seeds (`common.depth`).  A suite whose own
assertion fails raises after the earlier suites have merged; the JAX
reference's churn suite fails its Reno re-interleave bound, and so does
this one.
"""
from __future__ import annotations

from repro_torch.figures import (
    churn,
    circular,
    common,
    convergence,
    diversity,
    kernel_sweep,
    parameters,
    partial_compat,
    speedup_vs_jobs,
    stragglers,
    timeline,
)

SUITES = (
    ("fig5_timeline", timeline.run),
    ("fig7_9_convergence", convergence.run),
    ("fig10_speedup_vs_jobs", speedup_vs_jobs.run),
    ("fig11_table2_diversity", diversity.run),
    ("fig12_stragglers", stragglers.run),
    ("fig13_partial_compat", partial_compat.run),
    ("fig14_circular_dependency", circular.run),
    ("fig15_agg_functions", parameters.fig15_agg_functions),
    ("fig16_slope_intercept", parameters.fig16_heatmap),
    ("fig17_wi_vs_md", parameters.fig17_wi_vs_md),
    ("kernel_sweep", kernel_sweep.run),
    ("churn_gauntlet", churn.run),
)


def main() -> None:
    done = 0
    for name, fn in SUITES:
        r = common.timed(name, fn)
        # merge as each suite finishes: a crash in a later suite must not
        # discard what the earlier ones spent
        common.merge_results({name: {**r.derived, "_health": r.health}})
        done += 1
        print(r.csv_line(), flush=True)
    print(f"# merged {done} suites into {common.RESULTS_PATH}")


if __name__ == "__main__":
    main()
