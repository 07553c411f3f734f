#!/usr/bin/env python3
"""The JAX reference's numbers for the plans `chip_smoke.py` runs on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_plans.py \
        [--out results/reference_plans.json]

It runs the reference package's own figure plans, built by its suites
(`benchmarks.speedup_vs_jobs._plan` for fig 10 with Reno and DCQCN,
`benchmarks.stragglers.make_plan` for fig 12), at the suites'
``REPRO_SMOKE`` depth (1.5 s of simulated time) with seeds 1, 2 and 3
through the reference's `netsim.run_plan` on the CPU, and writes each
cell's avg and p99 speedup per seed.  `chip_smoke.py`'s ``plans`` phase
holds the port's seed-1 numbers to the seed-1 numbers here; the spread
across the three seeds is what sets its tolerance (the runs diverge
chaotically, so another framework's run is, in effect, another seed).

The reference fails to import under jax 0.9 at ``core/iteration.py:46``;
the script imports it through the port's test helper
(`tests/_torch_reference.py`), which works around that line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (1, 2, 3)
FIG10_JOBS = (2, 3, 4, 5, 6)
FIG12_PROBS = (0.0, 0.05, 0.10, 0.20, 0.30)


def speedups(netsim, bases, tests) -> dict:
    per = [netsim.speedup_stats(b, t) for b, t in zip(bases, tests)]
    return {"avg_speedup": [p["avg_speedup"] for p in per],
            "p99_speedup": [p["p99_speedup"] for p in per]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "reference_plans.json"))
    args = ap.parse_args(argv)
    os.environ["REPRO_SMOKE"] = "1"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tests")]
    from _torch_reference import reference_modules

    out = {"source": "scripts/reference_plans.py: the JAX reference's "
                     "run_plan on the CPU, REPRO_SMOKE depth",
           "seeds": list(SEEDS), "plans": {}}
    with reference_modules():
        import jax

        from benchmarks import common, speedup_vs_jobs, stragglers
        from repro import netsim

        common.SEEDS = SEEDS
        out.update(jax_version=jax.__version__, sim_time=common.SIM_TIME,
                   work_scale=common.WORK_SCALE)
        for algo in ("reno", "dcqcn"):
            t0 = time.time()
            pr = netsim.run_plan(speedup_vs_jobs._plan(algo, FIG10_JOBS))
            cells = {str(n): speedups(netsim,
                                      pr.select(variant="OFF", n_jobs=n),
                                      pr.select(variant="WI", n_jobs=n))
                     for n in FIG10_JOBS}
            out["plans"][f"fig10-{algo}"] = dict(
                n_compile_groups=pr.n_compile_groups,
                seconds=time.time() - t0, cells=cells)
            print(f"fig10-{algo}", json.dumps(cells), flush=True)
        t0 = time.time()
        pr = netsim.run_plan(stragglers.make_plan(FIG12_PROBS))
        cells = {}
        for p in FIG12_PROBS:
            base = pr.select(p=p, scheme="base")
            for scheme in ("mlqcn", "cassini"):
                cells[f"{scheme}@{p}"] = speedups(
                    netsim, base, pr.select(p=p, scheme=scheme))
        out["plans"]["fig12"] = dict(n_compile_groups=pr.n_compile_groups,
                                     seconds=time.time() - t0, cells=cells)
        print("fig12", json.dumps(cells), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
