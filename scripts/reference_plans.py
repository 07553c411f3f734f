#!/usr/bin/env python3
"""The JAX reference's numbers for the plans `chip_smoke.py` runs on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_plans.py \
        [--out results/reference_plans.json]

It runs the reference package's own figure plans, built by its suites
(`benchmarks.speedup_vs_jobs._plan` for fig 10 with Reno and DCQCN,
`benchmarks.stragglers.make_plan` for fig 12, `benchmarks.timeline
.make_plan` with its `telemetry_spec` for fig 5, `benchmarks.churn
.make_plan` for the fault gauntlet), at the suites' ``REPRO_SMOKE`` depth
(1.5 s of simulated time; the gauntlet's own 4.5 s) with seeds 1, 2 and 3
through the reference's `netsim.run_plan` on the CPU, and writes each
cell's numbers per seed: avg and p99 speedup for fig 10 and 12; the
interleave detector's time to interleave (iterations and seconds),
stability and the sketch's p50 / p99 iteration time for fig 5; the
re-interleave detector's per-event reports and the stability for the
gauntlet, with the suite's own assertions' verdict.  `chip_smoke.py`'s
``plans``, ``telemetry`` and ``faults`` phases hold the port's numbers to
the same seeds here; the spread across the three seeds is what sets their
tolerance (the runs diverge chaotically, so another framework's run is,
in effect, another seed).

``--only NAME ...`` reruns some plans and keeps the others' entries.

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
PLANS = ("fig10-reno", "fig10-dcqcn", "fig12", "fig5", "churn")
TIMELINE_METRICS = ("tti_iters", "tti_seconds", "converged",
                    "interleave_stability", "p50_iter_s", "p99_iter_s")
CHURN_METRICS = ("interleave_stability", "all_events_reconverged",
                 "max_reinterleave_iters", "events")


def speedups(netsim, bases, tests) -> dict:
    per = [netsim.speedup_stats(b, t) for b, t in zip(bases, tests)]
    return {"avg_speedup": [p["avg_speedup"] for p in per],
            "p99_speedup": [p["p99_speedup"] for p in per]}


def finite(x):
    """A float for JSON: None for inf or nan (the detectors' "never")."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else None


def timeline_cells(netsim, pr) -> dict:
    """fig 5: per (algo, variant) cell, each seed's detector outputs."""
    cells = {}
    for r in pr:
        tl = r.telemetry
        cell = cells.setdefault(f"{r.point['algo']}/{r.point['variant']}",
                                {k: [] for k in TIMELINE_METRICS})
        cell["tti_iters"].append(finite(netsim.convergence_iteration(r)))
        cell["tti_seconds"].append(finite(netsim.time_to_interleave(r)))
        cell["converged"].append(bool(tl.converged))
        cell["interleave_stability"].append(finite(tl.interleave_stability))
        cell["p50_iter_s"].append(finite(netsim.iter_time_quantile(r, 0.5)))
        cell["p99_iter_s"].append(finite(netsim.iter_time_quantile(r, 0.99)))
    return cells


def churn_cells(netsim, pr) -> dict:
    """The gauntlet: per (algo, variant, schedule) cell, each seed's
    per-event reports, stability and worst re-interleave."""
    cells = {}
    for r in pr:
        tl = r.telemetry
        pt = r.point
        cell = cells.setdefault(
            f"{pt['algo']}/{pt['variant']}/{pt['schedule']}",
            {k: [] for k in CHURN_METRICS})
        cell["interleave_stability"].append(finite(tl.interleave_stability))
        cell["all_events_reconverged"].append(
            bool(tl.all_events_reconverged))
        cell["max_reinterleave_iters"].append(
            finite(tl.max_reinterleave_iters))
        cell["events"].append([dict(
            start_tick=e.start_tick, disrupted=bool(e.disrupted),
            reconverged=bool(e.reconverged),
            reinterleave_iters=finite(e.reinterleave_iters))
            for e in tl.fault_events])
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "reference_plans.json"))
    ap.add_argument("--only", nargs="+", choices=PLANS,
                    help="run only these plans, keeping the file's others")
    args = ap.parse_args(argv)
    only = set(args.only or PLANS)
    os.environ["REPRO_SMOKE"] = "1"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tests")]
    from _torch_reference import reference_modules

    out = {"source": "scripts/reference_plans.py: the JAX reference's "
                     "run_plan on the CPU, REPRO_SMOKE depth",
           "seeds": list(SEEDS), "plans": {}}
    if args.only and os.path.exists(args.out):
        with open(args.out) as f:
            out["plans"] = json.load(f)["plans"]
    with reference_modules():
        import jax

        from benchmarks import churn, common, speedup_vs_jobs, stragglers
        from benchmarks import timeline
        from repro import netsim

        common.SEEDS = SEEDS
        out.update(jax_version=jax.__version__, sim_time=common.SIM_TIME,
                   work_scale=common.WORK_SCALE)
        for algo in ("reno", "dcqcn"):
            if f"fig10-{algo}" not in only:
                continue
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
        if "fig12" in only:
            t0 = time.time()
            pr = netsim.run_plan(stragglers.make_plan(FIG12_PROBS))
            cells = {}
            for p in FIG12_PROBS:
                base = pr.select(p=p, scheme="base")
                for scheme in ("mlqcn", "cassini"):
                    cells[f"{scheme}@{p}"] = speedups(
                        netsim, base, pr.select(p=p, scheme=scheme))
            out["plans"]["fig12"] = dict(
                n_compile_groups=pr.n_compile_groups,
                seconds=time.time() - t0, cells=cells)
            print("fig12", json.dumps(cells), flush=True)
        if "fig5" in only:
            t0 = time.time()
            spec = timeline.telemetry_spec()
            pr = netsim.run_plan(timeline.make_plan(), telemetry=spec)
            cells = timeline_cells(netsim, pr)
            out["plans"]["fig5"] = dict(
                n_compile_groups=pr.n_compile_groups,
                seconds=time.time() - t0, stride=spec.stride,
                sim_time=common.SIM_TIME, cells=cells)
            print("fig5", json.dumps(cells), flush=True)
        if "churn" in only:
            t0 = time.time()
            pr = netsim.run_plan(churn.make_plan())
            cells = churn_cells(netsim, pr)
            verdict = {}
            for algo in ("reno", "cubic", "dcqcn"):
                for label in churn.SCHEDULES:
                    try:
                        s = churn._summarize(
                            algo, label,
                            pr.select(algo=algo, variant="OFF",
                                      schedule=label),
                            pr.select(algo=algo, variant="WI",
                                      schedule=label))
                        verdict[f"{algo}/{label}"] = dict(
                            held=True, worst=s["worst_reinterleave_iters"],
                            ml_stability=s["ml_stability"],
                            baseline_stability=s["baseline_stability"])
                    except AssertionError as exc:
                        verdict[f"{algo}/{label}"] = dict(held=False,
                                                          error=str(exc))
            out["plans"]["churn"] = dict(
                n_compile_groups=pr.n_compile_groups,
                seconds=time.time() - t0, sim_time=churn.SIM_TIME,
                stride=churn.telemetry_spec().stride, cells=cells,
                assertions=verdict)
            print("churn", json.dumps(verdict), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
