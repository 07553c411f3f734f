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

The paper's other figure suites (figs 7-9, 11 / Table 2, 13, 14, 15, 16
and 17) run their own plans as captured from the suites (`captured_plan`
patches ``benchmarks.common.run_plan`` to record the plan the suite hands
it and stop the suite there; nothing in ``benchmarks/`` changes), at the
same depth and seeds; each cell's numbers per seed are the metrics the
suite reports (`figure_cells`), beside the per-seed verdicts of the
paper's claims that ``chip_smoke.py``'s ``figures`` phase checks
(`figure_claims`), the suite's own assertions, and the jobs
that recorded no iteration (`idle_jobs`: Table 2's roberta, alone at
seed 2, records none in 1.5 s).

``--only NAME ...`` reruns some plans and keeps the others' entries.

``--seeds N`` runs the same plans at seeds 1..N instead and writes
``results/reference_seeds.json``: the fig 10 and fig 12
plans' cells and the figure plans' cells and claims (fig 5 and churn stay
at seeds 1-3 in ``reference_plans.json``).  At N = 32 that is the
reference's distribution that ``chip_smoke.py``'s ``plans`` and
``figures`` phases hold the port's 32 seeds to (`distribution_check`):
the runs diverge chaotically, so a seed of one package paired with the
same seed of the other is an arbitrary pairing, and only the two samples'
distributions can tell a fault from chance.  It prints every value of its
seed 1-3 columns that differs from ``reference_plans.json``
(`seed_columns_differ`).

The reference fails to import under jax 0.9 at ``core/iteration.py:46``;
the script imports it through the port's test helper
(`tests/_torch_reference.py`), which works around that line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (1, 2, 3)
REFERENCE_PLANS = os.path.join(ROOT, "results", "reference_plans.json")
REFERENCE_SEEDS = os.path.join(ROOT, "results", "reference_seeds.json")
WORK_SCALE = 0.25          # benchmarks/common.py, not REPRO_FULL
FIG10_JOBS = (2, 3, 4, 5, 6)
FIG12_PROBS = (0.0, 0.05, 0.10, 0.20, 0.30)
# the figure suites' plans (a suite's function that hands its plan to
# benchmarks.common.run_plan, or returns it), by the name chip_smoke.py
# reads; kernel_sweep reports only timings, so it has no entry here
FIGURE_SUITES = {
    "fig7-9": ("convergence", "run"),
    "table2": ("diversity", "run"),
    "fig13": ("partial_compat", "run"),
    "fig14": ("circular", "run"),
    "fig15": ("parameters", "fig15_agg_functions"),
    "fig16": ("parameters", "fig16_heatmap"),
    "fig17": ("parameters", "fig17_wi_vs_md"),
}
SUITES = {**FIGURE_SUITES, "kernel_sweep": ("kernel_sweep", "make_plan")}
PLANS = ("fig10-reno", "fig10-dcqcn", "fig12", "fig5", "churn",
         *FIGURE_SUITES)
# the plans reference_seeds.json holds at seeds 1..N (--seeds N), and the
# family-wise error rate of distribution_check
DISTRIBUTION_PLANS = ("fig10-reno", "fig10-dcqcn", "fig12", *FIGURE_SUITES)
ALPHA = 0.01
FIG17_CELLS = ("reno-WI", "reno-MD", "cubic-WI", "cubic-MD")
# the suites' own assertions on their groups (least, most): fig 16
# exactly 2 (parameters.py), Table 2 at most 4 (diversity.py), fig 13 at
# most 2 (partial_compat.py)
SUITE_GROUPS = {"table2": (1, 4), "fig13": (1, 2), "fig16": (2, 2)}
# the paper's claims (figure_claims): fig 13's compatibility threshold,
# fig 15's increasing and decreasing F families
FIG13_COMPAT = 0.7
FIG15_INCREASING = ("F1", "F2", "F3", "F4")
FIG15_DECREASING = ("F5", "F6")
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


class _Captured(Exception):
    def __init__(self, plan, kw):
        super().__init__("plan captured")
        self.plan, self.kw = plan, kw


def captured_plan(name: str):
    """(plan, run_plan keywords) of a figure suite, as the suite builds it
    and hands it to ``benchmarks.common.run_plan`` (patched for the call to
    record the plan and stop the suite; a suite whose function returns its
    plan is taken at its word).  Runs inside `reference_modules()` with
    the repo root on ``sys.path``; nothing is simulated."""
    import importlib

    from benchmarks import common

    module, fn = SUITES[name]
    suite = importlib.import_module(f"benchmarks.{module}")

    def grab(plan, **kw):
        raise _Captured(plan, kw)
    original = common.run_plan
    common.run_plan = grab
    try:
        out = getattr(suite, fn)()
    except _Captured as c:
        return c.plan, c.kw
    finally:
        common.run_plan = original
    return out, {}


def converged_iteration(res) -> float:
    """convergence._converged_iteration: the first iteration after which
    job 0's iteration times stay within 10% of the tail median."""
    import numpy as np

    xs = res.iter_times[0]
    if xs.size < 10:
        return float("nan")
    tail = np.median(xs[len(xs) // 2:])
    ok = np.abs(xs - tail) <= 0.1 * tail
    for i in range(len(ok)):
        if ok[i:].all():
            return float(i)
    return float(len(ok))


def _axis_values(pr, name: str) -> tuple:
    return next(a.values for a in pr.plan.axes if a.name == name)


def figure_cells(name: str, netsim, workload, pr) -> dict:
    """A figure plan's cells, each {metric: [value per seed]} in the plan's
    seed order, the metrics its suite reports, seed by seed (the suites
    report seed means); ``netsim`` and ``workload`` are either package's.

    fig7-9: per algorithm, WI over OFF (avg, p99), both interleaves, the
    WI runs' converged iteration, drops and marks per second of each;
    table2: per snapshot, MLQCN over base (avg, p99) and ``vs_ideal`` (each
    job's MLQCN mean iteration over its run alone, warmup 2, averaged over
    the jobs); fig13: per compatibility, MLQCN and Static over base;
    fig14: per scheme the interleave, MLQCN and Cassini over base; fig15:
    per F over OFF (avg, p99) and its interleave, OFF's interleave; fig16:
    per (S, I) WI over OFF; fig17: per algo-variant over that algo's OFF."""
    def inter(rs):
        return [netsim.mean_pairwise_interleave(r) for r in rs]
    cells = {}
    if name == "fig7-9":
        for algo in _axis_values(pr, "algo"):
            base = pr.select(algo=algo, variant="OFF")
            ml = pr.select(algo=algo, variant="WI")
            cells[algo] = dict(
                speedups(netsim, base, ml),
                baseline_interleave=inter(base),
                mltcp_interleave=inter(ml),
                converged_at_iter=[finite(converged_iteration(r))
                                   for r in ml],
                baseline_drops_per_s=[r.drops_per_s for r in base],
                mltcp_drops_per_s=[r.drops_per_s for r in ml],
                baseline_marks_per_s=[r.marks_per_s for r in base],
                mltcp_marks_per_s=[r.marks_per_s for r in ml])
    elif name == "table2":
        for snap in _axis_values(pr, "snap"):
            base = pr.select(snap=snap, scheme="base", solo="all")
            ml = pr.select(snap=snap, scheme="mlqcn", solo="all")
            alone = [pr.select(snap=snap, scheme="base", solo=j)
                     for j in (0, 1)]
            vs_ideal = [sum(m.avg_iter(j, warmup=2)
                            / alone[j][i].avg_iter(j, warmup=2)
                            for j in (0, 1)) / 2
                        for i, m in enumerate(ml)]
            cells[snap] = dict(speedups(netsim, base, ml),
                               vs_ideal=[finite(v) for v in vs_ideal])
    elif name == "fig13":
        for cs in _axis_values(pr, "cs"):
            prof = workload.profile_for("gpt2").compute_scaled(cs)
            compat = workload.compatibility_score(
                prof.scaled(WORK_SCALE), prof.scaled(WORK_SCALE))
            base = pr.select(cs=cs, scheme="base")
            ml = speedups(netsim, base, pr.select(cs=cs, scheme="mlqcn"))
            st = speedups(netsim, base, pr.select(cs=cs, scheme="static"))
            cells[f"compat={compat:.2f}"] = dict(
                mlqcn_avg=ml["avg_speedup"], mlqcn_p99=ml["p99_speedup"],
                static_avg=st["avg_speedup"], static_p99=st["p99_speedup"],
                compat=[compat] * len(base))
    elif name == "fig14":
        base = pr.select(scheme="base")
        cells["base"] = dict(interleave=inter(base))
        for scheme in ("mlqcn", "cassini"):
            test = pr.select(scheme=scheme)
            cells[scheme] = dict(speedups(netsim, base, test),
                                 interleave=inter(test))
    elif name == "fig15":
        base = pr.select(scheme="OFF")
        cells["OFF"] = dict(interleave=inter(base))
        for f in _axis_values(pr, "scheme")[1:]:
            test = pr.select(scheme=f)
            cells[f] = dict(speedups(netsim, base, test),
                            interleave=inter(test))
    elif name == "fig16":
        base = pr.select(variant="OFF")
        for s in _axis_values(pr, "slope"):
            for i in _axis_values(pr, "intercept"):
                cells[f"S={s},I={i}"] = speedups(
                    netsim, base,
                    pr.select(variant="WI", slope=s, intercept=i))
    elif name == "fig17":
        for cell in FIG17_CELLS:
            algo, variant = cell.split("-")
            cells[cell] = speedups(netsim,
                                   pr.select(algo=algo, variant="OFF"),
                                   pr.select(algo=algo, variant=variant))
    else:
        raise KeyError(f"no cells for plan {name!r}")
    return cells


def figure_claims(name: str, cells: dict, cassini_has_schedule=None
                  ) -> dict:
    """The paper's claims of a figure plan (its `figure_cells`), each
    {claim: [held per seed]}: figs 7-9
    MLTCP interleaves below the baseline and speeds it up, per algorithm;
    fig 13 below compatibility FIG13_COMPAT MLQCN's p99 stays >= 1 and
    Static's drops below 1; fig 14 Cassini finds no schedule and MLQCN
    interleaves below base DCQCN; fig 15 F1..F4 interleave below F5 and F6
    and speed up, F5 and F6 slow down (SRPT reinforcement); fig 17 WI and
    MD both speed up.  Table 2 and fig 16 claim nothing per seed."""
    n = len(next(iter(next(iter(cells.values())).values())))

    def per_seed(held):
        return [bool(held(i)) for i in range(n)]
    out = {}
    if name == "fig7-9":
        for algo, c in cells.items():
            out[f"{algo}: MLTCP interleave below the baseline's"] = per_seed(
                lambda i, c=c: c["mltcp_interleave"][i]
                < c["baseline_interleave"][i])
            out[f"{algo}: avg speedup above 1"] = per_seed(
                lambda i, c=c: c["avg_speedup"][i] > 1.0)
    elif name == "fig13":
        for key, c in cells.items():
            if c["compat"][0] < FIG13_COMPAT:
                out[f"{key}: MLQCN p99 at least 1"] = per_seed(
                    lambda i, c=c: c["mlqcn_p99"][i] >= 1.0)
                out[f"{key}: Static p99 below 1"] = per_seed(
                    lambda i, c=c: c["static_p99"][i] < 1.0)
    elif name == "fig14":
        out["Cassini has no schedule"] = [not cassini_has_schedule] * n
        out["MLQCN interleave below base DCQCN's"] = per_seed(
            lambda i: cells["mlqcn"]["interleave"][i]
            < cells["base"]["interleave"][i])
    elif name == "fig15":
        for f in FIG15_INCREASING:
            for g in FIG15_DECREASING:
                out[f"{f} interleave below {g}'s"] = per_seed(
                    lambda i, f=f, g=g: cells[f]["interleave"][i]
                    < cells[g]["interleave"][i])
            out[f"{f} avg speedup above 1"] = per_seed(
                lambda i, f=f: cells[f]["avg_speedup"][i] > 1.0)
        for g in FIG15_DECREASING:
            out[f"{g} avg speedup below 1"] = per_seed(
                lambda i, g=g: cells[g]["avg_speedup"][i] < 1.0)
    elif name == "fig17":
        for cell, c in cells.items():
            out[f"{cell} avg speedup above 1"] = per_seed(
                lambda i, c=c: c["avg_speedup"][i] > 1.0)
    return out


def unshared_claims(claims: dict, ref_claims: dict) -> list:
    """(claim, seed index) where the reference holds a claim at a seed and
    the port does not: the failures the figures phase does not excuse."""
    return [(claim, i) for claim, held in claims.items()
            for i, (got, want) in enumerate(zip(held, ref_claims[claim]))
            if want and not got]


def _finite(v) -> bool:
    return v is not None and math.isfinite(v)


def _summary(sample) -> dict:
    """n, mean and median of a sample (bools count as 0 and 1)."""
    xs = [float(v) for v in sample]
    return dict(n=len(xs), mean=statistics.mean(xs) if xs else None,
                median=statistics.median(xs) if xs else None)


def _row(plan, cell, metric, test, port, ref, p) -> dict:
    a, b = _summary(port), _summary(ref)
    return dict(plan=plan, cell=cell, metric=metric, test=test,
                n_port=a["n"], n_reference=b["n"], port_mean=a["mean"],
                reference_mean=b["mean"], port_median=a["median"],
                reference_median=b["median"], p=p)


def _fisher(port, ref) -> float:
    """Fisher's exact test (two-sided) on how often two samples of bools
    hold."""
    from scipy import stats

    a, b = sum(map(bool, port)), sum(map(bool, ref))
    return float(stats.fisher_exact([[a, len(port) - a],
                                     [b, len(ref) - b]]).pvalue)


def holm(rows: list, alpha: float = ALPHA) -> list:
    """Holm-Bonferroni over ``rows`` (each with its ``p``) at the
    family-wise ``alpha``: the row of rank r (1 for the smallest p; ties in
    the rows' order) gets the threshold alpha / (m - r + 1), and rows are
    rejected in rank order up to the first whose p is above its threshold;
    that row and every later one are accepted.  Sets ``rank``,
    ``holm_threshold`` and ``verdict`` ("reject" or "accept") on each row
    and returns the rows in their own order."""
    order = sorted(range(len(rows)), key=lambda i: rows[i]["p"])
    rejecting = True
    for rank, i in enumerate(order):
        threshold = alpha / (len(rows) - rank)
        rejecting = rejecting and rows[i]["p"] <= threshold
        rows[i].update(rank=rank + 1, holm_threshold=threshold,
                       verdict="reject" if rejecting else "accept")
    return rows


def distribution_check(port_cells: dict, ref_cells: dict,
                       alpha: float = ALPHA, port_claims=None,
                       ref_claims=None) -> list:
    """The port's values over its seeds against the reference's over its
    own, as two samples, with no seed paired to a seed.  ``port_cells`` and
    ``ref_cells`` are {plan: {cell: {metric: [value per seed]}}}
    (`figure_cells`, the fig 10 and 12 cells; None or a non-finite value
    is "never"), ``port_claims`` and ``ref_claims`` {plan: {claim: [held
    per seed]}} (`figure_claims`).  One row per (plan, cell, metric) of
    the port's: a two-sided Mann-Whitney U on the finite values of both
    sides (p = 1 where a side has none, or where both are one and the same
    constant); where either side has a "never", a second row (metric
    "<metric>: never"), Fisher's exact test on the count of them; and one
    row per claim (cell "claims"), Fisher's exact test on the number of
    seeds at which it holds.  Each row reports both sides' n, mean and
    median and its p; `holm` then decides every row at the family-wise
    ``alpha``."""
    from scipy import stats

    rows = []
    for plan, cells in port_cells.items():
        for cell, metrics in cells.items():
            for metric, values in metrics.items():
                want = ref_cells[plan][cell][metric]
                x = [float(v) for v in values if _finite(v)]
                y = [float(v) for v in want if _finite(v)]
                p = (float(stats.mannwhitneyu(
                        x, y, alternative="two-sided").pvalue)
                     if x and y and len(set(x + y)) > 1 else 1.0)
                rows.append(_row(plan, cell, metric, "mann-whitney", x, y,
                                 p))
                if len(x) < len(values) or len(y) < len(want):
                    never = [not _finite(v) for v in values]
                    never_ref = [not _finite(v) for v in want]
                    rows.append(_row(plan, cell, f"{metric}: never",
                                     "fisher", never, never_ref,
                                     _fisher(never, never_ref)))
    for plan, claims in (port_claims or {}).items():
        for claim, held in claims.items():
            want = ref_claims[plan][claim]
            rows.append(_row(plan, "claims", claim, "fisher", held, want,
                             _fisher(held, want)))
    return holm(rows, alpha)


def seed_columns(values: dict, seeds, columns) -> dict:
    """A plan's cells, {cell: {metric: [value per seed]}}, cut to
    ``columns``, the seeds to keep; ``seeds`` are the seeds its lists
    follow."""
    idx = [list(seeds).index(s) for s in columns]
    return {key: {m: [v[i] for i in idx] for m, v in metrics.items()}
            for key, metrics in values.items()}


def seed_columns_differ(doc: dict, ref_doc: dict) -> list:
    """Every value of ``doc`` (reference_seeds.json) at a seed that
    ``ref_doc`` (reference_plans.json) also holds that is not the same as
    ``ref_doc``'s, over every plan in both and every cell, metric and claim
    of ``doc``'s: (plan, cell or "claims", metric or claim, seed, the two
    values)."""
    seeds = [s for s in doc["seeds"] if s in ref_doc["seeds"]]
    out = []
    for plan, entry in doc["plans"].items():
        want = ref_doc["plans"].get(plan)
        if want is None:
            continue
        pairs = [(cell, metrics, want["cells"][cell])
                 for cell, metrics in entry["cells"].items()]
        if "claims" in entry:
            pairs.append(("claims", entry["claims"], want["claims"]))
        for cell, got, ref in pairs:
            for metric, values in got.items():
                for s in seeds:
                    u = values[doc["seeds"].index(s)]
                    w = ref[metric][ref_doc["seeds"].index(s)]
                    if u != w and not (u != u and w != w):     # nan, nan
                        out.append(dict(plan=plan, cell=cell, metric=metric,
                                        seed=s, seeds_value=u,
                                        plans_value=w))
    return out


def active_jobs(point, n_jobs: int) -> list:
    """The jobs a plan point runs: all but those its ``job_active`` mask
    leaves out (a one-hot `solo` axis runs one job alone)."""
    mask = None if point.params is None else point.params.job_active
    if mask is None:
        return list(range(n_jobs))
    mask = [bool(x) for x in mask.reshape(-1).tolist()]
    return [j for j in range(n_jobs) if mask[j]]


def idle_jobs(pr) -> list:
    """[point label, job] of every job a point runs (`active_jobs`) that
    recorded no finite iteration in the run."""
    import numpy as np

    return [[r.point.label(), j] for r in pr
            for j in active_jobs(r.point, len(r.iter_times))
            if r.iter_times[j].size == 0
            or not np.all(np.isfinite(r.iter_times[j]))]


def cassini_feasible(netsim, workload) -> bool:
    """circular.run's `cassini_has_schedule`: whether Cassini finds a
    schedule for fig 14's three GPT-2 jobs on the triangle."""
    profs = [workload.profile_for("gpt2").scaled(WORK_SCALE)
             for _ in range(3)]
    return bool(workload.cassini_schedule(
        netsim.triangle(sockets_per_job=2), profs)[1])


def suite_assertions(pr, groups) -> dict:
    """The suite's own assertions on the plan's run, each with its verdict:
    its groups within ``groups`` (least, most; None where the suite asserts
    none) and no kernel fallback."""
    if groups is None:
        return {}
    lo, hi = groups
    return {f"groups in {lo}-{hi}": bool(lo <= pr.n_compile_groups <= hi),
            "no kernel fallback": bool(pr.n_kernel_fallbacks == 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="the file to write (default "
                    "results/reference_plans.json, with --seeds "
                    "results/reference_seeds.json)")
    ap.add_argument("--only", nargs="+", choices=PLANS,
                    help="run only these plans, keeping the file's others")
    ap.add_argument("--seeds", type=int, metavar="N",
                    help="run the plans of DISTRIBUTION_PLANS at seeds "
                         "1..N (not 1-3)")
    args = ap.parse_args(argv)
    names = DISTRIBUTION_PLANS if args.seeds else PLANS
    if set(args.only or ()) - set(names):
        ap.error(f"--seeds runs only {', '.join(names)}")
    only = set(args.only or names)
    seeds = tuple(range(1, args.seeds + 1)) if args.seeds else SEEDS
    path = args.out or (REFERENCE_SEEDS if args.seeds else REFERENCE_PLANS)
    os.environ["REPRO_SMOKE"] = "1"
    os.environ["REPRO_FULL"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tests")]
    from _torch_reference import reference_modules

    out = {"source": "scripts/reference_plans.py: the JAX reference's "
                     "run_plan on the CPU, REPRO_SMOKE depth",
           "seeds": list(seeds), "plans": {}}
    if args.only and os.path.exists(path):
        with open(path) as f:
            kept = json.load(f)
        if kept["seeds"] != list(seeds):
            ap.error(f"{path} holds seeds {kept['seeds']}, not {seeds}")
        out["plans"] = kept["plans"]
    with reference_modules():
        import jax

        from benchmarks import churn, common, speedup_vs_jobs, stragglers
        from benchmarks import timeline
        from repro import netsim, workload

        common.SEEDS = seeds
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
        for name in FIGURE_SUITES:
            if name not in only:
                continue
            t0 = time.time()
            plan, kw = captured_plan(name)
            pr = netsim.run_plan(plan, **kw)
            cells = figure_cells(name, netsim, workload, pr)
            entry = dict(n_compile_groups=pr.n_compile_groups,
                         seconds=time.time() - t0, sim_time=common.SIM_TIME,
                         seeds=list(common.SEEDS), cells=cells,
                         assertions=suite_assertions(
                             pr, SUITE_GROUPS.get(name)),
                         idle_jobs=idle_jobs(pr))
            if name == "fig14":
                entry["cassini_has_schedule"] = cassini_feasible(netsim,
                                                                 workload)
            entry["claims"] = figure_claims(
                name, cells, entry.get("cassini_has_schedule"))
            out["plans"][name] = entry
            print(name, round(entry["seconds"], 1), json.dumps(
                dict(groups=pr.n_compile_groups,
                     assertions=entry["assertions"],
                     claims=entry["claims"])), flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    if args.seeds:
        with open(REFERENCE_PLANS) as f:
            differ = seed_columns_differ(out, json.load(f))
        print(f"{len(differ)} values of seeds 1-3 differ from "
              f"{os.path.relpath(REFERENCE_PLANS, ROOT)}", flush=True)
        for d in differ:
            print(json.dumps(d), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
