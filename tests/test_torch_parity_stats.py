"""The distributional parity check of the figure plans, on the recorded JSON.

``chip_smoke.py``'s ``plans`` and ``figures`` phases run the figure plans
at seeds 1-32 on the card and hold each cell and claim to the JAX
reference's distribution over the same seeds
(``results/reference_seeds.json``, ``scripts/reference_plans.py --seeds
32``) with ``reference_plans.distribution_check``: a two-sided
Mann-Whitney U on the finite values, Fisher's exact test on the count of
"never" values and on the seeds at which a claim holds, Holm-Bonferroni
over every row of a phase at a family-wise 0.01.  These tests run the
statistic on the recorded numbers only; nothing is simulated.

* It rejects a known gross gap (figs 7-9: the baseline's interleave
  against MLTCP's, per algorithm) and accepts the reference against
  itself (seeds 1-16 against seeds 17-32, every plan).
* Two samples of one constant read p = 1; "never" counts and claims go
  through Fisher's test; Holm assigns its thresholds by rank and stops
  rejecting at the first row above its threshold.
* ``reference_seeds.json`` holds 32 seeds of every plan it names, and its
  seed 1-3 columns equal ``reference_plans.json``'s but for fig 13's few
  ulp (`SEED_COLUMN_DIFFS`).
* The phase's report (`chip_smoke.distribution`) names its rows, carries
  each paired outside value's p and verdict, and fails on a rejected row.
"""
import json
import sys
from pathlib import Path

import pytest
from scipy import stats

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]
try:
    import chip_smoke
    import reference_plans as rp
finally:
    del sys.path[:2]

SEEDS = list(range(1, 33))
# The values of reference_seeds.json's seed 1-3 columns that differ from
# reference_plans.json (scripts/reference_plans.py --seeds 32 prints them):
# 25 of fig 13's speedups, each within 3.7e-7 of its value (a few ulp; the
# reference's XLA program at K = 320 points a group, not 30, rounds a few
# of its per-point values otherwise, and no run diverged).  Every other
# value of every plan is equal.
SEED_COLUMN_DIFFS = {"fig13": (25, 3.7e-7)}


def _load(name):
    with open(ROOT / "results" / name) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def seeds_doc():
    return _load("reference_seeds.json")


def _half(cells, seeds):
    return rp.seed_columns(cells, SEEDS, seeds)


def test_reference_seeds_hold_32_seeds_of_every_plan(seeds_doc):
    assert seeds_doc["seeds"] == SEEDS
    assert seeds_doc["sim_time"] == 1.5 and seeds_doc["work_scale"] == 0.25
    assert set(seeds_doc["plans"]) == set(rp.DISTRIBUTION_PLANS)
    for name, entry in seeds_doc["plans"].items():
        for cell, metrics in entry["cells"].items():
            for metric, values in metrics.items():
                assert len(values) == 32, (name, cell, metric)
        if name in rp.FIGURE_SUITES:
            assert entry["seeds"] == SEEDS
            assert entry["claims"] == rp.figure_claims(
                name, entry["cells"], entry.get("cassini_has_schedule"))
            assert all(len(held) == 32 for held in entry["claims"].values())
            assert all(entry["assertions"].values())


def test_seed_1_3_columns_equal_reference_plans(seeds_doc):
    plans_doc = _load("reference_plans.json")
    differ = rp.seed_columns_differ(seeds_doc, plans_doc)
    for plan, (count, rel) in SEED_COLUMN_DIFFS.items():
        mine = [d for d in differ if d["plan"] == plan]
        assert len(mine) == count
        assert all(d["seed"] in (1, 2, 3) and d["cell"] != "claims"
                   and abs(d["seeds_value"] - d["plans_value"])
                   <= rel * abs(d["plans_value"]) for d in mine), mine
    assert {d["plan"] for d in differ} == set(SEED_COLUMN_DIFFS)
    # the comparison sees a changed value
    changed = json.loads(json.dumps(seeds_doc))
    cubic = changed["plans"]["fig7-9"]["cells"]["cubic"]
    cubic["converged_at_iter"][1] = -1.0
    assert rp.seed_columns_differ(changed, plans_doc) == [
        dict(plan="fig7-9", cell="cubic", metric="converged_at_iter", seed=2,
             seeds_value=-1.0,
             plans_value=plans_doc["plans"]["fig7-9"]["cells"]["cubic"][
                 "converged_at_iter"][1])] + differ


def test_rejects_the_baseline_interleave_against_mltcp(seeds_doc):
    cells = seeds_doc["plans"]["fig7-9"]["cells"]
    port = {"fig7-9": {algo: {"interleave": c["baseline_interleave"]}
                       for algo, c in cells.items()}}
    ref = {"fig7-9": {algo: {"interleave": c["mltcp_interleave"]}
                      for algo, c in cells.items()}}
    rows = rp.distribution_check(port, ref)
    assert [r["cell"] for r in rows] == list(cells) == ["reno", "cubic",
                                                        "dcqcn"]
    for r in rows:
        assert r["test"] == "mann-whitney" and r["verdict"] == "reject", r
        assert r["n_port"] == r["n_reference"] == 32
        assert r["port_mean"] > r["reference_mean"]
        assert r["p"] < 1e-9


@pytest.mark.parametrize("name", rp.DISTRIBUTION_PLANS)
def test_accepts_the_reference_against_itself(seeds_doc, name):
    entry = seeds_doc["plans"][name]
    first, second = SEEDS[:16], SEEDS[16:]
    port_claims = ref_claims = None
    if "claims" in entry:
        port_claims = {name: {c: held[:16] for c, held
                              in entry["claims"].items()}}
        ref_claims = {name: {c: held[16:] for c, held
                             in entry["claims"].items()}}
    rows = rp.distribution_check({name: _half(entry["cells"], first)},
                                 {name: _half(entry["cells"], second)},
                                 port_claims=port_claims,
                                 ref_claims=ref_claims)
    n_metrics = sum(len(m) for m in entry["cells"].values())
    assert len(rows) >= n_metrics + len(entry.get("claims", ()))
    assert [r for r in rows if r["verdict"] == "reject"] == []
    assert all(r["n_port"] <= 16 and r["n_reference"] <= 16 for r in rows)


def test_equal_constants_read_p_1():
    port = {"p": {"c": {"compat": [0.5] * 32, "one": [2.0]}}}
    ref = {"p": {"c": {"compat": [0.5] * 32, "one": [2.0] * 5}}}
    rows = rp.distribution_check(port, ref)
    assert [(r["metric"], r["p"], r["verdict"]) for r in rows] == [
        ("compat", 1.0, "accept"), ("one", 1.0, "accept")]
    assert rows[0]["port_mean"] == rows[0]["reference_median"] == 0.5
    # two different constants are as far apart as two samples can be
    apart = rp.distribution_check(port, {"p": {"c": {
        "compat": [0.75] * 32, "one": [2.0]}}})
    assert apart[0]["verdict"] == "reject" and apart[0]["p"] < 1e-9


def test_never_counts_go_through_fishers_test():
    port = [None] * 12 + [float(i) for i in range(20)]
    ref = [None] * 2 + [float("inf")] + [float(i) for i in range(29)]
    rows = rp.distribution_check({"p": {"c": {"tti": port}}},
                                 {"p": {"c": {"tti": ref}}})
    values, never = rows
    assert (values["metric"], values["test"]) == ("tti", "mann-whitney")
    assert (values["n_port"], values["n_reference"]) == (20, 29)
    assert values["p"] == pytest.approx(stats.mannwhitneyu(
        list(range(20)), list(range(29)), alternative="two-sided").pvalue)
    assert (never["metric"], never["test"]) == ("tti: never", "fisher")
    assert never["p"] == stats.fisher_exact([[12, 20], [3, 29]]).pvalue
    assert never["port_mean"] == 12 / 32 and never["reference_mean"] == 3 / 32
    # no row of "never" where neither side has one; a side with no finite
    # value leaves only Fisher's test to decide
    assert len(rp.distribution_check({"p": {"c": {"x": [1.0, 2.0]}}},
                                     {"p": {"c": {"x": [3.0]}}})) == 1
    empty = rp.distribution_check({"p": {"c": {"x": [None] * 32}}},
                                  {"p": {"c": {"x": [1.0] * 32}}})
    assert [(r["p"], r["verdict"]) for r in empty] == [
        (1.0, "accept"), (stats.fisher_exact([[32, 0], [0, 32]]).pvalue,
                          "reject")]


def test_claims_go_through_fishers_test():
    held = [True] * 30 + [False] * 2
    rows = rp.distribution_check(
        {}, {}, port_claims={"fig17": {"WI speeds up": held}},
        ref_claims={"fig17": {"WI speeds up": [True] * 10 + [False] * 22}})
    (row,) = rows
    assert (row["plan"], row["cell"], row["metric"], row["test"]) == (
        "fig17", "claims", "WI speeds up", "fisher")
    assert row["p"] == stats.fisher_exact([[30, 2], [10, 22]]).pvalue
    assert row["verdict"] == "reject"
    assert row["port_mean"] == 30 / 32 and row["reference_median"] == 0.0


def test_holm_orders_the_rows():
    ps = [0.04, 0.001, 0.2, 0.0005, 0.004, 0.001]
    rows = rp.holm([dict(p=p) for p in ps], alpha=0.01)
    # ranks by p, ties in the rows' order; threshold alpha / (m - rank + 1)
    assert [r["rank"] for r in rows] == [5, 2, 6, 1, 4, 3]
    assert [r["holm_threshold"] for r in rows] == pytest.approx(
        [0.01 / 2, 0.01 / 5, 0.01 / 1, 0.01 / 6, 0.01 / 3, 0.01 / 4])
    # 0.0005 <= 0.01/6, 0.001 <= 0.01/5, 0.001 <= 0.01/4; 0.004 > 0.01/3
    # stops the descent, so 0.04 and 0.2 are accepted too
    assert [r["verdict"] for r in rows] == ["accept", "reject", "accept",
                                            "reject", "accept", "reject"]
    # past a rejection the next row meets the next, looser threshold; a
    # row below its own threshold after the stop is still accepted
    both = rp.holm([dict(p=0.006), dict(p=0.0049)], alpha=0.01)
    assert [r["verdict"] for r in both] == ["reject", "reject"]
    stopped = rp.holm([dict(p=0.009), dict(p=0.0051)], alpha=0.01)
    assert [r["verdict"] for r in stopped] == ["accept", "accept"]


def test_the_phase_report_names_its_rows_and_fails_on_a_rejection(
        seeds_doc):
    cells = seeds_doc["plans"]["fig7-9"]["cells"]
    rows = rp.distribution_check({"fig7-9": cells}, {"fig7-9": cells})
    outside = [dict(plan="fig7-9", cell="cubic", seed=1,
                    metric="converged_at_iter", port=22.0, reference=5.0,
                    gap=17.0, tolerance=11.0)]
    named = [("fig7-9", "cubic", "converged_at_iter"),
             ("fig7-9", "cubic", "mltcp_interleave")]
    report = chip_smoke.distribution(rows, chip_smoke.FIGURE_SEEDS, named,
                                     outside)
    assert report["seeds"] == [1, 32] and report["alpha"] == rp.ALPHA
    assert report["n_rows"] == len(rows) and report["rejected"] == []
    assert [(r["cell"], r["metric"], r["p"]) for r in report["named"]] == [
        ("cubic", "converged_at_iter", 1.0), ("cubic", "mltcp_interleave",
                                              1.0)]
    assert report["outside"] == [dict(outside[0], p=1.0, verdict="accept")]
    chip_smoke.check_distribution("figures", report)
    gap = chip_smoke.distribution(rp.distribution_check(
        {"fig7-9": {"cubic": {"m": cells["cubic"]["baseline_interleave"]}}},
        {"fig7-9": {"cubic": {"m": cells["cubic"]["mltcp_interleave"]}}}),
        chip_smoke.FIGURE_SEEDS)
    with pytest.raises(AssertionError, match="figures: the port's "
                       "distribution over seeds 1-32 differs"):
        chip_smoke.check_distribution("figures", gap)


def test_the_phases_run_32_seeds_and_pair_seeds_1_3():
    assert chip_smoke.PLAN_SEEDS == chip_smoke.FIGURE_SEEDS == tuple(SEEDS)
    assert chip_smoke.PAIRED_SEEDS == (1, 2, 3)
    cells = {"6": {"p99_speedup": [float(s) for s in SEEDS]}}
    assert rp.seed_columns(cells, SEEDS, chip_smoke.PAIRED_SEEDS) == {
        "6": {"p99_speedup": [1.0, 2.0, 3.0]}}


class _Point(dict):
    """A plan point: its axes, and its label as `SweepPoint.label` makes it."""

    def label(self):
        return ",".join(f"{k}={v}" for k, v in self.items())


class _Result:
    def __init__(self, n_jobs, **axes):
        self.point = _Point(axes)
        self.iter_times = [None] * n_jobs


def test_idle_jobs_excused_paired_at_seeds_1_3_and_by_cell_elsewhere():
    pr = [_Result(2, snap="a", scheme=scheme, solo="all", seed=s)
          for scheme in ("base", "mlqcn") for s in (1, 2, 3, 4, 5)]
    paired = [["snap=a,scheme=base,solo=all,seed=2", 1]]
    # the reference leaves job 1 of the base cell idle at seed 17 only
    anywhere = [["snap=a,scheme=base,solo=all,seed=17", 1]]
    assert chip_smoke.excused_idle(pr, paired, anywhere) == [
        paired[0], ["snap=a,scheme=base,solo=all,seed=4", 1],
        ["snap=a,scheme=base,solo=all,seed=5", 1]]
    assert chip_smoke.excused_idle(pr, paired, []) == paired
