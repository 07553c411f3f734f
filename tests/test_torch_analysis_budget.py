"""The launch budgets (`repro_torch.analysis.budget`): the `BudgetBook`
contract on scratch baselines (clean, drift naming the group and the
metric, missing, stale, environment mismatch, no file, the update round
trip, `matches_any`), and the committed ``budgets.json`` against what the
CPU computes for the same groups (its device-independent leaves, exactly).
The card's leaves are recorded and checked by the ``analysis`` phase of
``chip_smoke.py``.
"""
import json

import pytest

from repro_torch.analysis import budget, kernel_lint, plans
from repro_torch.analysis.budget import BudgetBook
from repro_torch.netsim import experiment

SIG = "group0|jobs=2 flows=4 algo=0 dt=2e-05 faults=False"
ENV = dict(ctas=4, threads=32, smem_bytes=1160, launches=400,
           operand_bytes=123456, trace_bytes=9600, registers=117,
           local_bytes=0, static_smem_bytes=0, peak_bytes=2_000_000)


def _recorded(tmp_path, envs=None):
    book = BudgetBook(path=tmp_path / "budgets.json", update=True,
                      device="cpu")
    for sig, env in (envs or {SIG: ENV}).items():
        book.observe("fig12", sig, env)
    book.save()
    return tmp_path / "budgets.json"


def _checked(path, envs=None):
    book = BudgetBook(path=path, device="cpu")
    for sig, env in (envs or {SIG: ENV}).items():
        book.observe("fig12", sig, env)
    return book.finish()


def test_clean_within_tolerance(tmp_path):
    path = _recorded(tmp_path)
    assert _checked(path) == []
    # the peak's 25% tolerance absorbs the allocator's rounding
    assert _checked(path, {SIG: dict(ENV, peak_bytes=2_400_000)}) == []


@pytest.mark.parametrize("metric,value", [("smem_bytes", 1164),
                                          ("registers", 118),
                                          ("peak_bytes", 3_000_000)])
def test_drift_names_group_and_metric(tmp_path, metric, value):
    path = _recorded(tmp_path)
    (f,) = _checked(path, {SIG: dict(ENV, **{metric: value})})
    assert f.rule == "budget/drift"
    assert f.where == f"fig12 :: {SIG}" and f.message.startswith(metric)


def test_missing_and_stale_baseline(tmp_path):
    path = _recorded(tmp_path)
    other = SIG.replace("group0", "group1")
    findings = _checked(path, {other: ENV})
    assert {(f.rule, f.where) for f in findings} == {
        ("budget/missing-baseline", f"fig12 :: {other}"),
        ("budget/stale-baseline", f"fig12 :: {SIG}")}
    assert {f.severity_under("ci") for f in findings} == {"error"}
    assert {f.severity_under("bench") for f in findings} == {"warning"}


def test_env_mismatch_skips_drift(tmp_path):
    path = _recorded(tmp_path)
    data = json.loads(path.read_text())
    data["env"]["device"] = "another card"
    path.write_text(json.dumps(data))
    (f,) = _checked(path, {SIG: dict(ENV, smem_bytes=1)})
    assert f.rule == "budget/env-mismatch"
    assert BudgetBook(path=path, device="cpu").matches_any(
        SIG.split("|", 1)[1], ENV) is None


def test_no_baseline_file(tmp_path):
    (f,) = _checked(tmp_path / "absent.json")
    assert f.rule == "budget/missing-baseline" and "does not exist" in \
        f.message
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99}))
    (f,) = _checked(bad)
    assert f.rule == "budget/missing-baseline" and "schema" in f.message


def test_update_round_trip(tmp_path):
    path = _recorded(tmp_path, {SIG: ENV, SIG.replace("0|", "1|"): ENV})
    data = json.loads(path.read_text())
    assert data["schema"] == budget.SCHEMA
    assert data["env"] == budget.env_fingerprint("cpu")
    assert data["tolerances"] == budget.DEFAULT_TOLERANCES
    assert [g["signature"] for g in data["plans"]["fig12"]["groups"]] == \
        [SIG, SIG.replace("0|", "1|")]
    again = BudgetBook(path=path, update=True, device="cpu")
    for g in data["plans"]["fig12"]["groups"]:
        again.observe("fig12", g["signature"],
                      {k: v for k, v in g.items() if k != "signature"})
    assert again.to_json() == data


def test_matches_any_over_the_shared_leaves(tmp_path):
    path = _recorded(tmp_path)
    book = BudgetBook(path=path, device="cpu")
    tail = SIG.split("|", 1)[1]
    static = {m: ENV[m] for m in budget.STATIC_METRICS}
    assert book.matches_any(tail, static) is True
    assert book.matches_any(tail, dict(static, launches=401)) is False
    assert book.matches_any("jobs=9 flows=9 algo=0", static) is None


def test_committed_budgets_match_the_cpu(monkeypatch):
    """Every group the committed baseline pins, its device-independent
    leaves exactly as the CPU computes them at the recorded depth; and the
    groups are the CI plans' groups."""
    data = json.loads(budget.DEFAULT_PATH.read_text())
    assert data["schema"] == budget.SCHEMA
    assert set(data["tolerances"]) == set(budget.METRICS)
    for name in ("REPRO_SMOKE", "REPRO_FULL"):
        value = data["env"][name.lower()]
        if value:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)
    labels = []
    for name in plans.CI_PLANS:
        plan, tel, lint_unarmed = plans.resolve_entry(name)
        variants = [(name, tel)] + ([(f"{name}[unarmed]", None)]
                                    if lint_unarmed else [])
        for label, telemetry in variants:
            labels.append(label)
            _, cfgs, overrides, groups = experiment.resolve_plan(
                plan, telemetry=telemetry)
            pinned = data["plans"][label]["groups"]
            assert len(pinned) == len(groups)
            for gi, (g, base) in enumerate(zip(groups, pinned)):
                assert base["signature"] == (
                    f"group{gi}|{experiment._group_signature(g)}")
                sweep = experiment.group_sweep(cfgs, overrides, g,
                                               device="cpu")
                env = budget.static_envelope(
                    g.cfg, kernel_lint.launch_setup(g.cfg, sweep))
                assert env == {m: base[m] for m in budget.STATIC_METRICS}, \
                    (label, gi)
                assert set(budget.CARD_METRICS) <= set(base)
                assert base["local_bytes"] == 0
    assert sorted(data["plans"]) == sorted(labels)
