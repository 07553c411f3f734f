"""The paper-figure harness on the port (`repro_torch.figures`) against the
JAX reference's ``benchmarks/``.

* Same inputs, same numbers: each suite of both packages runs on one
  prepared `PlanResult` per plan (``benchmarks.common.run_plan`` patched
  inside `reference_modules()`, as ``scripts/reference_plans.py
  ::captured_plan`` patches it, and ``repro_torch.figures.common.run_plan``
  patched to hand back the same object), and the two derived dicts are
  equal bit for bit, NaN equal to NaN.  The prepared results are the
  port's `SimResult`s (numpy-side, so the reference's code reads them
  too), drawn from a numpy seed with enough iterations that no summary is
  NaN by construction; the timeline and churn suites get telemetry whose
  detector outputs make each of their assertions hold and fail, and both
  packages raise the same assertion with the same message.
* End to end: the fig 12 suite runs on the CPU at a tiny depth and
  returns the reference's recorded keys with a clean health block.
* `merge_results`, the harness's CSV and the suites' order match the
  reference's; the plan registry holds no plan of its own.
"""
import dataclasses
import importlib
import inspect
import json
import math
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

from _torch_reference import reference_modules

from repro_torch import netsim
from repro_torch.analysis import plans
from repro_torch.figures import (churn, common, kernel_sweep, stragglers,
                                 timeline)
from repro_torch.figures import __main__ as harness
from repro_torch.netsim import experiment
from repro_torch.netsim.telemetry import FaultEventReport, TelemetryResult

ROOT = Path(__file__).resolve().parents[1]
N_SAMPLES = 40          # telemetry samples and trace chunks a run
N_ITERS = 30            # iterations a job records

# (reference module, function, keywords) of every suite, by harness name
SUITES = {
    "fig5_timeline": ("timeline", "run", {}),
    "fig7_9_convergence": ("convergence", "run", {}),
    "fig10_speedup_vs_jobs": ("speedup_vs_jobs", "run", {}),
    "fig11_table2_diversity": ("diversity", "run", {}),
    "fig12_stragglers": ("stragglers", "run", {}),
    "fig13_partial_compat": ("partial_compat", "run", {}),
    "fig14_circular_dependency": ("circular", "run", {}),
    "fig15_agg_functions": ("parameters", "fig15_agg_functions", {}),
    "fig16_slope_intercept": ("parameters", "fig16_heatmap", {}),
    "fig17_wi_vs_md": ("parameters", "fig17_wi_vs_md", {}),
    "kernel_sweep": ("kernel_sweep", "run", {}),
    "churn_gauntlet": ("churn", "run", {}),
}
# the ways the timeline and churn suites' assertions are made to fail
TIMELINE_FAILS = ("ml_slow", "base_converged")
CHURN_FAILS = ("missing", "reinterleave", "ml_stability",
               "baseline_reconverged", "margin")


# ---------------------------------------------------------------------------
# prepared results
# ---------------------------------------------------------------------------

def _timeline_telemetry(rng, cfg, pt, mode) -> TelemetryResult:
    n_flows, n_links = cfg.topo.n_flows, cfg.topo.n_links
    n_jobs = cfg.jobs.n_jobs
    ml = pt["variant"] == "WI"
    tti = float(rng.integers(1, 9)) if ml else float("inf")
    if ml and mode == "ml_slow" and pt["algo"] == "reno":
        tti = 12.0
    converged = ml or (mode == "base_converged" and pt["algo"] == "reno")
    hist = rng.integers(0, 20, (n_jobs, 16))
    return TelemetryResult(
        spec=timeline.telemetry_spec(),
        t=np.linspace(0.0, cfg.sim_time, N_SAMPLES),
        ticks=np.arange(N_SAMPLES, dtype=np.int32),
        series={"flow_cwnd": rng.uniform(1, 100, (N_SAMPLES, n_flows)),
                "flow_rate": rng.uniform(0, 6e9, (N_SAMPLES, n_flows)),
                "link_queue": rng.uniform(0, 2e6, (N_SAMPLES, n_links)),
                "job_incomm": rng.uniform(0, 1, (N_SAMPLES, n_jobs)) < 0.5,
                "interleave_overlap": rng.uniform(0, 1, (N_SAMPLES,))},
        n_samples=N_SAMPLES,
        time_to_interleave_s=tti * 0.07 if math.isfinite(tti) else tti,
        time_to_interleave_iters=tti,
        interleave_stability=float(rng.uniform(0.9, 1.0)) if ml
        else float(rng.uniform(0.0, 0.5)),
        converged=bool(converged),
        iter_hist=hist, bin_edges=np.geomspace(1e-3, 1.0, 17))


def _churn_telemetry(rng, cfg, pt, mode) -> TelemetryResult:
    ml = pt["variant"] == "WI"
    target = pt["algo"] == "reno" and pt["schedule"] == "gauntlet"
    names = churn._window_names(cfg, pt["schedule"])
    events = []
    for i, (tick, name) in enumerate(sorted(names.items())):
        if ml and target and mode == "missing" and name == "re-arrival":
            continue
        it = float(rng.integers(0, 8)) if ml or i % 3 else float("inf")
        if ml and target and mode == "reinterleave" and name == "flap-clear":
            it = 18.0
        events.append(FaultEventReport(
            event=i, start_tick=tick, start_t=tick * cfg.dt,
            end_tick=tick + 100, start_iter=i, disrupted=bool(it > 0),
            reconverged=bool(math.isfinite(it)), disruption_s=0.01,
            reinterleave_iters=it))
    stability = (float(rng.uniform(0.96, 1.0)) if ml
                 else float(rng.uniform(0.3, 0.7)))
    if ml and target and mode == "ml_stability":
        stability = 0.9
    if not ml and target and mode == "margin":
        stability = 0.999
    return TelemetryResult(
        spec=cfg.telemetry, t=np.linspace(0.0, cfg.sim_time, N_SAMPLES),
        ticks=np.arange(N_SAMPLES, dtype=np.int32),
        series={"interleave_overlap": rng.uniform(0, 1, (N_SAMPLES,))},
        n_samples=N_SAMPLES, interleave_stability=stability,
        converged=ml, fault_events=events,
        all_events_reconverged=bool(
            ml or (target and mode == "baseline_reconverged")),
        max_reinterleave_iters=max(e.reinterleave_iters for e in events))


def _prepared(plan, mode="holds") -> netsim.PlanResult:
    """The plan's points as drawn `SimResult`s, in one PlanResult with the
    plan's own group count."""
    rng = np.random.default_rng(zlib.crc32(plan.name.encode()))
    points = plan.points()
    cfgs = [plan.build(dict(pt)) for pt in points]
    results = []
    for pt, cfg in zip(points, cfgs):
        j, m = cfg.jobs.n_jobs, cfg.topo.n_links
        tel = None
        if plan.name == "fig5-timeline":
            tel = _timeline_telemetry(rng, cfg, pt, mode)
        elif plan.name == "churn-gauntlet":
            tel = _churn_telemetry(rng, cfg, pt, mode)
        results.append(netsim.SimResult(
            cfg=cfg,
            iter_times=[rng.uniform(0.05, 0.1, N_ITERS) for _ in range(j)],
            drops_per_s=float(rng.uniform(1e3, 1e4)),
            marks_per_s=float(rng.uniform(1e3, 1e4)),
            trace_t=np.linspace(0.0, cfg.sim_time, N_SAMPLES),
            trace_util=rng.uniform(0, 1, (N_SAMPLES, m)),
            trace_incomm=(rng.uniform(0, 1, (N_SAMPLES, j)) < 0.5
                          ).astype(np.float32),
            trace_drops=rng.uniform(0, 10, (N_SAMPLES,)),
            trace_jobtput=rng.uniform(0, 6e9, (N_SAMPLES, j)),
            point=netsim.SweepPoint(axes=dict(pt), n_jobs=j),
            telemetry=tel))
    groups = experiment.resolve_plan(plan)[3]
    return netsim.PlanResult(plan=plan, results=results,
                             n_compile_groups=len(groups))


def _clock():
    """A stand-in for the `time` module whose clock advances 1.5 s a
    read, the same in both packages."""
    ticks = iter(1.5 * i for i in range(1000))
    return types.SimpleNamespace(time=lambda: next(ticks))


def _run_port(name, prepared, monkeypatch, tmp_path):
    """(derived or None, assertion message or None) of the port's suite,
    each plan handed its prepared result (made on first use)."""
    module, fn, kw = SUITES[name]
    suite = importlib.import_module(f"repro_torch.figures.{module}")

    def run_plan(p, **_):
        if p.name not in prepared:
            prepared[p.name] = prepared["_make"](p)
        return prepared[p.name]
    monkeypatch.setattr(common, "run_plan", run_plan)
    monkeypatch.setattr(kernel_sweep, "_per_tick", run_plan)
    monkeypatch.setattr(kernel_sweep, "time", _clock())
    monkeypatch.setattr(timeline, "TIMELINES_DIR", str(tmp_path))
    try:
        return getattr(suite, fn)(device="cpu", **kw), None
    except AssertionError as exc:
        return None, str(exc)


def _run_reference(name, prepared, monkeypatch, tmp_path):
    """The reference suite on the same prepared results."""
    module, fn, kw = SUITES[name]
    sys.path.insert(0, str(ROOT))
    try:
        with reference_modules():
            from benchmarks import common as rcommon

            suite = importlib.import_module(f"benchmarks.{module}")
            monkeypatch.setattr(rcommon, "run_plan",
                                lambda p, **_: prepared[p.name])
            if module == "kernel_sweep":
                monkeypatch.setattr(suite, "time", _clock())
            if module == "timeline":
                monkeypatch.setattr(suite, "TIMELINES_DIR", str(tmp_path))
            try:
                return getattr(suite, fn)(**kw), None
            except AssertionError as exc:
                return None, str(exc)
    finally:
        sys.path.remove(str(ROOT))


def _assert_same(a, b, where="derived"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        assert isinstance(b, float) and not isinstance(b, bool), (where, b)
        assert (math.isnan(a) and math.isnan(b)) or \
            struct.pack("<d", a) == struct.pack("<d", b), (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _both(name, monkeypatch, tmp_path, mode="holds"):
    prepared = {"_make": lambda p: _prepared(p, mode)}
    port = _run_port(name, prepared, monkeypatch, tmp_path)
    ref = _run_reference(name, prepared, monkeypatch, tmp_path)
    return port, ref


# ---------------------------------------------------------------------------
# the suites against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SUITES))
def test_suite_matches_reference_on_the_same_results(name, monkeypatch,
                                                     tmp_path):
    (got, got_err), (want, want_err) = _both(name, monkeypatch, tmp_path)
    assert got_err is None and want_err is None, (got_err, want_err)
    _assert_same(got, want)


@pytest.mark.parametrize("suite,mode",
                         [("fig5_timeline", m) for m in TIMELINE_FAILS]
                         + [("churn_gauntlet", m) for m in CHURN_FAILS])
def test_suite_assertions_fail_as_the_reference(suite, mode, monkeypatch,
                                                tmp_path):
    (got, got_err), (want, want_err) = _both(suite, monkeypatch, tmp_path,
                                             mode)
    assert got is None and want is None
    assert got_err == want_err and got_err.startswith("reno")


# ---------------------------------------------------------------------------
# end to end, the harness, the registry
# ---------------------------------------------------------------------------

def test_fig12_suite_end_to_end_on_the_cpu():
    """The fig 12 suite through the real `common.run_plan` (plan lint,
    `run_plan`, health) on the CPU, 0.04 s of a workload cut to 2% so that
    every job completes iterations past the speedups' warm-up."""
    with common.at_depth(SIM_TIME=0.04, SEEDS=(1,), WORK_SCALE=0.02):
        r = common.timed("fig12_stragglers", lambda: stragglers.run(
            probs=(0.0, 0.1), device="cpu"))
    with open(ROOT / "results" / "benchmarks.json") as f:
        recorded = json.load(f)["fig12_stragglers"]
    assert list(r.derived) == ["p=0.0", "p=0.1"]
    for cell in r.derived.values():
        assert list(cell) == list(recorded["p=0.0"])
        assert all(math.isfinite(v) for v in cell.values())
    assert r.health == dict(
        n_kernel_fallbacks=0, n_cache_hits=0, n_compile_groups=2,
        n_groups_predicted=2, n_group_mispredicts=0, n_plan_findings=0,
        n_group_errors=0, n_budget_mismatches=0)
    assert r.n_ticks == 6 * 2000
    assert r.csv_line().startswith("fig12_stragglers,")


def test_merge_results_matches_reference(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        with reference_modules():
            from benchmarks import common as rcommon

            files = {}
            for pkg, merge in (("ref", rcommon.merge_results),
                               ("port", common.merge_results)):
                path = tmp_path / pkg / "sub" / "results.json"
                steps = [merge({"a": {"x": 1.5}}, str(path)),
                         merge({"b": [1, 2]}, str(path))]
                path.write_text('{"a": {"x": 1.5}, "b": [1,')  # corrupt
                steps.append(merge({"c": None}, str(path)))
                steps.append(merge({"c": 2.0, "d": "e"}, str(path)))
                assert not path.with_name("results.json.tmp").exists()
                files[pkg] = (steps, path.read_text())
    finally:
        sys.path.remove(str(ROOT))
    assert files["port"] == files["ref"]
    assert files["port"][0][2] == {"c": None}
    assert common.RESULTS_PATH == str(Path("results") / "figures_torch.json")


def test_harness_runs_the_reference_suites_in_order(monkeypatch, capsys):
    """`python -m repro_torch.figures` runs the reference's suites under
    its names, in its order, and prints the same CSV lines."""
    def timed_in(pkg_common):
        def timed(name, fn):
            return pkg_common.BenchResult(
                name, 0.25, 1000, {"first": 1.0, "second": 2},
                health=dict(n_kernel_fallbacks=0, n_cache_hits=3))
        return timed

    lines, merged = {}, {}
    sys.path.insert(0, str(ROOT))
    try:
        with reference_modules():
            from benchmarks import common as rcommon
            from benchmarks import run as rrun

            for pkg, mod, main in (("ref", rcommon, rrun.main),
                                   ("port", common, harness.main)):
                got = merged[pkg] = []
                monkeypatch.setattr(mod, "timed", timed_in(mod))
                monkeypatch.setattr(mod, "merge_results",
                                    lambda new, got=got: got.append(new))
                main()
                lines[pkg] = capsys.readouterr().out.splitlines()
    finally:
        sys.path.remove(str(ROOT))
    assert lines["port"][:-1] == lines["ref"][:-1]
    assert merged["port"] == merged["ref"]
    assert [name for name, _ in harness.SUITES] == list(SUITES)
    assert lines["port"][-1] == (f"# merged {len(SUITES)} suites into "
                                 f"{common.RESULTS_PATH}")


def test_plan_registry_builds_the_suites_plans():
    """`analysis.plans` holds no plan of its own: each builder is its
    suite's, at the depth it is given."""
    assert "netsim.Plan(" not in inspect.getsource(plans)
    with common.at_depth(SIM_TIME=0.3, SEEDS=(4, 5)):
        want = stragglers.make_plan()
        want_cfg = want.build(want.points()[0])
    got = plans.fig12_plan(0.3, (4, 5))
    assert got.points() == want.points() and got.name == want.name
    # built outside the block, at the depth the registry pinned
    cfg = got.build(got.points()[0])
    assert cfg.sim_time == 0.3 and experiment._point_cache_key(cfg, {}) == \
        experiment._point_cache_key(want_cfg, {})
    assert common.SIM_TIME == common.depth()["SIM_TIME"]
    churn_cfg = plans.churn_plan(0.2, (1,)).build(dict(
        algo="cubic", variant="WI", schedule="gauntlet", seed=1))
    assert churn_cfg.sim_time == 0.2
    assert churn.SIM_TIME == 18.0 * common.WORK_SCALE
    assert churn_cfg.telemetry == churn._telemetry_spec(0.2)
    with pytest.raises(KeyError):
        with common.at_depth(SIM_TIEM=1.0):
            pass
    assert dataclasses.is_dataclass(got)
