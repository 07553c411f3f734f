"""The port's static verifier (`repro_torch.analysis`) against the JAX
reference's (`repro.analysis`), and every port rule on a fixture.

* Parity: for each of the five CI plans the reference's `lint_plan` on
  its ``benchmarks/`` plan and the port's on its own copy give the same
  points, the same groups (members and stacked sweep values) and the same
  (rule, location, differing field paths) findings; `kernel_expectation`
  agrees with the reference's ("fused" <-> "chunk", "fallback" <->
  "per-tick") over favoritism x F family x Static factors;
  `REFERENCE_RULES` maps exactly the reference's rule catalog.
* Each port rule fires on a small fixture or tamper, and its pragma
  suppresses it where it has one; the severity profiles and report
  gating; the source lint over the port's own tree is clean under ``ci``.
* End to end on the CPU: `run_analysis(["fig12"], device="cpu")` runs as
  many groups as it predicted; the CLI's ``--list-rules`` and its
  source-only run.

The launch budgets are in ``test_torch_analysis_budget.py``; the card's
side (the library's shared memory and spills) in ``test_torch_cuda.py``.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_reference import load_reference, reference_modules

import torch

from repro_torch import core as tcore
from repro_torch import netsim as tnet
from repro_torch.analysis import (AnalysisReport, CI_PLANS, REFERENCE_RULES,
                                  RULES, analyze_plan, make_finding,
                                  run_analysis, severity_for)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import (dispatch_lint, kernel_lint, plan_lint,
                                  plans, runner, source_lint)
from repro_torch.kernels import netsim_chunk as nc
from repro_torch.netsim import engine, experiment

REF = load_reference()
ROOT = Path(__file__).resolve().parents[1]
DT = 2e-5


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def _reference_lint(name):
    """The reference's plan lint of a CI plan, with every split's full
    differing field paths (the finding's message keeps only six)."""
    sys.path.insert(0, str(ROOT))
    try:
        with reference_modules():
            from benchmarks import common
            from repro.analysis import plan_lint as rpl
            from repro.analysis import plans as rplans
            from repro.netsim import experiment as rexp

            plan, tel, lint_unarmed = rplans.resolve_entry(name)
            findings, facts = rpl.lint_plan(plan, label=name, telemetry=tel)
            points, cfgs, overrides, groups = facts["_resolved"]
            paths = {}
            for gi in range(len(groups)):
                for gj in range(gi + 1, len(groups)):
                    diffs = []
                    rpl._leaf_diffs(groups[gi].cfg, groups[gj].cfg, "", diffs)
                    paths[f"{name}/group{gi}~group{gj}"] = (
                        [p for p, _, _ in diffs]
                        or ["static_job_factors.presence"])
            sweeps = [{f: np.asarray(v) for f, v in
                       rexp.group_sweep(cfgs, overrides, g)._asdict().items()
                       if v is not None} for g in groups]
            depth = dict(smoke=common.SMOKE, full=common.FULL)
    finally:
        sys.path.remove(str(ROOT))
    return dict(points=points, groups=[g.idxs for g in groups],
                findings={(f.rule, f.where, tuple(paths[f.where]))
                          for f in findings},
                sweeps=sweeps, facts=facts, depth=depth,
                lint_unarmed=lint_unarmed)


@pytest.mark.parametrize("name", CI_PLANS)
def test_ci_plan_lint_matches_reference(name, monkeypatch):
    want = _reference_lint(name)
    # the port's plans read the depth when built: the reference's suites
    # read it at import
    monkeypatch.setenv("REPRO_SMOKE", str(int(want["depth"]["smoke"])))
    monkeypatch.setenv("REPRO_FULL", str(int(want["depth"]["full"])))
    plan, tel, lint_unarmed = plans.resolve_entry(name)
    findings, facts = plan_lint.lint_plan(plan, label=name, telemetry=tel)
    points, cfgs, overrides, groups = facts["_resolved"]
    assert lint_unarmed == want["lint_unarmed"]
    assert points == want["points"]
    assert [g.idxs for g in groups] == want["groups"]
    got = {(f.rule, f.where, tuple(facts["splits"][f.where]))
           for f in findings}
    assert got == want["findings"]
    assert facts["wasted_runs_estimate"] == \
        want["facts"]["wasted_traces_estimate"]
    for g, ref_sweep in zip(groups, want["sweeps"]):
        sweep = experiment.group_sweep(cfgs, overrides, g, device="cpu")
        ours = {f: v.numpy() for f, v in sweep._asdict().items()
                if v is not None}
        assert set(ours) == set(ref_sweep)
        for field, v in ours.items():
            np.testing.assert_array_equal(v, ref_sweep[field], err_msg=field)


def _expectation_cfgs(favoritism, f_spec, factors):
    """The same dumbbell(2, 2) point in both packages (the reference's
    asks for the Pallas kernel), and the port's sweep."""
    def cfg(core, net, **kw):
        proto = core.MLTCPConfig(
            cc=core.CCParams(algo=0, variant=1, tick_dt=DT, rtt=100e-6),
            favoritism=favoritism, f_spec=f_spec)
        return net.SimConfig(
            topo=net.dumbbell(2, sockets_per_job=2),
            jobs=net.JobSpec.simple([0.0075] * 2, [25e6] * 2),
            protocol=proto, sim_time=0.06, dt=DT,
            static_job_factors=(np.asarray([1.3, 0.7]) if factors else None),
            **kw)
    return (cfg(REF["repro.core"], REF["repro.netsim"],
                use_pallas_kernel=True),
            cfg(tcore, tnet))


@pytest.mark.parametrize("factors", (False, True))
@pytest.mark.parametrize("f_spec", ("linear", "F3"))
@pytest.mark.parametrize("favoritism", ("largest_data_sent",
                                        "smallest_data_sent"))
def test_kernel_expectation_matches_reference(favoritism, f_spec, factors):
    """The port's route where the reference's is its own, but one case:
    F3 over largest_data_sent without factors, which the reference's
    oracle takes (its Pallas kernel computes only the linear F) and the
    port's CC kernels compute (the launch's F id), so the port says
    "chunk" there by design."""
    ref_cfg, cfg = _expectation_cfgs(favoritism, f_spec, factors)
    with reference_modules():
        from repro.analysis import jaxpr_lint

        want = jaxpr_lint.kernel_expectation(
            ref_cfg, REF["repro.netsim"].make_sweep(ref_cfg))
    got = dispatch_lint.kernel_expectation(
        cfg, tnet.make_sweep(cfg, device="cpu"))
    route = {"fused": "chunk", "fallback": "per-tick"}[want]
    if (f_spec, favoritism, factors) == ("F3", "largest_data_sent", False):
        assert want == "fallback"
        route = "chunk"
    assert route == (got if got == "chunk" else got[0])


def test_reference_rules_cover_reference_catalog():
    with reference_modules():
        from repro.analysis import findings as rfindings

        ref_rules = set(rfindings.RULES)
    assert len(ref_rules) == 31
    assert set(REFERENCE_RULES) == ref_rules
    for rid, target in REFERENCE_RULES.items():
        assert target in RULES or target.startswith("none: "), rid
    for r in RULES.values():
        assert r.summary and r.rationale


# ---------------------------------------------------------------------------
# plan and dispatch rules
# ---------------------------------------------------------------------------

def _cfg(sim_time=0.004, n_jobs=2, variant=1, proto_kw=None, n_chunks=2,
         **kw):
    proto = tcore.MLTCPConfig(
        cc=tcore.CCParams(algo=0, variant=variant, tick_dt=DT, rtt=100e-6),
        **(proto_kw or {}))
    return tnet.SimConfig(
        topo=tnet.dumbbell(n_jobs, sockets_per_job=2),
        jobs=tnet.JobSpec.simple([0.0075] * n_jobs, [25e6] * n_jobs),
        protocol=proto, sim_time=sim_time, dt=DT, seed=3, n_chunks=n_chunks,
        **kw)


def _variant_plan():
    return tnet.Plan(name="variant-plan",
                     build=lambda pt: _cfg(variant={"OFF": 0,
                                                    "WI": 1}[pt["variant"]]),
                     axes=(tnet.Axis("variant", ("OFF", "WI")),
                           tnet.Axis("seed", (3,))))


def test_group_split_explainer_names_the_field():
    findings, facts = plan_lint.lint_plan(_variant_plan(), label="vp")
    assert facts["groups"] == 2
    splits = [f for f in findings if f.rule == "plan/group-split"]
    assert len(splits) == 1 and "protocol.cc.variant" in splits[0].message
    assert facts["splits"] == {"vp/group0~group1": ["protocol.cc.variant"]}
    assert "plan/avoidable-split" not in _rules(findings)
    assert facts["wasted_runs_estimate"] == 0


def test_avoidable_split_fires_on_value_axis():
    plan = tnet.Plan(name="bb-plan",
                     build=lambda pt: _cfg(buffer_bytes=pt["bb"]),
                     axes=(tnet.Axis("bb", (2e6, 4e6)),
                           tnet.Axis("seed", (3,))))
    findings, facts = plan_lint.lint_plan(plan, label="bb")
    avoid = [f for f in findings if f.rule == "plan/avoidable-split"]
    assert len(avoid) == 1 and "buffer_bytes" in avoid[0].message
    assert facts["wasted_runs_estimate"] == 1
    assert plan_lint.predict_compile_groups(plan) == 2


def test_accounting_end_to_end_and_group_mismatch(monkeypatch):
    report = analyze_plan("vp", _variant_plan(), device="cpu")
    assert report.ok(), report.render()
    proof = report.proofs["vp"]
    assert proof["groups_predicted"] == proof["groups_run"] == 2
    assert proof["kernel_groups_expected"] == 2
    assert proof["kernel_fallbacks"] == proof["f64_operands"] == 0
    assert proof["groups_at_full_depth"] == 0
    # a run that makes two runs of run_ticks per group breaks the proof
    simulate = engine.simulate_sweep

    def twice(cfg, sweep, device=None):
        simulate(cfg, sweep, device=device)
        return simulate(cfg, sweep, device=device)
    monkeypatch.setattr(engine, "simulate_sweep", twice)
    bad = analyze_plan("vp", _variant_plan(), device="cpu")
    assert "plan/group-mismatch" in _rules(bad.errors())
    assert bad.proofs["vp"]["groups_run"] == 4


def test_kernel_missing_unless_one_launch_and_no_fallback():
    assert runner.check_launches("p/group0", 1, 0) == []
    assert runner.check_launches("p/group0", 400, 0, chunks=400) == []
    for launches, fallbacks in ((0, 1), (0, 0), (2, 0)):
        (f,) = runner.check_launches("p/group0", launches, fallbacks)
        assert f.rule == "dispatch/kernel-missing"


def test_cut_keeps_the_chunk_and_the_layout():
    cfg = _cfg(sim_time=0.02, n_chunks=4)
    cut = runner.cut_to_one_chunk(cfg)
    assert cut.n_chunks == 1 and cut.n_ticks == cfg.n_ticks // 4
    assert runner._layout(cut) == runner._layout(cfg)


def test_kernel_fallback_fires_with_its_reason():
    cfg = _cfg(proto_kw=dict(favoritism="smallest_data_sent"))
    findings, facts = dispatch_lint.lint_dispatch(
        cfg, tnet.make_sweep(cfg, device="cpu"), label="fb")
    (f,) = [f for f in findings if f.rule == "dispatch/kernel-fallback"]
    assert "favoritism" in f.message and facts["expectation"] == "per-tick"
    # Static factors make favoritism moot: the chunk kernel takes it
    ok, facts = dispatch_lint.lint_dispatch(
        cfg, tnet.make_sweep(cfg, device="cpu",
                             static_job_factors=[[1.3, 0.7]]), label="fb")
    assert not ok and facts["expectation"] == "chunk"


def test_armed_md_lints_clean_on_the_chunk_kernel():
    """Telemetry armed on MD: the dispatch and the launch contract are
    clean, the card takes the chunk kernel, and the specialization is one
    the library runs."""
    cfg = _cfg(variant=2, telemetry=tnet.TelemetrySpec(probes=("flow_cwnd",),
                                                       stride=5))
    sweep = tnet.make_sweep(cfg, device="cpu")
    findings, facts = dispatch_lint.lint_dispatch(cfg, sweep, label="md")
    assert findings == [] and facts["expectation"] == "chunk"
    spec = kernel_lint.specialization_of(cfg, sweep)
    assert spec[1] == 2 and spec[4] == nc.ARM_TEL
    assert spec in kernel_lint.built_specializations()
    kf, kfacts = kernel_lint.lint_kernel(cfg, sweep, label="md")
    assert kf == [] and kfacts["specialization"] == list(spec)


def test_f64_operand_fires_on_a_float64_leaf():
    cfg = _cfg()
    sweep = tnet.make_sweep(cfg, device="cpu")
    findings, facts = dispatch_lint.lint_dispatch(
        cfg, sweep._replace(slope=sweep.slope.double()), label="f64")
    (f,) = findings
    assert f.rule == "dispatch/f64-operand" and "sweep.slope" in f.message
    assert facts["f64_operands"] == 1


# ---------------------------------------------------------------------------
# launch-contract rules
# ---------------------------------------------------------------------------

def _setup(cfg=None):
    cfg = _cfg() if cfg is None else cfg
    sweep = tnet.make_sweep(cfg, device="cpu", seed=[1, 2])
    return cfg, sweep, kernel_lint.launch_setup(cfg, sweep)


def test_launch_contract_clean_and_built_specializations():
    assert len(kernel_lint.CC_SPECIALIZATIONS) == 48
    assert len(kernel_lint.built_specializations()) == 4 * 48
    cfg, sweep, setup = _setup()
    findings, facts = kernel_lint.lint_kernel(cfg, sweep, label="ok",
                                              setup=setup)
    assert findings == []
    assert facts["smem_bytes"] == nc.smem_bytes(**nc.shape_of(cfg))
    assert facts["threads"] == 32 and "registers" not in facts


def test_smem_budget_fires_over_the_ceiling():
    cfg, sweep, setup = _setup()
    findings, facts = kernel_lint.lint_kernel(cfg, sweep, label="s",
                                              setup=setup,
                                              smem_ceiling_bytes=256)
    (f,) = findings
    assert f.rule == "kernel/smem-budget" and "256" in f.message


def test_threads_fire_over_max_threads(monkeypatch):
    monkeypatch.setattr(nc, "threads_for", lambda M, N, J: 512)
    cfg, sweep, setup = _setup()
    findings, _ = kernel_lint.lint_kernel(cfg, sweep, label="t", setup=setup)
    assert _rules(findings) == {"kernel/threads"}


def test_operand_mismatch_fires_on_a_tampered_operand():
    cfg, sweep, setup = _setup()
    run = setup.run._replace(params=setup.run.params.double())
    findings, _ = kernel_lint.lint_kernel(cfg, sweep, label="o",
                                          setup=setup._replace(run=run))
    msgs = [f.message for f in findings if f.rule == "kernel/operand-mismatch"]
    assert any(m.startswith("params is torch.float64") for m in msgs)
    # a non-contiguous state buffer, and a chunk input launch_arguments
    # refuses
    cs = setup.cs._replace(fflow=setup.cs.fflow.transpose(1, 2)
                           .contiguous().transpose(1, 2))
    inputs = setup.inputs._replace(t=setup.inputs.t[:-1])
    findings, _ = kernel_lint.lint_kernel(
        cfg, sweep, label="o", setup=setup._replace(cs=cs, inputs=inputs))
    msgs = [f.message for f in findings if f.rule == "kernel/operand-mismatch"]
    assert "fflow is not contiguous" in msgs
    assert any("launch_arguments refuses" in m for m in msgs)


def test_library_rules_on_stubbed_library_reads(monkeypatch):
    """The card's side of the contract, its library reads stubbed: an smem
    size other than the prediction, spills and a short thread limit."""
    cfg, sweep, setup = _setup()
    need = nc.smem_bytes(**nc.shape_of(cfg))
    attrs = dict(registers=117, local_bytes=0, static_smem_bytes=0,
                 max_threads=256)
    monkeypatch.setattr(nc, "launch_smem_bytes", lambda run: need)
    monkeypatch.setattr(nc, "kernel_attributes", lambda *spec: dict(attrs))
    findings, facts = kernel_lint.lint_library(cfg, sweep, label="l",
                                               setup=setup)
    assert findings == [] and facts["library_smem_bytes"] == need
    monkeypatch.setattr(nc, "launch_smem_bytes", lambda run: need + 4)
    attrs.update(local_bytes=16, max_threads=16)
    findings, _ = kernel_lint.lint_library(cfg, sweep, label="l",
                                           setup=setup)
    assert _rules(findings) == {"kernel/smem-mismatch", "kernel/spill",
                                "kernel/threads"}


def test_ci_plans_static_layers_clean():
    for name in CI_PLANS:
        plan, tel, lint_unarmed = plans.resolve_entry(name)
        for telemetry in ((tel, None) if lint_unarmed else (tel,)):
            findings, facts = plan_lint.lint_plan(plan, label=name,
                                                  telemetry=telemetry)
            assert {f.severity_under("ci") for f in findings} <= {"info"}
            points, cfgs, overrides, groups = facts["_resolved"]
            for gi, g in enumerate(groups):
                sweep = experiment.group_sweep(cfgs, overrides, g,
                                               device="cpu")
                df, dfacts = dispatch_lint.lint_dispatch(g.cfg, sweep,
                                                         label=name)
                kf, _ = kernel_lint.lint_kernel(g.cfg, sweep, label=name)
                assert df == kf == [] and dfacts["expectation"] == "chunk"


# ---------------------------------------------------------------------------
# source rules
# ---------------------------------------------------------------------------

_LOOP = """
import functools
import numpy as np
import torch
from torch import Tensor

def helper(x: Tensor) -> Tensor:
{body}
    return x

def tick(scale, x: Tensor):
    fn = helper
    return fn(x) * scale

def run(x):
    body = functools.partial(tick, 2.0)
    for _ in range(3):
        x = body(x)
    return x
"""
_ROOTS = ("fix.loop:run",)


def _loop_fixture(body_lines, roots=_ROOTS):
    src = _LOOP.format(body="\n".join("    " + l for l in body_lines))
    return source_lint.lint_sources({"fix/loop.py": src}, loop_roots=roots)


def test_host_sync_reached_through_partial_and_alias():
    findings, facts = _loop_fixture(["y = x.sum().item()"])
    (f,) = findings
    assert f.rule == "src/host-sync-in-loop" and "fix.loop:helper" in f.message
    assert facts["loop_reachable"] == 3      # run, tick, helper
    # not reachable from a loop root: nothing fires
    quiet, facts = _loop_fixture(["y = x.sum().item()"], roots=())
    assert quiet == [] and facts["loop_reachable"] == 0


@pytest.mark.parametrize("line", [
    "y = float(torch.sum(x))",
    "n = int(x.amax())",
    "if (x > 0).any():\n        x = x + 1",
    "while x.sum() > 0:\n        x = x - 1",
    "y = 1 if x.max() > 0 else 0",
    "z = x.cpu()",
    "z = x.numpy()",
    "z = x.tolist()",
])
def test_host_sync_fires_and_pragma_suppresses(line):
    findings, _ = _loop_fixture([line])
    assert _rules(findings) == {"src/host-sync-in-loop"}
    first, *rest = line.split("\n")
    ok, _ = _loop_fixture(
        [first + "  # lint: allow(host-sync-in-loop)  fixture", *rest])
    assert ok == []


@pytest.mark.parametrize("line", [
    "n = int(x.shape[0])",
    "if x.numel():\n        x = x + 1",
    "if x is not None and x.ndim == 2:\n        x = x + 1",
    "if x.device.type == 'cuda':\n        x = x + 1",
    "k = len(x)",
    "y = np.zeros(3).sum()",
])
def test_host_sync_quiet_on_static_values(line):
    findings, _ = _loop_fixture([line])
    assert findings == []


def test_f64_literal_rules():
    findings, _ = source_lint.lint_sources({"fix/a.py": (
        "import torch\n"
        "def helper(x):\n"
        "    return x.to(torch.float64)\n"
        "def other(x):\n"
        "    return x.double()\n")})
    assert [f.rule for f in findings] == ["src/f64-literal"] * 2
    ok, _ = source_lint.lint_sources({"fix/b.py": (
        "import numpy as np\n"
        "def plumbing(x):\n"
        "    return np.asarray(x, np.float64)\n")})
    assert ok == []
    findings, _ = _loop_fixture(["y = np.float64(1.0)", "z = 'float64'"])
    assert [f.rule for f in findings] == ["src/f64-literal"] * 2


def test_unit_suffix_conflict_fires():
    findings, _ = source_lint.lint_sources({"fix/u.py": (
        "def f(q_bytes, delay_s):\n"
        "    return q_bytes + delay_s\n")})
    assert _rules(findings) == {"src/unit-suffix"}
    ok, _ = source_lint.lint_sources({"fix/u2.py": (
        "def f(q_bytes, extra_bytes, delay_s, rate_bps):\n"
        "    return q_bytes + extra_bytes, q_bytes / rate_bps + delay_s\n")})
    assert ok == []


def test_stale_pragmas_fire():
    findings, facts = _loop_fixture(["x = x + 1  # lint: allow(no-such)"])
    (f,) = findings
    assert f.rule == "src/stale-pragma" and "unknown rule" in f.message
    assert facts["pragmas"] == 1
    findings, _ = _loop_fixture(
        ["x = x + 1  # lint: allow(host-sync-in-loop)"])
    (f,) = findings
    assert f.rule == "src/stale-pragma" and "outlived" in f.message
    assert severity_for("src/stale-pragma", "ci") == "error"


_CU = """\
// 0.5 in a comment, and "1.5" in a string, pass
__device__ float f(float x) {{
  const float third = (float)(1.0 / 3.0);
  const float tiny = (float)1e-6;
  {line}
  return x * 0.25f + third + tiny;
}}
"""


@pytest.mark.parametrize("line,fires", [
    ("x = x * 0.5;", True),
    ("x = x + 1e-3;", True),
    ("double y = x;", True),
    ("x = x * (float)(2.0 * x);", True),
    ("x = x * 0.5f;", False),
    ("x = x * 2;", False),
    ('printf("%f", 0.5f);', False),
])
def test_cu_double(line, fires):
    findings, facts = source_lint.lint_sources(
        {"csrc/k.cu": _CU.format(line=line)})
    assert facts["cu_files"] == 1
    assert [f.where for f in findings] == (["csrc/k.cu:5"] if fires else [])
    assert all(f.rule == "src/cu-double" for f in findings)
    if fires:
        ok, _ = source_lint.lint_sources({"csrc/k.cu": _CU.format(
            line=line + "  // lint: allow(cu-double) fixture")})
        assert ok == []


def test_port_sources_are_clean_under_ci():
    findings, facts = source_lint.lint_paths()
    report = AnalysisReport(profile="ci")
    report.extend(findings)
    assert report.ok() and findings == [], report.render()
    assert facts["loop_roots"] == len(source_lint.LOOP_ROOTS)
    assert facts["cu_files"] >= 5 and facts["loop_reachable"] > 40
    # every pragma in the port's sources says why on its own line
    for path in (ROOT / "src" / "repro_torch").rglob("*"):
        if path.suffix not in (".py", ".cu", ".cuh"):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = source_lint._PRAGMA.search(line)
            if m:
                assert line[m.end():].strip(" #/:-"), f"{path}:{i}"


# ---------------------------------------------------------------------------
# profiles, the report, the runner and the CLI
# ---------------------------------------------------------------------------

def test_severity_profiles():
    assert severity_for("src/stale-pragma") == "warning"
    assert severity_for("src/stale-pragma", "ci") == "error"
    assert severity_for("budget/missing-baseline", "ci") == "error"
    assert severity_for("budget/drift", "bench") == "error"
    assert severity_for("budget/drift", "notebook") == "warning"
    assert severity_for("plan/group-split", "ci") == "info"
    with pytest.raises(KeyError):
        severity_for("budget/drift", "nightly")


def test_report_profile_gates_ok():
    f = make_finding("src/stale-pragma", "x.py:1", "stale")
    ci = AnalysisReport(profile="ci")
    ci.extend([f])
    assert not ci.ok() and ci.errors()
    nb = AnalysisReport(profile="notebook")
    nb.extend([f])
    assert nb.ok() and not nb.errors() and nb.warnings()
    js = ci.to_json()
    assert js["profile"] == "ci" and js["findings"][0]["severity"] == "error"
    assert "FAIL" in ci.render() and "PASS" in nb.render()
    with pytest.raises(KeyError):
        make_finding("no/such-rule", "x", "y")


def test_run_analysis_fig12_on_the_cpu(monkeypatch):
    monkeypatch.setenv("REPRO_SMOKE", "1")
    report = run_analysis(["fig12"], profile="ci", device="cpu",
                          source=False)
    assert report.ok(), report.render()
    proof = report.proofs["fig12"]
    assert proof["groups_run"] == proof["groups_predicted"] == 2
    assert proof["points"] == 15 and proof["launches"] == 0
    assert proof["kernel_groups_expected"] == 2
    assert proof["device"] == "cpu"


def test_run_plan_profile_fills_the_envelope():
    from repro_torch.analysis import budget

    pr = tnet.run_plan(_variant_plan(), device="cpu", profile=True)
    points, cfgs, overrides, groups = experiment.resolve_plan(_variant_plan())
    for prof, g in zip(pr.profile.groups, groups):
        sweep = experiment.group_sweep(cfgs, overrides, g, device="cpu")
        want = budget.static_envelope(
            g.cfg, kernel_lint.launch_setup(g.cfg, sweep))
        assert prof.cost_envelope == want
        assert set(want) == set(budget.STATIC_METRICS)
        assert want["launches"] == 2 and want["ctas"] == 1


def test_cli_list_rules_and_source_only(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULES:
        assert rid in out
    assert cli.main(["--profile", "ci"]) == 0
    out = capsys.readouterr().out
    assert "PROOF   source:" in out and "PASS [profile=ci]" in out


def test_plans_with_no_card_raise(monkeypatch):
    """Without ``device="cpu"`` the accounting asks for the card, and with
    none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_analysis(["kernel_sweep"], source=False)
