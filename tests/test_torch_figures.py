"""The paper's remaining figure plans on the port, and the route of their
F families.

* Plan parity: each figure suite's plan as the JAX reference's suite hands
  it to ``benchmarks.common.run_plan`` (captured by
  ``scripts/reference_plans.py::captured_plan``, which stops the suite
  there, so nothing runs and nothing in ``benchmarks/`` changes) and the
  port's builder (`analysis.plans.FIGURES`) at the suites' own depth and
  seeds resolve to the same points and the same groups, and every field
  of every group's stacked sweep is bitwise equal.
* ``results/reference_plans.json`` holds each figure plan at seeds 1-3
  with a value per seed for every cell and metric the ``figures`` phase
  of ``chip_smoke.py`` reads, and the claims recorded there are what
  ``reference_plans.figure_claims`` makes of those cells.
* F1..F6 are kernel families: `ops.fallback_reason` refuses only another
  favoritism and a callable F (the one `mltcp_step.f_id` raises for), fig 15's seven groups are the chunk
  kernel's (`dispatch_lint.kernel_expectation`), the CC kernel's plain
  version equals `core.cc_tick` under each F bit for bit, and F1 is
  linear(1.75, 0.25) on the per-tick path, bit for bit on every leaf.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_reference import load_reference, reference_modules

import torch

from repro_torch import core as tcore
from repro_torch import netsim as tnet
from repro_torch.analysis import dispatch_lint, plans
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import ops
from repro_torch.netsim import engine, experiment

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]
try:
    import chip_smoke
    import reference_plans as rp
finally:
    del sys.path[:2]

load_reference()
DT = 2e-5
F_FAMILIES = ("F1", "F2", "F3", "F4", "F5", "F6")
FIGURE_PLANS = tuple(rp.FIGURE_SUITES)


def _reference_plan(name):
    """The reference suite's plan resolved: points, group members, each
    group's stacked sweep as numpy, and the suite's depth and seeds."""
    sys.path.insert(0, str(ROOT))
    try:
        with reference_modules():
            from benchmarks import common
            from repro.netsim import experiment as rexp

            plan, kw = rp.captured_plan(name)
            points, cfgs, overrides, groups = rexp.resolve_plan(plan, **kw)
            sweeps = [{f: np.asarray(v) for f, v in
                       rexp.group_sweep(cfgs, overrides, g)._asdict().items()
                       if v is not None} for g in groups]
            return dict(points=points, groups=[g.idxs for g in groups],
                        sweeps=sweeps, sim_time=common.SIM_TIME,
                        seeds=tuple(common.SEEDS), full=common.FULL)
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("name", FIGURE_PLANS + ("kernel_sweep",))
def test_figure_plan_matches_reference(name, monkeypatch):
    want = _reference_plan(name)
    monkeypatch.setenv("REPRO_FULL", str(int(want["full"])))
    plan = plans.FIGURES[name](want["sim_time"], want["seeds"])
    points, cfgs, overrides, groups = experiment.resolve_plan(plan)
    assert points == want["points"]
    assert [g.idxs for g in groups] == want["groups"]
    for g, ref_sweep in zip(groups, want["sweeps"]):
        sweep = experiment.group_sweep(cfgs, overrides, g, device="cpu")
        ours = {f: v.numpy() for f, v in sweep._asdict().items()
                if v is not None}
        assert set(ours) == set(ref_sweep)
        for field, v in ours.items():
            np.testing.assert_array_equal(v, ref_sweep[field], err_msg=field)


@pytest.mark.parametrize("name", FIGURE_PLANS)
def test_reference_numbers_cover_the_figures_phase(name):
    with open(ROOT / "results" / "reference_plans.json") as f:
        ref = json.load(f)
    entry = ref["plans"][name]
    assert entry["seeds"] == [1, 2, 3] and entry["sim_time"] == 1.5
    cells = entry["cells"]
    metrics = chip_smoke.FIGURE_METRICS[name]
    for metric in metrics:
        assert any(metric in c for c in cells.values()), metric
    for cell, values in cells.items():
        for metric, per_seed in values.items():
            assert len(per_seed) == 3, (cell, metric)
    claims = rp.figure_claims(name, cells, entry.get("cassini_has_schedule"))
    assert claims == entry["claims"]
    assert all(len(held) == 3 for held in claims.values())
    assert all(entry["assertions"].values())
    # the jobs the reference's run leaves without an iteration, which the
    # figures phase excuses in the port's run and nowhere else
    assert all(len(pair) == 2 for pair in entry["idle_jobs"])


# ---------------------------------------------------------------------------
# F1..F6 take the kernels
# ---------------------------------------------------------------------------

def _callable_f(x):
    return 1.5 * x + 0.5


def test_fallback_reason_refuses_only_a_callable_f_or_another_favoritism():
    for f_spec in ("linear",) + F_FAMILIES:
        assert ops.fallback_reason(tcore.MLTCPConfig(f_spec=f_spec),
                                   None) is None
        assert ms.f_id(f_spec) == ms.F_IDS[f_spec]
    assert "favoritism" in ops.fallback_reason(
        tcore.MLTCPConfig(favoritism="earliest_iter_finish"), None)
    assert "f_spec" in ops.fallback_reason(
        tcore.MLTCPConfig(f_spec=_callable_f), None)
    with pytest.raises(ValueError, match="F families"):
        ms.f_id(_callable_f)
    with pytest.raises(ValueError, match="F families"):
        ms.f_id("F7")
    # Static factors leave favoritism moot, but not F: their negative
    # sentinel entries keep the flow's F, which no kernel computes
    factors = torch.ones((1, 4))
    assert ops.fallback_reason(
        tcore.MLTCPConfig(favoritism="earliest_iter_finish"), factors) is None
    assert "f_spec" in ops.fallback_reason(
        tcore.MLTCPConfig(f_spec=_callable_f), factors)


def test_fig15_groups_take_the_chunk_kernel():
    plan = plans.fig15_plan(0.06, (1, 2))
    points, cfgs, overrides, groups = experiment.resolve_plan(plan)
    assert len(groups) == 7
    for g in groups:
        sweep = experiment.group_sweep(cfgs, overrides, g, device="cpu")
        assert dispatch_lint.kernel_expectation(g.cfg, sweep) == "chunk"
        assert ops.chunk_fallback_reason(g.cfg, sweep) is None


@pytest.mark.parametrize("f_spec", F_FAMILIES)
def test_plain_cc_kernel_under_f_equals_core(f_spec):
    """The CC kernel's plain version (the launch's F id on the CPU) equals
    `core.cc_tick` (the F family through `core.f_values`) bit for bit, for
    each algorithm and variant, with and without factors."""
    rng = np.random.default_rng(5)
    k, n = 2, 6
    f2j = np.asarray([0, 0, 1, 1, 2, 2])

    def f32(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (k, n)).astype(
            np.float32))
    for algo in (0, 1, 2):
        for variant in (1, 2, 3):
            cfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=algo,
                                                      variant=variant),
                                    f_spec=f_spec)
            dev = torch.device("cpu")
            st = tcore.init_state(n, cfg, k=k, device=dev)
            det = st.det._replace(bytes_sent=f32(0, 1e8),
                                  bytes_ratio=f32(0, 1),
                                  prev_ack_tstamp=f32(0, 0.01))
            st = st._replace(det=det, cc=st.cc._replace(cwnd=f32(1, 500)))
            fb = tcore.Feedback(
                num_acks=torch.where(f32(0, 1) < 0.7, f32(0, 40), 0.0),
                loss=f32(0, 1) < 0.2, cnp=f32(0, 1) < 0.3,
                now=torch.tensor([0.012, 0.0131]))
            total = f32(1e7, 2e8)
            for factors in (None, torch.where(f32(0, 1) < 0.5,
                                              f32(0.25, 2.0), -1.0)):
                before = ops.FALLBACK_COUNT
                got, rate = ops.mltcp_cc_tick(cfg, st, fb, total,
                                              flow_to_job=f2j, n_jobs=3,
                                              static_factors=factors)
                assert ops.FALLBACK_COUNT == before
                want, want_rate = tcore.cc_tick(cfg, st, fb, total,
                                                flow_to_job=f2j, n_jobs=3,
                                                static_factors=factors)
                for a, b in zip(_leaves((got, rate)),
                                _leaves((want, want_rate))):
                    assert torch.equal(_bits(a), _bits(b)), \
                        (algo, variant, factors is not None)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [x for v in tree for x in _leaves(v)]


def test_f1_equals_linear_on_the_per_tick_path():
    """fig 15's F1 is the linear F at Reno-WI's slope 1.75 and intercept
    0.25: a 0.06 s run of fig 15's fabric (three GPT-2 jobs on
    dumbbell(3, 2), their workload cut to a quarter so that iterations
    complete) on the per-tick path is the same under both, bit for bit on
    every leaf."""
    from repro_torch import workload

    profs = [workload.profile_for("gpt2").scaled(0.25) for _ in range(3)]
    cfg = plans.build_cfg(tnet.dumbbell(3, sockets_per_job=2), profs,
                          plans.protocol("reno", "WI", f_spec="F1"),
                          sim_time=0.06)
    linear = dataclasses.replace(cfg, protocol=dataclasses.replace(
        cfg.protocol, f_spec="linear", slope=1.75, intercept=0.25))
    runs = [engine.run_ticks(c, tnet.make_sweep(c, device="cpu",
                                                seed=[1, 2]))
            for c in (cfg, linear)]
    got, want = (_leaves(r) for r in runs)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = (np.ascontiguousarray(np.asarray(x)) for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), i
    assert int(runs[0].iter_counts.sum()) > 0
