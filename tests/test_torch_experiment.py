"""The port's experiment plans (`repro_torch.netsim.experiment`) against the
JAX reference's, and against their own invariants.

* Grouping: the same plan, built from the same values in each package,
  must partition into the same compile groups (member points, padding
  mask, factor and Cassini presence, group fabric and phase width) and
  stack the same sweep values, exactly.  The plans are the reference
  suites' fig 10 and fig 12 plans and the cases of
  ``tests/test_experiment.py``.  The port's CC tick always has the CC
  kernel's semantics, so reference configs that mix Static factors with
  a non-default F are built with ``use_pallas_kernel=True``.
* Tier B: a short two-variant x three-job-count plan through both
  ``run_plan``s: iteration counts exact, mean iteration times within
  ``MEAN_ITER_RTOL``.
* Inside the port, bitwise: a padded-jobs point equals the same point run
  alone on its own fabric, on every output leaf (active jobs and flows).
* The cache (resume, quarantine, `prune_cache`, the key's NaN/inf
  handling), `where`, validation errors, ``keep_going`` and the counters.
* Telemetry and faults: ``run_plan(telemetry=)`` and a ``field="*"``
  fault-schedule axis group as the reference's do and stack the same fault
  tables (padded with identity values on a padded fabric); the cache key
  follows the specs and the schedules; a padded point with both armed
  equals its unpadded run.

The reference's ``run_plan`` imports lazily, so it runs inside
``reference_modules()``.
"""
import dataclasses
import pickle

import numpy as np
import pytest

from _torch_reference import load_reference, reference_modules

import torch

from repro_torch import core as tcore
from repro_torch import netsim as tnet
from repro_torch import workload as twl
from repro_torch.netsim import counters, engine
from repro_torch.netsim import experiment as texp

REF = load_reference()
rcore = REF["repro.core"]
rnet = REF["repro.netsim"]
rwl = REF["repro.workload"]
rexp = REF["repro.netsim.experiment"]

DT = 2e-5
DEV = "cpu"
SIDES = {"ref": (rcore, rnet, rwl, rexp), "port": (tcore, tnet, twl, texp)}
RED_ECN = dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2)
# Tier B: mean iteration time per job, port against reference, over the
# 0.06 s plan (three iterations a job); measured 0 on the CPU, the bound
# leaves room for one flipped loss draw (test_torch_engine's Tier B bound)
MEAN_ITER_RTOL = 0.02


def _proto(core, algo=0, variant=1, **kw):
    return core.MLTCPConfig(cc=core.CCParams(algo=algo, variant=variant,
                                             tick_dt=DT, rtt=100e-6),
                            slope=1.75, intercept=0.25, **kw)


def _simple(side, n_jobs=2, sim_time=0.06, seed=3, variant=1, proto=None,
            compute=0.0075, **kw):
    core, net, _, _ = SIDES[side]
    return net.SimConfig(
        topo=net.dumbbell(n_jobs, sockets_per_job=2),
        jobs=net.JobSpec.simple([compute] * n_jobs, [25e6] * n_jobs,
                                **kw.pop("job_kw", {})),
        protocol=proto or _proto(core, variant=variant),
        sim_time=sim_time, dt=DT, seed=seed, **kw)


def _suite_cfg(side, topo, profiles, algo, variant, sim_time=0.06,
               scale=0.25, **kw):
    """benchmarks/common.build_cfg at WORK_SCALE 0.25 (or ``scale``)."""
    core, net, wl, _ = SIDES[side]
    slope, intercept = {0: (1.75, 0.25), 2: (1.067, 0.267)}[algo]
    proto = core.MLTCPConfig(
        cc=core.CCParams(algo=algo, variant=variant, tick_dt=DT, rtt=100e-6),
        slope=slope, intercept=intercept)
    red = RED_ECN if algo == 2 else dict(red_qmin=150e3, red_qmax=1.5e6,
                                         red_pmax=0.12)
    return net.SimConfig(
        topo=topo, jobs=wl.jobspec_from_profiles(
            [p.scaled(scale) for p in profiles]),
        protocol=proto, sim_time=sim_time, dt=DT, seed=1, **{**red, **kw})


# ---------------------------------------------------------------------------
# the plans, each built the same way in both packages
# ---------------------------------------------------------------------------

def plan_fig10(side, algo=0, job_counts=(2, 3, 4, 5, 6), seeds=(1, 2)):
    _, net, wl, _ = SIDES[side]

    def build(pt):
        n = pt["n_jobs"]
        return _suite_cfg(side, net.dumbbell(n, sockets_per_job=2),
                          [wl.profile_for("gpt2")] * n, algo,
                          {"OFF": 0, "WI": 1}[pt["variant"]])
    return net.Plan(name=f"fig10-{algo}", build=build, axes=(
        net.Axis("variant", ("OFF", "WI")), net.Axis("n_jobs", job_counts),
        net.Axis("seed", seeds)))


def plan_fig12(side, probs=(0.0, 0.05, 0.10, 0.20, 0.30), seeds=(1, 2)):
    _, net, wl, _ = SIDES[side]
    topo = net.dumbbell(2, sockets_per_job=2)
    profs = [wl.profile_for("gpt2")] * 2
    sched, _ = wl.cassini_schedule(topo, [p.scaled(0.25) for p in profs])

    def build(pt):
        return _suite_cfg(side, topo, profs, 2,
                          1 if pt["scheme"] == "mlqcn" else 0,
                          cassini=sched if pt["scheme"] == "cassini"
                          else None)
    return net.Plan(name="fig12", build=build, axes=(
        net.Axis("p", probs, field="straggle_prob"),
        net.Axis("scheme", ("base", "mlqcn", "cassini")),
        net.Axis("seed", seeds)))


def plan_jobs(side, variants=("WI",), job_counts=(2, 3, 4), seeds=(3,),
              sim_time=0.06):
    _, net, _, _ = SIDES[side]

    def build(pt):
        return _simple(side, n_jobs=pt["n_jobs"], sim_time=sim_time,
                       variant={"OFF": 0, "WI": 1}[pt["variant"]])
    return net.Plan(name="jobs", build=build, axes=(
        net.Axis("variant", variants), net.Axis("n_jobs", job_counts),
        net.Axis("seed", seeds)))


def plan_mismatch(side):
    """Start offsets are structural: no merge."""
    _, net, _, _ = SIDES[side]

    def build(pt):
        n = pt["n_jobs"]
        return _simple(side, n_jobs=n, job_kw=dict(
            start_offset=[0.002] * n if n == 3 else None))
    return net.Plan(name="mismatch", build=build,
                    axes=(net.Axis("n_jobs", (2, 3)),))


def plan_values(side):
    """Workload values ride the sweep: one group."""
    _, net, _, _ = SIDES[side]

    def build(pt):
        n = pt["n_jobs"]
        return _simple(side, n_jobs=n, compute=0.0075 if n == 3 else 0.009,
                       job_kw=dict(straggle_prob=[0.05 * (n == 3)] * n))
    return net.Plan(name="values", build=build,
                    axes=(net.Axis("n_jobs", (2, 3)),))


def plan_f_spec(side):
    """A static F-family axis splits; slope and seed ride the sweep."""
    core, net, _, _ = SIDES[side]
    return net.Plan(name="axes", build=lambda pt: _simple(
        side, proto=_proto(core, f_spec=pt["f_spec"])), axes=(
        net.Axis("f_spec", ("F1", "F5")), net.Axis("slope", (0.5, 1.75)),
        net.Axis("seed", (0, 1))))


def _solo_mask(v):
    if v == "all":
        return np.ones((2,), bool)
    m = np.zeros((2,), bool)
    m[v] = True
    return m


def plan_solo(side):
    _, net, _, _ = SIDES[side]
    return net.Plan(name="solo", build=lambda pt: _simple(side), axes=(
        net.Axis("solo", ("all", 0, 1), field="job_active",
                 resolve=_solo_mask),))


def plan_where(side):
    _, net, _, _ = SIDES[side]
    return net.Plan(name="where", build=lambda pt: _simple(side),
                    axes=(net.Axis("a", (0, 1)), net.Axis("seed", (0, 1))),
                    where=lambda pt: not (pt["a"] == 1 and pt["seed"] == 1))


def plan_factors(side, f_spec="F3"):
    """Static factors on some points: under a non-default F the adaptive
    sentinel may not reach the kernel, so presence splits the group."""
    core, net, _, _ = SIDES[side]
    kw = {"use_pallas_kernel": True} if side == "ref" else {}

    def build(pt):
        return _simple(side, proto=_proto(core, variant=2, f_spec=f_spec),
                       static_job_factors=(np.asarray([0.6, 1.4])
                                           if pt["scheme"] == "static"
                                           else None), **kw)
    return net.Plan(name="factors", build=build, axes=(
        net.Axis("scheme", ("static", "mltcp", "static2")),
        net.Axis("seed", (0, 1))))


def _gauntlet(net, cfg, label):
    """benchmarks/churn.py's two schedules on ``cfg``'s fabric (the churned
    job and the blackholed flow exist on every fabric of the plans)."""
    t = cfg.sim_time
    churn_job, bh_job, arr, dep, rearr, bh, flap = {
        "gauntlet": (2, 0, 0.08, 0.30, 0.38, (0.18, 0.22),
                     (0.50, 0.64, 0.88)),
        "staggered": (1, 0, 0.10, 0.32, 0.40, (0.20, 0.24),
                      (0.52, 0.66, 0.9))}[label]
    churn_job = min(churn_job, cfg.jobs.n_jobs - 1)
    flows = np.nonzero(np.asarray(cfg.topo.flow_to_job) == bh_job)[0]
    return [net.job_departs(0.0, churn_job),
            net.job_arrives(arr * t, churn_job),
            net.job_departs(dep * t, churn_job),
            net.job_arrives(rearr * t, churn_job),
            net.link_flap(flap[0] * t, flap[1] * t, 0, flap[2]),
            net.blackhole(bh[0] * t, bh[1] * t, [int(flows[0])])]


def _fault_spec(net):
    return net.FaultSpec(n_events=8, churn=True, link_flaps=True,
                         blackholes=True)


def _churn_telemetry(net):
    return net.TelemetrySpec(
        probes=("interleave_overlap", "job_iter"),
        detectors=("interleave", "iter_sketch", "reinterleave"),
        overlap_threshold=0.8, stride=20)


def plan_fig5(side):
    """benchmarks/timeline.py's grid (telemetry stamped by run_plan)."""
    _, net, wl, _ = SIDES[side]

    def build(pt):
        algo = {"reno": 0, "dcqcn": 2}[pt["algo"]]
        return _suite_cfg(side, net.dumbbell(2, sockets_per_job=2 - algo // 2),
                          [wl.profile_for("gpt2")] * 2, algo,
                          {"OFF": 0, "WI": 1}[pt["variant"]])
    return net.Plan(name="fig5", build=build, axes=(
        net.Axis("algo", ("reno", "dcqcn")),
        net.Axis("variant", ("OFF", "WI")), net.Axis("seed", (1, 2))))


def plan_churn(side, job_counts=(3,), sim_time=0.06, scale=0.25):
    """benchmarks/churn.py's grid: the schedule a ``field="*"`` axis
    resolving, per point config, to the schedule's sweep overrides; with
    several job counts, padded fabrics and padded fault tables."""
    _, net, wl, _ = SIDES[side]

    def build(pt):
        algo = {"reno": 0, "dcqcn": 2}[pt["algo"]]
        n = pt["n_jobs"]
        return _suite_cfg(side, net.dumbbell(n, sockets_per_job=2 - algo // 2,
                                             cap_gbps=100.0),
                          [wl.profile_for("gpt2")] * n, algo,
                          {"OFF": 0, "WI": 1}[pt["variant"]],
                          sim_time=sim_time, scale=scale,
                          faults=_fault_spec(net),
                          telemetry=_churn_telemetry(net))

    def schedule(label):
        return lambda cfg: net.fault_schedule(
            cfg, _gauntlet(net, cfg, label),
            spec=_fault_spec(net)).overrides()
    return net.Plan(name="churn", build=build, axes=(
        net.Axis("algo", ("reno", "dcqcn")),
        net.Axis("variant", ("OFF", "WI")), net.Axis("n_jobs", job_counts),
        net.Axis("schedule", ("gauntlet", "staggered"), field="*",
                 resolve=schedule),
        net.Axis("seed", (1, 2))))


def plan_phases(side):
    """Two-tier jobs whose phase counts differ (P = 1 and 4): the smaller
    point joins the larger fabric's group, column-padded to P_max."""
    _, net, wl, _ = SIDES[side]
    profs = [wl.profile_for("gpt2"), wl.profile_for("gpt2"),
             wl.profile_for("gpt3_hybrid")]
    pairs = [(0, 1), (2, 1), (3, 1)]

    def build(pt):
        n = pt["n_jobs"]
        return _suite_cfg(side, net.two_tier(pairs[:n], sockets_per_job=2),
                          profs[:n], 0, 1)
    return net.Plan(name="phases", build=build,
                    axes=(net.Axis("n_jobs", (2, 3)),
                          net.Axis("seed", (1, 2))))


PLANS = {
    "fig10-reno": (plan_fig10, {}),
    "fig10-dcqcn": (lambda side: plan_fig10(side, algo=2), {}),
    "fig12": (plan_fig12, {}),
    "jobs": (plan_jobs, {}),
    "jobs-exact": (plan_jobs, {"pad_jobs": False}),
    "mismatch": (plan_mismatch, {}),
    "values": (plan_values, {}),
    "values-exact": (plan_values, {"pad_jobs": False}),
    "f_spec": (plan_f_spec, {}),
    "solo": (plan_solo, {}),
    "where": (plan_where, {}),
    "factors-F3": (plan_factors, {}),
    "factors-linear": (lambda side: plan_factors(side, "linear"), {}),
    "phases": (plan_phases, {}),
    "fig5-telemetry": (plan_fig5, lambda side: {"telemetry": SIDES[side][
        1].TelemetrySpec(probes=("flow_cwnd", "job_incomm",
                                 "interleave_overlap"), stride=75)}),
    "churn": (plan_churn, {}),
    "churn-padded": (lambda side: plan_churn(side, job_counts=(2, 3)), {}),
}


def _grouping(side, name):
    make, kw = PLANS[name]
    plan = make(side)
    kw = kw(side) if callable(kw) else kw
    points, cfgs, overrides, groups = SIDES[side][3].resolve_plan(plan, **kw)
    summary = [(g.idxs, g.masked, g.factors, g.cassini, g.cfg.jobs.n_jobs,
                g.cfg.topo.n_flows, g.cfg.jobs.compute.shape[1])
               for g in groups]
    return points, cfgs, overrides, groups, summary


EXPECTED_GROUPS = {"fig10-reno": 2, "fig10-dcqcn": 2, "fig12": 2, "jobs": 1,
                   "jobs-exact": 3, "mismatch": 2, "values": 1,
                   "values-exact": 2, "f_spec": 2, "solo": 1, "where": 1,
                   "factors-F3": 2, "factors-linear": 1, "phases": 1,
                   "fig5-telemetry": 4, "churn": 4, "churn-padded": 4}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_grouping_equals_the_reference(name):
    rp, _, _, _, want = _grouping("ref", name)
    tp, _, _, _, got = _grouping("port", name)
    assert tp == rp
    assert got == want
    assert len(got) == EXPECTED_GROUPS[name]


@pytest.mark.parametrize("name", ["fig10-reno", "fig12", "solo", "phases",
                                  "factors-F3", "churn-padded"])
def test_group_sweeps_equal_the_reference(name):
    """Every stacked sweep leaf, value for value (the reference's float64
    configs round to float32 the same way in both)."""
    _, rcfgs, rov, rgroups, _ = _grouping("ref", name)
    _, tcfgs, tov, tgroups, _ = _grouping("port", name)
    for rg, tg in zip(rgroups, tgroups):
        with reference_modules():
            want = rexp.group_sweep(rcfgs, rov, rg)
        got = texp.group_sweep(tcfgs, tov, tg, device=DEV)
        for field in tnet.SweepParams._fields:
            w, g = getattr(want, field), getattr(got, field)
            assert (w is None) == (g is None), field
            if w is not None:
                assert g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=field)


def test_sweep_of_equals_the_reference():
    cfgs = []
    for side in ("ref", "port"):
        net = SIDES[side][1]
        cfgs.append(_simple(side, static_job_factors=np.asarray([0.6, -1.0]),
                            cassini=net.CassiniSchedule(
                                offset=np.asarray([0.0, 0.004]),
                                period=np.asarray([0.01, 0.02]), eps=1e-3)))
    want = rnet.sweep_of(cfgs[0])
    got = tnet.sweep_of(cfgs[1], device=DEV)
    for field in tnet.SweepParams._fields:
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert g.dtype == engine._FIELD_DTYPE.get(field, torch.float32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=field)


def test_restrict_workload_round_trips():
    cfg4, cfg2 = _simple("port", n_jobs=4), _simple("port", n_jobs=2)
    topo_r, jobs_r = tnet.restrict_workload(cfg4.topo, cfg4.jobs, 2)
    assert texp._same_workload(topo_r, jobs_r, cfg2.topo, cfg2.jobs)
    assert not texp._same_workload(topo_r, jobs_r, cfg4.topo, cfg4.jobs)
    rcfg4 = _simple("ref", n_jobs=4)
    rtopo, rjobs = rnet.restrict_workload(rcfg4.topo, rcfg4.jobs, 2)
    for a, b in ((topo_r, rtopo), (jobs_r, rjobs)):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                          np.asarray(getattr(b, f.name)))


# ---------------------------------------------------------------------------
# running plans
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if tree is None:
        return []
    return [x for v in tree for x in _leaves(v)]


def test_padded_point_equals_unpadded_run_bitwise():
    """A job-count point run on the group's padded fabric equals the same
    point alone on its own fabric, on every leaf of the output (the padded
    leaves cut to the active jobs and flows, which are their prefix)."""
    plan = plan_jobs("port", job_counts=(2, 3), seeds=(3, 4), sim_time=0.02)
    _, cfgs, overrides, groups = texp.resolve_plan(plan)
    (group,) = groups
    assert group.masked and group.cfg.jobs.n_jobs == 3
    padded = tnet.simulate_sweep(
        group.cfg, texp.group_sweep(cfgs, overrides, group, device=DEV),
        device=DEV)
    slot = group.idxs.index(1)                  # n_jobs=2, seed=4
    alone = tnet.simulate_sweep(
        cfgs[1], tnet.make_sweep(cfgs[1], device=DEV, seed=[4]), device=DEV)
    got = [x[slot] for x in _leaves(padded)]
    want = [x[0] for x in _leaves(alone)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.ndim == w.ndim and g.dtype == w.dtype, i
        g = np.array(g[tuple(slice(0, s) for s in w.shape)])
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.array_equal(g.reshape(-1).view(np.uint8),
                              np.array(w).reshape(-1).view(np.uint8)), \
            f"leaf {i} differs"


def test_run_plan_matches_the_reference():
    """Tier B: the same 0.06 s plan (OFF/WI x 2-4 jobs) through both
    run_plans: the same groups, iteration counts exact, mean iteration
    times within MEAN_ITER_RTOL."""
    with reference_modules():
        want = rnet.run_plan(plan_jobs("ref", variants=("OFF", "WI")),
                             shard=False)
    w = counters.CounterWatch()
    got = tnet.run_plan(plan_jobs("port", variants=("OFF", "WI")),
                        device=DEV)
    assert got.n_compile_groups == want.n_compile_groups == 2
    assert w.traces == 2 and w.fallbacks == 0 and w.launches == 0
    assert got.n_kernel_fallbacks == 0 and got.n_kernel_launches == 0
    assert [g.n_points for g in got.profile.groups] == [3, 3]
    assert all(g.trace_s == 0.0 and g.compile_s == 0.0 and g.execute_s > 0
               and g.device_bytes is None and g.cost_envelope is None
               for g in got.profile.groups)
    assert got.n_ticks == want.n_ticks
    for g, r in zip(got, want):
        assert g.point.axes == r.point.axes
        assert g.n_jobs == r.n_jobs == g.point["n_jobs"]
        assert [len(x) for x in g.iter_times] == \
            [len(x) for x in r.iter_times]
        for gx, rx in zip(g.iter_times, r.iter_times):
            assert gx.size > 0
            np.testing.assert_allclose(np.mean(gx), np.mean(rx),
                                       rtol=MEAN_ITER_RTOL)
        assert g.point.params.job_active is not None


def _tiny_plan(job_counts=(2, 3), seeds=(0, 1)):
    return plan_jobs("port", job_counts=job_counts, seeds=seeds,
                     sim_time=0.004)


def test_cache_resumes_and_prunes(tmp_path):
    cache = str(tmp_path / "plan-cache")
    plan = _tiny_plan()
    fresh = tnet.run_plan(plan, device=DEV, cache_dir=cache)
    assert fresh.n_cache_hits == 0 and fresh.n_compile_groups == 1
    w = counters.CounterWatch()
    rerun = tnet.run_plan(plan, device=DEV, cache_dir=cache)
    assert rerun.n_cache_hits == len(rerun) == 4
    assert rerun.n_compile_groups == 0 and w.traces == 0
    for a, b in zip(fresh, rerun):
        assert a.point.axes == b.point.axes
        for ja, jb in zip(a.iter_times, b.iter_times):
            assert np.array_equal(ja, jb)
        np.testing.assert_array_equal(a.trace_incomm, b.trace_incomm)
    entries = sorted((tmp_path / "plan-cache").glob("*.pkl"))
    assert len(entries) == 4
    assert all(p.name.startswith("torch-v2-") for p in entries)
    # a deleted entry re-simulates just that point; a corrupt one is
    # quarantined (warned once) and re-simulated
    entries[0].unlink()
    entries[1].write_bytes(b"not a pickle")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        partial = tnet.run_plan(plan, device=DEV, cache_dir=cache)
    assert partial.n_cache_hits == 2 and partial.n_compile_groups == 1
    assert (tmp_path / "plan-cache" / (entries[1].name + ".corrupt")).exists()
    # pruning: other schemas (the reference's ``v2-`` entries), torn and
    # quarantined files and zero-byte entries go; healthy entries stay
    for name in ("v2-abc.pkl", "x.pkl.tmp", "torch-v2-empty.pkl"):
        (tmp_path / "plan-cache" / name).write_bytes(b"")
    (tmp_path / "plan-cache" / "v2-full.pkl").write_bytes(pickle.dumps(1))
    assert tnet.prune_cache(cache) == 5
    assert len(list((tmp_path / "plan-cache").iterdir())) == 4
    assert tnet.prune_cache(str(tmp_path / "missing")) == 0


def test_cache_key_of_another_package_never_matches():
    cfg = _simple("port")
    key = texp._point_cache_key(cfg, {"seed": 1})
    assert texp._cache_path("d", key).endswith(f"torch-v2-{key}.pkl")
    assert key != rexp._point_cache_key(_simple("ref"), {"seed": 1})
    # a tensor override keys as its numpy array
    assert key == texp._point_cache_key(cfg, {"seed": torch.tensor(1)})


def test_cache_key_nan_axes_do_not_collide():
    cfg = _simple("port")
    a = np.array([np.nan, 1.0, 2.0])
    b = np.array([1.0, np.nan, 2.0])
    k_a = texp._point_cache_key(cfg, {"x": a})
    assert k_a != texp._point_cache_key(cfg, {"x": b})
    assert k_a == texp._point_cache_key(cfg, {"x": a.copy()})


def test_cache_key_nan_bit_patterns_canonicalize():
    cfg = _simple("port")
    a = np.array([np.nan, 3.0])
    b = a.copy()
    b.view(np.uint64)[0] |= 0xDEAD          # poke payload bits, still NaN
    assert np.isnan(b[0]) and a.tobytes() != b.tobytes()
    assert (texp._point_cache_key(cfg, {"x": a})
            == texp._point_cache_key(cfg, {"x": b}))
    assert (texp._point_cache_key(cfg, {"x": float("nan")})
            == texp._point_cache_key(cfg, {"x": np.float64("nan")}))


def test_cache_key_inf_signs_distinct():
    cfg = _simple("port")
    assert (texp._point_cache_key(cfg, {"x": float("inf")})
            != texp._point_cache_key(cfg, {"x": float("-inf")}))


def test_cache_key_rejects_object_leaves():
    with pytest.raises(TypeError, match="object"):
        texp._point_cache_key(
            _simple("port"),
            {"x": np.array([object(), object()], dtype=object)})


def test_where_prunes_points_and_select_pivots():
    pr = tnet.run_plan(tnet.Plan(
        name="where", build=lambda pt: _simple("port", sim_time=0.004),
        axes=(tnet.Axis("a", (0, 1)), tnet.Axis("seed", (0, 1))),
        where=lambda pt: not (pt["a"] == 1 and pt["seed"] == 1)),
        device=DEV)
    assert len(pr) == 3 and pr.n_compile_groups == 1
    with pytest.raises(KeyError):
        pr.select(a=1, seed=1)
    assert pr[0].point.matches(a=0) and not pr[0].point.matches(bogus=1)
    assert {k: len(v) for k, v in pr.group_by("a").items()} == \
        {(0,): 2, (1,): 1}
    (res,) = pr.select(a=1, seed=0)
    assert int(res.point.params.seed) == 0
    assert pr.n_ticks == sum(r.cfg.n_ticks for r in pr)


def test_plan_validation():
    with pytest.raises(ValueError, match="duplicate axis"):
        tnet.Plan(name="dup", build=lambda pt: _simple("port"),
                  axes=(tnet.Axis("a", (1,)), tnet.Axis("a", (2,))))
    with pytest.raises(ValueError, match="no values"):
        tnet.Axis("empty", ())
    with pytest.raises(ValueError, match="unknown kind"):
        tnet.Axis("a", (1,), kind="bogus")
    with pytest.raises(ValueError, match="has no points"):
        tnet.Plan(name="none", build=lambda pt: _simple("port"),
                  axes=(tnet.Axis("a", (1,)),),
                  where=lambda pt: False).points()
    with pytest.raises(ValueError, match="unknown sweep field"):
        tnet.run_plan(tnet.Plan(
            name="bad-field", build=lambda pt: _simple("port"),
            axes=(tnet.Axis("a", (1,), kind="dynamic"),)), device=DEV)
    with pytest.raises(ValueError, match="unknown sweep field"):
        tnet.run_plan(tnet.Plan(
            name="bad-star", build=lambda pt: _simple("port"),
            axes=(tnet.Axis("s", (1,), field="*",
                            resolve=lambda v: {"bogus": v}),)), device=DEV)
    with pytest.raises(ValueError, match="must resolve to a dict"):
        tnet.run_plan(tnet.Plan(
            name="bad-star", build=lambda pt: _simple("port"),
            axes=(tnet.Axis("s", (1,), field="*"),)), device=DEV)


def test_not_ported_options_name_their_roadmap_items():
    """Telemetry and fault axes are ported (ROADMAP items 10 and 11): a
    telemetry that is not a spec raises, and fault leaves on a config
    without ``faults`` do, naming what is missing."""
    plan = _tiny_plan()
    with pytest.raises(TypeError, match="TelemetrySpec"):
        tnet.run_plan(plan, device=DEV, telemetry=object())
    with pytest.raises(TypeError, match="TelemetrySpec"):
        texp.resolve_plan(plan, telemetry=object())
    fault_axis = tnet.Axis("when", (1,), field="fault_tick")
    assert fault_axis.is_dynamic()
    for axis in (fault_axis, tnet.Axis("sched", ("a",), field="*",
                                       resolve=lambda v: {"fault_tick": 1})):
        with pytest.raises(ValueError, match="needs cfg.faults"):
            tnet.run_plan(tnet.Plan(name="faults", axes=(axis,),
                                    build=lambda pt: _simple("port")),
                          device=DEV)


def test_star_axis_and_callable_resolve():
    """``field="*"`` sets several sweep fields from one label, also through
    a callable of the point's config."""
    plan = tnet.Plan(name="star", build=lambda pt: _simple("port"), axes=(
        tnet.Axis("knobs", ("a", "b"), field="*", resolve=lambda v: (
            {"slope": 0.5, "seed": 7} if v == "a" else
            (lambda cfg: {"straggle_prob": [0.1] * cfg.jobs.n_jobs}))),))
    points, cfgs, overrides, groups = texp.resolve_plan(plan)
    assert len(groups) == 1
    sweep = texp.group_sweep(cfgs, overrides, groups[0], device=DEV)
    np.testing.assert_array_equal(sweep.slope.numpy(), np.float32([0.5, 1.75]))
    np.testing.assert_array_equal(sweep.seed.numpy(), [7, 3])
    np.testing.assert_array_equal(sweep.straggle_prob.numpy(),
                                  np.float32([[0, 0], [0.1, 0.1]]))


def test_keep_going_records_a_failing_group():
    """A group that raises leaves its points empty and the others run."""
    def build(pt):
        cfg = _simple("port", n_jobs=2, sim_time=0.004,
                      variant={"OFF": 0, "WI": 1}[pt["variant"]])
        if pt["variant"] == "OFF":      # a tick_dt the engine refuses
            cfg = dataclasses.replace(cfg, dt=1e-5)
        return cfg
    plan = tnet.Plan(name="poisoned", build=build,
                     axes=(tnet.Axis("variant", ("OFF", "WI")),))
    with pytest.raises(ValueError, match="tick_dt"):
        tnet.run_plan(plan, device=DEV)
    pr = tnet.run_plan(plan, device=DEV, keep_going=True)
    assert pr.results[0] is None and pr.results[1] is not None
    (err,) = pr.group_errors
    assert err.point_labels == ["variant=OFF"] and "tick_dt" in err.error
    assert err.signature.startswith("jobs=2 flows=4 algo=0")
    assert len(pr.select(variant="WI")) == 1


def test_counters_and_shard_on_the_cpu():
    """The counters count runs and CC fallbacks (an F family the kernel
    does not take, on the CPU's plain path: one per tick); ``shard``
    changes nothing with no card."""
    plan = tnet.Plan(name="fallback", build=lambda pt: _simple(
        "port", sim_time=0.004, proto=_proto(tcore, f_spec="F1")),
        axes=(tnet.Axis("seed", (0, 1)),))
    with counters.watch(reset_warnings=True) as w:
        with pytest.warns(UserWarning, match="f_spec='F1'"):
            pr = tnet.run_plan(plan, device=DEV, shard=True)
    assert w.traces == 1 and pr.n_compile_groups == 1
    assert pr.n_kernel_fallbacks == w.fallbacks == 200
    _, cfgs, overrides, groups = texp.resolve_plan(plan)
    sweep = texp.group_sweep(cfgs, overrides, groups[0], device=DEV)
    for shard in ("auto", True, False):
        assert texp._shard_sweep(sweep, 2, shard) == (sweep, 2)
    summary = pr.profile.summary()
    assert summary["n_groups"] == 1 and summary["trace_s"] == 0.0


# ---------------------------------------------------------------------------
# telemetry and faults on plans
# ---------------------------------------------------------------------------

def test_cache_key_follows_telemetry_and_faults():
    cfg = _simple("port")
    spec = tnet.TelemetrySpec(stride=50)
    keys = {texp._point_cache_key(c, ov) for c, ov in (
        (cfg, {}),
        (dataclasses.replace(cfg, telemetry=spec), {}),
        (dataclasses.replace(cfg, telemetry=tnet.TelemetrySpec(stride=51)),
         {}),
        (dataclasses.replace(cfg, faults=_fault_spec(tnet)), {}))}
    assert len(keys) == 4
    faulted = dataclasses.replace(cfg, faults=_fault_spec(tnet), sim_time=1.0)
    a, b = (tnet.fault_schedule(faulted, _gauntlet(tnet, faulted, label),
                                spec=_fault_spec(tnet)).overrides()
            for label in ("gauntlet", "staggered"))
    assert (texp._point_cache_key(faulted, a)
            != texp._point_cache_key(faulted, b))
    assert texp._point_cache_key(faulted, a) == texp._point_cache_key(
        faulted, {k: v.copy() for k, v in a.items()})


def test_padded_point_equals_unpadded_run_with_telemetry_and_faults():
    """A 2-job point of the padded churn plan (telemetry and faults armed,
    its fault tables padded to the 3-job fabric) equals the point run
    alone: every non-telemetry leaf on its active jobs and flows, and the
    collected telemetry (the pair EWMAs are indexed by pairs, so they are
    compared through what they yield)."""
    plan = plan_churn("port", job_counts=(2, 3), sim_time=0.03, scale=0.05)
    points, cfgs, overrides, groups = texp.resolve_plan(plan)
    i = next(i for i, pt in enumerate(points)
             if pt["n_jobs"] == 2 and pt["algo"] == "reno"
             and pt["variant"] == "WI" and pt["schedule"] == "staggered")
    group = next(g for g in groups if i in g.idxs)
    assert group.masked and group.cfg.jobs.n_jobs == 3
    padded = tnet.simulate_sweep(
        group.cfg, texp.group_sweep(cfgs, overrides, group, device=DEV),
        device=DEV)
    slot = group.idxs.index(i)
    alone = tnet.simulate_sweep(cfgs[i], tnet.make_sweep(
        cfgs[i], device=DEV, **overrides[i]), device=DEV)
    strip = dict(telemetry=None)
    got = [x[slot] for x in _leaves(padded._replace(
        final_state=padded.final_state._replace(**strip), **strip))]
    want = [x[0] for x in _leaves(alone._replace(
        final_state=alone.final_state._replace(**strip), **strip))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)[tuple(slice(0, n) for n in w.shape)]
        assert np.array_equal(np.array(g).reshape(-1).view(np.uint8),
                              np.array(w).reshape(-1).view(np.uint8))
    rp = tnet.postprocess(cfgs[i], engine.point_of(padded, slot), n_jobs=2)
    ra = tnet.postprocess(cfgs[i], engine.point_of(alone, 0))
    tp, ta = rp.telemetry, ra.telemetry
    assert np.array_equal(tp.ticks, ta.ticks)
    for name in ta.series:
        assert np.array_equal(tp.series[name], ta.series[name]), name
    assert np.array_equal(tp.iter_hist, ta.iter_hist)
    for f in ("time_to_interleave_s", "interleave_stability", "converged"):
        assert getattr(tp, f) == getattr(ta, f), f
    assert tp.fault_events == ta.fault_events
    assert int(np.asarray(alone.iter_counts).sum()) > 0


def test_telemetry_plan_matches_the_reference():
    """run_plan(telemetry=) through both packages on a short churn plan
    (reno, WI, one schedule): the same groups, iteration counts exact, the
    re-interleave reports' windows equal."""
    def plan(side):
        _, net, _, _ = SIDES[side]
        full = plan_churn(side, sim_time=0.06)
        return net.Plan(name="churn-short", build=full.build,
                        axes=tuple(ax for ax in full.axes if ax.name != "algo"
                                   and ax.name != "variant"
                                   and ax.name != "seed")
                        + (net.Axis("algo", ("reno",)),
                           net.Axis("variant", ("WI",)),
                           net.Axis("seed", (1,))))
    with reference_modules():
        want = rnet.run_plan(plan("ref"), shard=False)
    got = tnet.run_plan(plan("port"), device=DEV)
    assert got.n_compile_groups == want.n_compile_groups == 1
    for g, r in zip(got, want):
        assert g.point.axes == r.point.axes
        assert [len(x) for x in g.iter_times] == \
            [len(x) for x in r.iter_times]
        assert [e.start_tick for e in g.telemetry.fault_events] == \
            [e.start_tick for e in r.telemetry.fault_events]
