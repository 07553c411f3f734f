"""The port's fault injection (`repro_torch.netsim.faults`) against the JAX
reference's, and its engine hooks.

* Tier A: `schedule()` builds the same event tables as the reference
  (ints and bools exactly; the float tables are products of python floats
  rounded once to float32, so exactly too) for the churn gauntlet's
  schedules and for overlapping flaps, and raises the same validation
  errors.
* Faults armed with the identity schedule are a bitwise no-op on every
  leaf of the output, for Reno, CUBIC and DCQCN.
* The channels do what they claim (the reference's tests/test_faults.py
  behaviours, on the port): churn freezes a job and resumes it, a
  blackhole stalls only its job, a flap stretches iterations, a straggle
  burst slows progress.
* Tier B: one faulted Reno WI run through both packages: iteration counts
  equal, mean iteration times within ``MEAN_ITER_RTOL``.
"""
import dataclasses

import numpy as np
import pytest

from _torch_reference import load_reference

import torch

from repro_torch import core as tcore
from repro_torch import netsim as tnet
from repro_torch.netsim import engine

REF = load_reference()
rcore = REF["repro.core"]
rnet = REF["repro.netsim"]
SIDES = {"ref": (rcore, rnet), "port": (tcore, tnet)}
DT = 2e-5
DEV = "cpu"
# Tier B: mean iteration time per job, port against reference, over a
# 0.06 s faulted run; measured equal on the CPU, the bound leaves room for
# one flipped loss draw (test_torch_engine's Tier B bound)
MEAN_ITER_RTOL = 0.02
ALL_SPEC = dict(n_events=4, churn=True, link_flaps=True, blackholes=True,
                straggle_bursts=True)


def _cfg(side, n_jobs=2, sim_time=0.02, algo=0, variant=1, compute=0.002,
         comm=2e6, **kw):
    core, net = SIDES[side]
    red = (dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2) if algo == 2
           else {})
    return net.SimConfig(
        topo=net.dumbbell(n_jobs, sockets_per_job=2),
        jobs=net.JobSpec.simple([compute] * n_jobs, [comm] * n_jobs),
        protocol=core.MLTCPConfig(cc=core.CCParams(
            algo=algo, variant=variant, tick_dt=DT, rtt=100e-6),
            slope=1.75, intercept=0.25),
        sim_time=sim_time, dt=DT, seed=3, **{**red, **kw})


def _gauntlet(net, cfg, label):
    """benchmarks/churn.py's two schedules on ``cfg``'s fabric."""
    t = cfg.sim_time
    churn_job, bh_job, arr, dep, rearr, bh, flap = {
        "gauntlet": (2, 0, 0.08, 0.30, 0.38, (0.18, 0.22),
                     (0.50, 0.64, 0.88)),
        "staggered": (1, 2, 0.10, 0.32, 0.40, (0.20, 0.24),
                      (0.52, 0.66, 0.9))}[label]
    flows = np.nonzero(np.asarray(cfg.topo.flow_to_job) == bh_job)[0]
    return [net.job_departs(0.0, churn_job), net.job_arrives(arr * t, churn_job),
            net.job_departs(dep * t, churn_job),
            net.job_arrives(rearr * t, churn_job),
            net.link_flap(flap[0] * t, flap[1] * t, 0, flap[2]),
            net.blackhole(bh[0] * t, bh[1] * t, [int(flows[0])])]


def _assert_tables_equal(got, want):
    assert got.spec.__dict__ == want.spec.__dict__
    assert list(got.values) == list(want.values)
    for name, w in want.values.items():
        g = got.values[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# Tier A: the event tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["gauntlet", "staggered"])
def test_gauntlet_tables_equal_the_reference(label):
    tables = {}
    for side in ("ref", "port"):
        _, net = SIDES[side]
        cfg = _cfg(side, n_jobs=3, sim_time=4.5)
        spec = net.FaultSpec(n_events=8, churn=True, link_flaps=True,
                             blackholes=True)
        tables[side] = net.fault_schedule(cfg, _gauntlet(net, cfg, label),
                                          spec=spec)
    _assert_tables_equal(tables["port"], tables["ref"])


def test_unpinned_and_overlapping_tables_equal_the_reference():
    """Overlapping flaps compose by multiplication, churn forward-fills, a
    straggle burst clips, and an unpinned schedule sizes its own spec."""
    def events(net):
        return [net.link_flap(0.1, 0.4, 0, 0.5), net.link_flap(0.2, 0.3, 0, 0.5),
                net.job_departs(0.1, 1), net.job_arrives(0.3, 1),
                net.straggle_burst(0.15, 0.35, 0.7),
                net.straggle_burst(0.2, None, 0.6, jobs=[0]),
                net.blackhole(0.05, 0.25, [1, 2])]
    got = tnet.fault_schedule(_cfg("port", sim_time=0.5), events(tnet))
    want = rnet.fault_schedule(_cfg("ref", sim_time=0.5), events(rnet))
    _assert_tables_equal(got, want)
    nested = tnet.fault_schedule(_cfg("port", sim_time=0.5), events(tnet)[:2])
    np.testing.assert_array_equal(nested.values["fault_link_scale"][:, 0],
                                  np.float32([1.0, 0.5, 0.25, 0.5, 1.0]))
    padded = tnet.fault_schedule(_cfg("port", sim_time=0.5), events(tnet),
                                 n_events=12)
    want = rnet.fault_schedule(_cfg("ref", sim_time=0.5), events(rnet),
                               n_events=12)
    _assert_tables_equal(padded, want)
    ident = tnet.identity_schedule(_cfg("port"), tnet.FaultSpec(**ALL_SPEC))
    _assert_tables_equal(ident, rnet.identity_schedule(
        _cfg("ref"), rnet.FaultSpec(**ALL_SPEC)))


@pytest.mark.parametrize("side", ["ref", "port"])
def test_validation_errors_match(side):
    _, net = SIDES[side]
    cfg = _cfg(side)
    with pytest.raises(ValueError, match="indexes 7"):
        net.fault_schedule(cfg, [net.job_departs(0.1, 7)])
    with pytest.raises(ValueError, match="does not arm"):
        net.fault_schedule(cfg, [net.job_departs(0.1, 1)],
                           spec=net.FaultSpec(n_events=4, link_flaps=True))
    with pytest.raises(ValueError, match="needs 5 event rows"):
        net.fault_schedule(cfg, [net.link_flap(0.1, 0.2, 0, 0.5),
                                 net.link_flap(0.3, 0.4, 0, 0.5)],
                           spec=net.FaultSpec(n_events=2, link_flaps=True))
    with pytest.raises(ValueError, match="empty"):
        net.link_flap(0.2, 0.2, 0, 0.5)
    with pytest.raises(ValueError, match=">= 0"):
        net.link_flap(0.1, 0.2, 0, -0.5)
    with pytest.raises(ValueError, match="at least one flow"):
        net.blackhole(0.1, 0.2, [])
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        net.straggle_burst(0.1, None, 1.5)
    with pytest.raises(ValueError, match="unknown fault channel"):
        net.FaultEvent("gremlin", 0.1, None, (), 1.0)
    with pytest.raises(ValueError, match="t=-1"):
        net.FaultEvent("link", -1.0, None, (0,), 1.0)
    with pytest.raises(ValueError, match="n_events >= 1"):
        net.FaultSpec(n_events=0)


def test_sweep_leaves_are_validated():
    cfg = _cfg("port")
    with pytest.raises(ValueError, match="needs cfg.faults"):
        tnet.simulate_sweep(cfg, tnet.make_sweep(cfg, device=DEV,
                                                 fault_tick=[0]), device=DEV)
    spec = tnet.FaultSpec(n_events=3, churn=True)
    armed = dataclasses.replace(cfg, faults=spec)
    sweep = tnet.make_sweep(armed, device=DEV)
    assert sweep.fault_tick.shape == (1, 3)
    assert sweep.fault_job_active.dtype == torch.bool
    assert sweep.fault_link_scale is None
    with pytest.raises(ValueError, match="needs cfg.faults"):
        tnet.simulate_sweep(cfg, sweep, device=DEV)
    with pytest.raises(ValueError, match="the sweep leaf is None"):
        tnet.simulate_sweep(armed, sweep._replace(fault_job_active=None),
                            device=DEV)
    with pytest.raises(ValueError, match="does not arm"):
        tnet.simulate_sweep(dataclasses.replace(
            cfg, faults=tnet.FaultSpec(n_events=3, link_flaps=True)), sweep,
            device=DEV)
    with pytest.raises(TypeError, match="FaultSpec"):
        tnet.simulate(dataclasses.replace(cfg, faults=object()), device=DEV)


# ---------------------------------------------------------------------------
# faults off is free
# ---------------------------------------------------------------------------

def _bitwise(a, b):
    la, lb = engine.tree_map(lambda x: x, a), engine.tree_map(lambda x: x, b)
    ta = [x for x in _flat(la)]
    tb = [x for x in _flat(lb)]
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, np.ndarray):
        return [torch.as_tensor(tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [x for v in tree for x in _flat(v)]


@pytest.mark.parametrize("algo", [0, 1, 2])
def test_identity_schedule_is_a_bitwise_noop(algo):
    """Every channel armed with the identity schedule (the default when no
    overrides arrive) runs bit for bit like ``faults=None``."""
    cfg = _cfg("port", algo=algo)
    off = tnet.simulate(cfg, device=DEV)
    armed = dataclasses.replace(cfg, faults=tnet.FaultSpec(**ALL_SPEC))
    on = tnet.simulate(armed, device=DEV)
    _bitwise(on, off)
    assert int(off.iter_counts.min()) >= 1


# ---------------------------------------------------------------------------
# the channels' behaviour (tests/test_faults.py's, on the port)
# ---------------------------------------------------------------------------

def _counts(cfg, schedules):
    """Iteration counts per point of one sweep whose points run under
    ``schedules`` (FaultSchedules of one spec)."""
    over = {f: np.stack([s.values[f] for s in schedules])
            for f in schedules[0].values}
    raw = tnet.simulate_sweep(cfg, tnet.make_sweep(
        cfg, device=DEV, seed=[3] * len(schedules), **over), device=DEV)
    return raw.iter_counts.numpy()


def test_churn_blackhole_and_flap_behave():
    spec = tnet.FaultSpec(n_events=3, churn=True, blackholes=True,
                          link_flaps=True)
    cfg = _cfg("port", sim_time=0.05, faults=spec)
    flows = [int(f) for f in
             np.nonzero(np.asarray(cfg.topo.flow_to_job) == 1)[0]]
    base, gone, holed, flapped = _counts(cfg, [
        tnet.identity_schedule(cfg, spec),
        tnet.fault_schedule(cfg, [tnet.job_departs(0.015, 1),
                                  tnet.job_arrives(0.03, 1)], spec=spec),
        tnet.fault_schedule(cfg, [tnet.blackhole(0.015, 0.03, flows)],
                            spec=spec),
        tnet.fault_schedule(cfg, [tnet.link_flap(0.01, 0.04, 0, 0.25)],
                            spec=spec)])
    # churn: job 1 loses about its absence window and keeps running
    # outside it; the survivor never slows down
    assert 0 < gone[1] < base[1] * 0.85
    assert gone[0] >= base[0]
    # a blackhole stalls its job only
    assert holed[1] < base[1] * 0.85
    assert holed[0] >= base[0] * 0.9
    # a quarter-capacity bottleneck stretches iterations
    assert flapped.sum() < base.sum() * 0.9


def test_straggle_burst_slows_progress():
    """An uncontended job under a prob-1.0 burst pays the straggle
    surcharge (5-10% of its isolated iteration time) every iteration."""
    spec = tnet.FaultSpec(n_events=3, straggle_bursts=True)
    cfg = _cfg("port", n_jobs=1, sim_time=0.08, faults=spec)
    base, bursty = _counts(cfg, [
        tnet.identity_schedule(cfg, spec),
        tnet.fault_schedule(cfg, [tnet.straggle_burst(0.0, None, 1.0)],
                            spec=spec)])
    assert bursty.sum() < base.sum() - 1


# ---------------------------------------------------------------------------
# Tier B: a faulted run through both packages
# ---------------------------------------------------------------------------

def test_faulted_trajectory_matches_reference():
    spec_kw = dict(n_events=9, churn=True, link_flaps=True, blackholes=True,
                   straggle_bursts=True)
    out = {}
    for side in ("ref", "port"):
        _, net = SIDES[side]
        cfg = _cfg(side, sim_time=0.06, compute=0.004, comm=10e6,
                   faults=net.FaultSpec(**spec_kw))
        t = cfg.sim_time
        sched = net.fault_schedule(cfg, [
            net.job_departs(0.3 * t, 1), net.job_arrives(0.6 * t, 1),
            net.link_flap(0.2 * t, 0.5 * t, 0, 0.5),
            net.blackhole(0.7 * t, 0.8 * t, [0]),
            net.straggle_burst(0.1 * t, None, 0.3)], spec=cfg.faults)
        if side == "ref":
            raw = net.simulate_sweep(cfg, net.make_sweep(
                cfg, **sched.overrides()))
            it, counts = np.asarray(raw.iter_times[0]), \
                np.asarray(raw.iter_counts[0])
        else:
            raw = net.simulate_sweep(cfg, net.make_sweep(
                cfg, device=DEV, **sched.overrides()), device=DEV)
            it, counts = raw.iter_times[0].numpy(), \
                raw.iter_counts[0].numpy()
        out[side] = (counts, [it[j, :counts[j]] for j in range(2)])
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    assert out["ref"][0].min() >= 2
    for got, want in zip(out["port"][1], out["ref"][1]):
        np.testing.assert_allclose(got.mean(), want.mean(),
                                   rtol=MEAN_ITER_RTOL)
