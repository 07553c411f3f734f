"""The port's fluid-fabric engine against the JAX reference and against
its own invariants.

* One tick from a carried-over state: the reference runs a few hundred
  ticks, its final state crosses over (`netsim.convert`), and one tick of
  each package starts from it.  Ints and bools must match exactly.  The
  eager reference tick rounds every op once, as torch does, so floats
  match bitwise too, except CUBIC's window through the cube root (bound 4
  ulp, as in ``test_torch_core``).  ``expm1``, whose implementations differ
  by up to 5 ulp, feeds only the loss/CNP comparisons, whose bools must
  still match.
* Short trajectories (Tier B): the loss and CNP draws threshold on
  ``-expm1(...)``, so a 1-ulp difference can flip one draw and the runs
  then diverge chaotically; the figures' statistics must agree within
  the stated tolerances, and the chunk traces within the reference's own
  accumulator rounding.
* Inside the port, bitwise: a K=1 sweep equals `simulate`, row k of a K=3
  seed sweep equals a single run of point k, and a ``job_active``-padded
  fabric equals the unpadded one on the active jobs.
"""
import dataclasses

import numpy as np
import pytest

from _torch_reference import assert_ulp, load_reference

import jax
import torch

from repro_torch import core as tcore
from repro_torch import device as tdevice
from repro_torch import netsim as tnet
from repro_torch.netsim import convert, engine

REF = load_reference()
rcore = REF["repro.core"]
rnet = REF["repro.netsim"]
reng = rnet.engine

DT = 2e-5
DEV = torch.device("cpu")
# float bounds for one tick: exact but CUBIC's window (see the module note)
TICK_MAX_ULP = 0
TICK_MAX_ULP_CUBIC = 4
CUBIC_WINDOW = ("cwnd", "ssthresh", "w_max")


def _cfgs(algo=0, variant=1, n_jobs=2, sim_time=0.3, seed=3, **kw):
    out = []
    for core, net in ((rcore, rnet), (tcore, tnet)):
        proto = core.MLTCPConfig(
            cc=core.CCParams(algo=algo, variant=variant, tick_dt=DT,
                             rtt=100e-6),
            slope=1.75, intercept=0.25)
        out.append(net.SimConfig(
            topo=net.dumbbell(n_jobs, sockets_per_job=2),
            jobs=net.JobSpec.simple([0.0075] * n_jobs, [25e6] * n_jobs),
            protocol=proto, sim_time=sim_time, dt=DT, seed=seed, **kw))
    return out


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if tree is None:
        return []
    return [x for v in tree for x in _leaves(v)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# one tick from a carried-over state
# ---------------------------------------------------------------------------

# (algo, variant, ticks): moments when both jobs are on the wire with the
# bottleneck queue past RED's knee (DCQCN's also past the taildrop ceiling)
CARRIED = [(0, 1, 420), (1, 1, 420), (2, 3, 660)]


@pytest.mark.parametrize("algo,variant,ticks", CARRIED)
def test_one_tick_from_carried_state(algo, variant, ticks):
    rcfg, tcfg = _cfgs(algo, variant, sim_time=ticks * DT)
    raw = rnet.simulate(rcfg)
    rstate = jax.tree_util.tree_map(np.asarray, raw.final_state)
    assert rstate.in_comm.all() and rstate.backlog.sum() > rcfg.red_qmax

    # reference: one eager tick from its own final state
    rsweep = reng.sweep_of(rcfg)
    rstatics = reng._build_statics(rcfg)
    want, _ = reng._tick(rcfg, rstatics, rsweep,
                         reng._workload_view(rcfg, rsweep),
                         raw.final_state, None)

    # port: the same state and sweep, carried over as numpy
    st = convert.engine_state_from_numpy(rstate, device=DEV)
    sweep = convert.sweep_from_numpy(
        jax.tree_util.tree_map(np.asarray, rsweep), device=DEV)
    statics = engine._build_statics(tcfg, DEV)
    wl = engine._workload_view(tcfg, statics, sweep)
    inp = engine.chunk_inputs(tcfg, statics, sweep, st, 1).at(0)
    got = engine._tick(tcfg, statics, sweep, wl, st, inp)

    np.testing.assert_array_equal(got.key[0], np.asarray(want.key))
    for name in engine.EngineState._fields:
        if name in ("proto", "key"):
            continue
        g, w = _np(getattr(got, name))[0], np.asarray(getattr(want, name))
        if w.dtype == np.float32:
            assert_ulp(g, w, TICK_MAX_ULP, name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    for grp in ("cc", "det"):
        for name in getattr(want.proto, grp)._fields:
            g = _np(getattr(getattr(got.proto, grp), name))[0]
            w = np.asarray(getattr(getattr(want.proto, grp), name))
            if w.dtype == np.float32:
                bound = (TICK_MAX_ULP_CUBIC if algo == 1 and
                         name in CUBIC_WINDOW else TICK_MAX_ULP)
                assert_ulp(g, w, bound, f"{grp}.{name}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_state_and_sweep_round_trip_through_numpy():
    """A reference sweep output's state converts with its K axis intact."""
    rcfg, tcfg = _cfgs(sim_time=0.004)
    rsweep = rnet.make_sweep(rcfg, seed=[1, 2])
    raw = rnet.simulate_sweep(rcfg, rsweep)
    st = convert.engine_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, raw.final_state), device=DEV)
    assert st.key.shape == (2, 2) and st.key.dtype == np.uint32
    np.testing.assert_array_equal(st.key, np.asarray(raw.final_state.key))
    assert st.backlog.shape == (2, 2, 4) and st.ring_loss.dtype == torch.bool
    assert st.proto.cc.inc_stage.dtype == torch.int32
    sweep = convert.sweep_from_numpy(
        jax.tree_util.tree_map(np.asarray, rsweep), device=DEV)
    assert engine.sweep_len(sweep) == 2
    np.testing.assert_array_equal(sweep.seed.numpy(), [1, 2])
    with pytest.raises(NotImplementedError, match="queue 1"):
        convert.sweep_from_numpy({**rsweep._asdict(),
                                  "fault_tick": np.zeros((2, 1))}, device=DEV)


# ---------------------------------------------------------------------------
# Tier B: a short trajectory through both packages
# ---------------------------------------------------------------------------

def test_trajectory_matches_reference():
    rcfg, tcfg = _cfgs(sim_time=0.3)
    want = rnet.postprocess(rcfg, rnet.simulate(rcfg))
    got = tnet.postprocess(tcfg, tnet.simulate(tcfg, device=DEV))
    for j in range(2):
        # iteration counts within +-1 per job
        assert abs(len(got.iter_times[j]) - len(want.iter_times[j])) <= 1
        # mean iteration time within 2%
        np.testing.assert_allclose(np.mean(got.iter_times[j]),
                                   np.mean(want.iter_times[j]), rtol=0.02)
    # comm-phase overlap within 0.1 (the Jaccard score over the tail)
    assert abs(tnet.mean_pairwise_interleave(got)
               - rnet.mean_pairwise_interleave(want)) <= 0.1


# The reference runs its ticks inside one jitted scan, where XLA contracts
# and re-associates the per-chunk accumulator sums; measured up to 644 ulp
# (4e-5 relative) on these non-negative sums, while the dynamics they
# summarize (comm phases, iteration times) match exactly.
TRACE_RTOL = 1e-4


@pytest.mark.parametrize("algo", [0, 2])
def test_chunk_traces_match_reference(algo):
    """The chunk probes (utilization, drops, ECN marks, job throughput,
    byte ratios) over a short run: Reno drops, DCQCN marks."""
    rcfg, tcfg = _cfgs(algo, 1, sim_time=0.05)
    want = rnet.simulate(rcfg)
    got = tnet.simulate(tcfg, device=DEV)
    for name in ("trace_incomm", "trace_t", "iter_counts", "iter_times"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("trace_util", "trace_drops", "trace_marks", "trace_jobtput",
                 "trace_ratio"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=TRACE_RTOL, atol=0, err_msg=name)
    assert float(np.asarray(want.trace_drops if algo == 0
                            else want.trace_marks).sum()) > 0


def test_cassini_stragglers_static_factors_match_reference():
    """The optional paths — a Cassini slot grid, straggler draws and mixed
    Static factors — on a short run of both packages (Tier B bounds)."""
    kw = dict(static_job_factors=np.asarray([0.6, -1.0]))
    rcfg, tcfg = _cfgs(sim_time=0.1, **kw)
    jobs = dict(straggle_prob=np.asarray([0.5, 0.5]))
    cas = dict(offset=np.asarray([0.0, 0.006]), period=np.asarray([0.02, 0.02]),
               eps=1e-3)
    rcfg = dataclasses.replace(
        rcfg, jobs=dataclasses.replace(rcfg.jobs, **jobs),
        cassini=rnet.CassiniSchedule(**cas))
    tcfg = dataclasses.replace(
        tcfg, jobs=dataclasses.replace(tcfg.jobs, **jobs),
        cassini=tnet.CassiniSchedule(**cas))
    want = rnet.postprocess(rcfg, rnet.simulate(rcfg))
    got = tnet.postprocess(tcfg, tnet.simulate(tcfg, device=DEV))
    for j in range(2):
        assert len(want.iter_times[j]) >= 3
        assert abs(len(got.iter_times[j]) - len(want.iter_times[j])) <= 1
        np.testing.assert_allclose(np.mean(got.iter_times[j]),
                                   np.mean(want.iter_times[j]), rtol=0.02)


# ---------------------------------------------------------------------------
# inside the port, bitwise
# ---------------------------------------------------------------------------

SHORT = 0.03    # 1500 ticks: both jobs finish an iteration


def test_k1_sweep_equals_simulate():
    _, cfg = _cfgs(sim_time=SHORT)
    raw = tnet.simulate(cfg, device=DEV)
    raw_k1 = engine.point_of(
        tnet.simulate_sweep(cfg, tnet.make_sweep(cfg, device=DEV),
                            device=DEV), 0)
    _assert_trees_equal(raw, raw_k1)
    assert int(raw.iter_counts.min()) >= 1


def test_seed_sweep_rows_equal_single_runs():
    _, cfg = _cfgs(sim_time=SHORT)
    seeds = [0, 7, 2**31 - 1]
    raw = tnet.simulate_sweep(cfg, tnet.make_sweep(cfg, device=DEV,
                                                   seed=seeds), device=DEV)
    for i, seed in enumerate(seeds):
        single = tnet.simulate(dataclasses.replace(cfg, seed=seed),
                               device=DEV)
        _assert_trees_equal(engine.point_of(raw, i), single)


def test_padded_jobs_equal_unpadded_run():
    _, small = _cfgs(n_jobs=2, sim_time=SHORT)
    _, big = _cfgs(n_jobs=3, sim_time=SHORT)
    want = tnet.simulate(small, device=DEV)
    sweep = tnet.make_sweep(big, device=DEV, job_active=[[True, True, False]])
    got = engine.point_of(tnet.simulate_sweep(big, sweep, device=DEV), 0)
    n_flows = small.topo.n_flows
    for name in ("iter_times", "iter_counts"):
        np.testing.assert_array_equal(_np(getattr(got, name))[:2],
                                      _np(getattr(want, name)), err_msg=name)
    for name in ("trace_incomm", "trace_jobtput", "trace_ratio"):
        np.testing.assert_array_equal(_np(getattr(got, name))[:, :2],
                                      _np(getattr(want, name)), err_msg=name)
    for name in ("trace_util", "trace_drops", "trace_marks", "trace_t"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)), err_msg=name)
    for grp in ("cc", "det"):
        for name in getattr(want.final_state.proto, grp)._fields:
            np.testing.assert_array_equal(
                _np(getattr(getattr(got.final_state.proto, grp), name))
                [:n_flows],
                _np(getattr(getattr(want.final_state.proto, grp), name)),
                err_msg=f"{grp}.{name}")


# ---------------------------------------------------------------------------
# entry-point contract
# ---------------------------------------------------------------------------

def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(sim_time=SHORT)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnet.simulate(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnet.simulate_sweep(cfg, tnet.make_sweep(cfg, device=DEV))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve("cuda")
    assert tdevice.resolve("cpu").type == "cpu"


def test_unported_options_raise():
    _, cfg = _cfgs(sim_time=SHORT)
    for field, item in (("telemetry", "item 10"), ("faults", "item 11")):
        bad = dataclasses.replace(cfg, **{field: object()})
        with pytest.raises(NotImplementedError, match=item):
            tnet.simulate(bad, device=DEV)
    with pytest.raises(NotImplementedError, match="item 11"):
        tnet.make_sweep(cfg, device=DEV, fault_tick=[0])
