"""The port's metrics on the reference's raw outputs, exactly.

A reference `RawSimOutput`, converted leaf by leaf with ``np.asarray``,
goes through both packages' post-processing; every figure quantity must
be equal (numpy on both sides, the same arithmetic).
"""
import numpy as np

from _torch_reference import load_reference

import jax

from repro_torch import core as tcore
from repro_torch import netsim as tnet

REF = load_reference()
rcore = REF["repro.core"]
rnet = REF["repro.netsim"]

DT = 2e-5


def _cfgs(variant, sim_time=0.15):
    out = []
    for core, net in ((rcore, rnet), (tcore, tnet)):
        proto = core.MLTCPConfig(
            cc=core.CCParams(algo=0, variant=variant, tick_dt=DT, rtt=100e-6))
        out.append(net.SimConfig(
            topo=net.dumbbell(2, sockets_per_job=2),
            jobs=net.JobSpec.simple([0.0075] * 2, [25e6] * 2),
            protocol=proto, sim_time=sim_time, dt=DT, seed=1))
    return out


def _np_raw(raw):
    return jax.tree_util.tree_map(np.asarray, raw)


def _assert_results_equal(got, want):
    assert got.n_jobs == want.n_jobs
    for g, w in zip(got.iter_times, want.iter_times):
        np.testing.assert_array_equal(g, w)
    assert got.drops_per_s == want.drops_per_s
    assert got.marks_per_s == want.marks_per_s
    for name in ("trace_t", "trace_util", "trace_incomm", "trace_drops",
                 "trace_jobtput"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)


def test_postprocess_and_scores_equal_reference():
    (r_off, t_off), (r_wi, t_wi) = _cfgs(0), _cfgs(1)
    raw_off = rnet.simulate(r_off)
    raw_wi = rnet.simulate(r_wi)
    want_off = rnet.postprocess(r_off, raw_off)
    want_wi = rnet.postprocess(r_wi, raw_wi)
    got_off = tnet.postprocess(t_off, _np_raw(raw_off))
    got_wi = tnet.postprocess(t_wi, _np_raw(raw_wi))
    _assert_results_equal(got_off, want_off)
    _assert_results_equal(got_wi, want_wi)
    for tail in (0.5, 0.25):
        assert (tnet.interleave_score(got_wi, 0, 1, tail)
                == rnet.interleave_score(want_wi, 0, 1, tail))
        assert (tnet.mean_pairwise_interleave(got_off, tail)
                == rnet.mean_pairwise_interleave(want_off, tail))
    assert (tnet.speedup_stats(got_off, got_wi, warmup=2)
            == rnet.speedup_stats(want_off, want_wi, warmup=2))
    assert got_wi.avg_iter(0, 2) == want_wi.avg_iter(0, 2)
    assert got_wi.p99_iter(1, 2) == want_wi.p99_iter(1, 2)
    np.testing.assert_array_equal(got_wi.all_iters(2), want_wi.all_iters(2))


def test_postprocess_sweep_equals_reference():
    (rcfg, tcfg), (rcfg_wi, tcfg_wi) = _cfgs(0), _cfgs(1)
    sweep, points = rnet.grid_sweep(rcfg, seed=[1, 2])
    raw = rnet.simulate_sweep(rcfg, sweep)
    raw_wi = rnet.simulate_sweep(rcfg_wi, rnet.make_sweep(rcfg_wi,
                                                          seed=[1, 2]))
    want = rnet.postprocess_sweep(rcfg, raw, points)
    want_wi = rnet.postprocess_sweep(rcfg_wi, raw_wi)
    got = tnet.postprocess_sweep(tcfg, _np_raw(raw))
    got_wi = tnet.postprocess_sweep(tcfg_wi, _np_raw(raw_wi))
    assert len(got) == len(want) == 2
    for g, w in zip(got + got_wi, want + want_wi):
        _assert_results_equal(g, w)
    assert (tnet.sweep_speedup_stats(got, got_wi, warmup=2)
            == rnet.sweep_speedup_stats(want, want_wi, warmup=2))
