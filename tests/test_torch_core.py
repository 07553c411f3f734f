"""Tier A: the port's protocol core against the JAX reference, per function.

The same fuzzed inputs, made with numpy, go through ``repro.core.cc_tick``
and ``repro_torch.core.cc_tick``.  Int and bool outputs must match
exactly.  The reference runs eagerly here, one XLA program per op, so XLA
has no ``a*b+c`` to contract into an FMA: every op rounds once on both
sides and the floats match bitwise too, except where a transcendental
differs.  The only one in the tick is CUBIC's cube root: XLA's
``jnp.cbrt`` is up to 15 ulp from the exact root on this CPU, the port's
within 1, and the difference reaches the window through K (measured: 1
ulp).  The second half ports the pure property tests of
``tests/test_core.py``.
"""
import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ModuleNotFoundError:  # optional test extra; fall back to a fixed grid
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

from _torch_reference import (assert_ulp, load_reference,
                              random_feedback_arrays, random_protocol_arrays)

import jax.numpy as jnp
import torch

from repro_torch import core as tcore
from repro_torch.core.aggressiveness import is_srpt_reinforcing
from repro_torch.core import favoritism as tfav

REF = load_reference()
rcore = REF["repro.core"]

ALGOS = (0, 1, 2)
VARIANTS = (0, 1, 2, 3)
N_FLOWS = 37
N_JOBS = 3
DYN_ROWS = ((1.75, 0.25, 0.75, 0.5, 1e-3), (1.3, 0.4, 0.8, 0.45, 2e-3))

# Float bounds, in float32 ulp: exact everywhere (same IEEE ops, same
# order) but CUBIC's window and send rate, which inherit the two cube
# roots' difference through the target (measured 1 ulp; bound 4).
MAX_ULP = 0
MAX_ULP_CUBIC_CWND = 4


def _ref_state(arrs, row):
    cc = rcore.FlowCCState(**{k: jnp.asarray(v[row]) for k, v in
                              arrs["cc"].items()})
    det = rcore.IterDetectState(**{k: jnp.asarray(v[row]) for k, v in
                                   arrs["det"].items()})
    return rcore.MLTCPState(cc=cc, det=det)


def _port_state(arrs):
    cc = tcore.FlowCCState(**{k: torch.from_numpy(v.copy()) for k, v in
                              arrs["cc"].items()})
    det = tcore.IterDetectState(**{k: torch.from_numpy(v.copy()) for k, v in
                                   arrs["det"].items()})
    return tcore.MLTCPState(cc=cc, det=det)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    k = len(DYN_ROWS)
    arrs = random_protocol_arrays(rng, (k, N_FLOWS))
    fb = random_feedback_arrays(rng, (k, N_FLOWS))
    now = np.asarray([0.0123, 0.0171], np.float32)
    total = rng.uniform(1e7, 2e8, (k, N_FLOWS)).astype(np.float32)
    # mixed Static factors: negative entries keep the adaptive F
    factors = np.where(rng.uniform(size=(k, N_FLOWS)) < 0.5,
                       rng.uniform(0.25, 2.0, (k, N_FLOWS)), -1.0
                       ).astype(np.float32)
    elapsed = rng.uniform(-0.2, 1.2, (k, N_FLOWS)).astype(np.float32)
    finish = rng.uniform(-0.2, 1.2, (k, N_FLOWS)).astype(np.float32)
    return arrs, fb, now, total, factors, elapsed, finish


def _compare(cfg_kw, seed, use_factors=False, aggregate=True, times=False):
    arrs, fb, now, total, factors, elapsed, finish = _inputs(seed)
    f2j = np.arange(N_FLOWS) % N_JOBS
    rcfg = rcore.MLTCPConfig(aggregate_by_job=aggregate, **cfg_kw["ref"])
    tcfg = tcore.MLTCPConfig(aggregate_by_job=aggregate, **cfg_kw["port"])
    dyn = np.asarray(DYN_ROWS, np.float32)

    tdyn = tcore.DynamicParams(*[torch.from_numpy(dyn[:, i].copy())
                                 for i in range(5)])
    tfb = tcore.Feedback(num_acks=torch.from_numpy(fb["num_acks"]),
                         loss=torch.from_numpy(fb["loss"]),
                         cnp=torch.from_numpy(fb["cnp"]),
                         now=torch.from_numpy(now))
    got, got_rate = tcore.cc_tick(
        tcfg, _port_state(arrs), tfb, torch.from_numpy(total),
        flow_to_job=f2j, n_jobs=N_JOBS,
        static_factors=torch.from_numpy(factors) if use_factors else None,
        comm_elapsed=torch.from_numpy(elapsed) if times else None,
        est_finish=torch.from_numpy(finish) if times else None, dyn=tdyn)

    algo = cfg_kw["ref"]["cc"].algo
    for row in range(len(DYN_ROWS)):
        rfb = rcore.Feedback(num_acks=jnp.asarray(fb["num_acks"][row]),
                             loss=jnp.asarray(fb["loss"][row]),
                             cnp=jnp.asarray(fb["cnp"][row]),
                             now=jnp.asarray(now[row]))
        want, want_rate = rcore.cc_tick(
            rcfg, _ref_state(arrs, row), rfb, jnp.asarray(total[row]),
            flow_to_job=jnp.asarray(f2j), n_jobs=N_JOBS,
            static_factors=jnp.asarray(factors[row]) if use_factors else None,
            comm_elapsed=jnp.asarray(elapsed[row]) if times else None,
            est_finish=jnp.asarray(finish[row]) if times else None,
            dyn=rcore.DynamicParams(*[jnp.asarray(v) for v in dyn[row]]))
        for grp in ("cc", "det"):
            for name in getattr(want, grp)._fields:
                g = getattr(getattr(got, grp), name)[row].numpy()
                w = np.asarray(getattr(getattr(want, grp), name))
                what = f"{grp}.{name} row {row}"
                if w.dtype != np.float32:
                    np.testing.assert_array_equal(g, w, err_msg=what)
                else:
                    bound = (MAX_ULP_CUBIC_CWND if algo == 1 and name in
                             ("cwnd", "ssthresh", "w_max") else MAX_ULP)
                    assert_ulp(g, w, bound, what)
        bound = MAX_ULP_CUBIC_CWND if algo == 1 else MAX_ULP
        assert_ulp(got_rate[row].numpy(), np.asarray(want_rate), bound, "rate")


def _cfgs(algo, variant, **kw):
    return {"ref": dict(cc=rcore.CCParams(algo=algo, variant=variant), **kw),
            "port": dict(cc=tcore.CCParams(algo=algo, variant=variant), **kw)}


@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("use_factors", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("algo", ALGOS)
def test_cc_tick_matches_reference(algo, variant, use_factors, aggregate):
    _compare(_cfgs(algo, variant), seed=10 * algo + variant,
             use_factors=use_factors, aggregate=aggregate)


@pytest.mark.parametrize("policy", sorted(tfav.ALL_POLICIES))
def test_favoritism_policies_match_reference(policy):
    _compare(_cfgs(0, 1, favoritism=policy), seed=7, times=True)


@pytest.mark.parametrize("f_spec", ["F1", "F2", "F3", "F4", "F5", "F6"])
def test_f_families_match_reference(f_spec):
    _compare(_cfgs(0, 3, f_spec=f_spec), seed=8)


def test_cbrt_within_one_ulp_of_exact():
    from repro_torch.core.cc.cubic import cbrt

    rng = np.random.default_rng(0)
    x = (rng.uniform(0, 1, 50000) * 10.0 ** rng.uniform(-44, 38, 50000)
         ).astype(np.float32)
    x = np.concatenate([x, -x, np.float32([0.0, 1.0, 8.0, 27.0])])
    exact = np.cbrt(x.astype(np.float64)).astype(np.float32)
    assert_ulp(cbrt(torch.from_numpy(x)).numpy(), exact, 1, "cbrt")


# ---------------------------------------------------------------------------
# Property tests (the port's own invariants, as tests/test_core.py pins them
# for the reference)
# ---------------------------------------------------------------------------

def test_paper_functions_shapes():
    fns = tcore.paper_functions()
    xs = torch.linspace(0, 1, 101)
    for name in ("F1", "F2", "F3", "F4"):
        assert is_srpt_reinforcing(fns[name]), name      # increasing
    for name in ("F5", "F6"):
        assert not is_srpt_reinforcing(fns[name]), name  # decreasing
    # all six share the range [0.25, 2] on [0, 1] (paper §4.8)
    for name, fn in fns.items():
        ys = fn(xs)
        assert ys.min() >= 0.24 and ys.max() <= 2.01, name


@given(slope=st.floats(0.0, 4.0), intercept=st.floats(0.01, 2.0))
@settings(max_examples=50, deadline=None)
def test_linear_f_requirements(slope, intercept):
    f = tcore.make_fn("linear", slope, intercept)
    assert is_srpt_reinforcing(f)
    assert bool(torch.all(f(torch.linspace(0, 1, 33)) > 0))


def _trace_for_iterations(n_iters, comm_ticks, gap_ticks, dt=1e-4):
    """Synthetic ack trace: bursts of acks separated by silent gaps."""
    times, counts = [], []
    t = 0.0
    for _ in range(n_iters):
        for _ in range(comm_ticks):
            times.append(t)
            counts.append(10.0)
            t += dt
        t += gap_ticks * dt      # compute-phase silence
        times.append(t)          # first ack of next burst
        counts.append(10.0)
        t += dt
    return np.asarray(times), np.asarray(counts)


def _detect(times, counts, total=1e6, init_gap=1e-3):
    params = tcore.IterDetectParams(total_bytes=torch.tensor([total]),
                                    init_comm_gap=init_gap)
    return tcore.run_on_trace(times, counts, params, device="cpu")


def test_algorithm1_detects_boundaries():
    n_iters = 8
    final = _detect(*_trace_for_iterations(n_iters, 50, 200))
    assert abs(int(final.n_boundaries[0, 0]) - n_iters) <= 1
    assert 5e-3 < float(final.iter_gap[0, 0]) < 40e-3


@given(gap_ticks=st.integers(100, 2000), comm_ticks=st.integers(20, 200))
@settings(max_examples=15, deadline=None)
def test_algorithm1_no_false_positives_within_comm(gap_ticks, comm_ticks):
    final = _detect(*_trace_for_iterations(4, comm_ticks, gap_ticks))
    assert int(final.n_boundaries[0, 0]) <= 5   # 4 gaps + possible warmup


def test_bytes_ratio_bounded():
    times = np.arange(100, dtype=np.float32) * 1e-4
    final = _detect(times, np.full((100,), 100.0), total=1e4, init_gap=1.0)
    assert 0.0 <= float(final.bytes_ratio[0, 0]) <= 1.0


def test_run_on_trace_matches_reference():
    times, counts = _trace_for_iterations(3, 30, 150)
    got = _detect(times, counts)
    want = rcore.run_on_trace(
        jnp.asarray(times, jnp.float32), jnp.asarray(counts, jnp.float32),
        rcore.IterDetectParams(total_bytes=jnp.asarray([1e6]),
                               init_comm_gap=jnp.asarray(1e-3)))
    np.testing.assert_array_equal(got.n_boundaries[0].numpy(),
                                  np.asarray(want.n_boundaries))
    for name in ("bytes_sent", "bytes_ratio", "prev_ack_tstamp", "iter_gap",
                 "max_gap"):
        assert_ulp(getattr(got, name)[0].numpy(),
                   np.asarray(getattr(want, name)), MAX_ULP, name)


@pytest.mark.parametrize("algo", [0, 1, 2])
@pytest.mark.parametrize("variant", [0, 1, 2])
def test_cc_state_stays_positive_and_bounded(algo, variant):
    cfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=algo, variant=variant))
    n, k = 16, 2
    state = tcore.init_state(n, cfg, k=k, device="cpu")
    total = torch.full((k, n), 1e7)
    rng = np.random.default_rng(0)
    for i in range(200):
        fb = tcore.Feedback(
            num_acks=torch.tensor(rng.uniform(0, 30, (k, n)) *
                                  (rng.uniform(size=(k, n)) < 0.8),
                                  dtype=torch.float32),
            loss=torch.tensor(rng.uniform(size=(k, n)) < 0.05),
            cnp=torch.tensor(rng.uniform(size=(k, n)) < 0.1),
            now=torch.full((k,), i * 2e-5))
        state, rate = tcore.cc_tick(cfg, state, fb, total)
        assert bool(torch.all(state.cc.cwnd >= cfg.cc.min_cwnd))
        assert bool(torch.all(rate > 0))
        assert bool(torch.all(state.cc.rate_cur <= cfg.cc.line_rate + 1))
        assert bool(torch.all((state.cc.alpha >= 0) & (state.cc.alpha <= 1)))
        assert bool(torch.all(torch.isfinite(state.cc.cwnd)))


def test_md_never_increases_window():
    """A decrease step must never raise cwnd, even with F > 1 (MD clips)."""
    cfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=0, variant=2),
                            slope=1.0, intercept=1.0)   # F in [1, 2]
    state = tcore.init_state(4, cfg, device="cpu")
    state = state._replace(
        cc=state.cc._replace(cwnd=torch.full((1, 4), 100.0)),
        det=state.det._replace(bytes_ratio=torch.tensor([[0.0, 0.5, 0.9,
                                                          1.0]])))
    fb = tcore.Feedback(num_acks=torch.zeros(1, 4),
                        loss=torch.ones(1, 4, dtype=torch.bool),
                        cnp=torch.zeros(1, 4, dtype=torch.bool),
                        now=torch.tensor([1.0]))
    st2, _ = tcore.cc_tick(cfg, state, fb, torch.full((1, 4), 1e6))
    assert bool(torch.all(st2.cc.cwnd <= 100.0))


def test_off_variant_ignores_bytes_ratio():
    cfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=0, variant=0))
    state = tcore.init_state(2, cfg, device="cpu")
    state = state._replace(
        cc=state.cc._replace(cwnd=torch.tensor([[50.0, 50.0]]),
                             ssthresh=torch.tensor([[1.0, 1.0]])),
        det=state.det._replace(bytes_ratio=torch.tensor([[0.0, 1.0]]),
                               prev_ack_tstamp=torch.tensor([[0.999, 0.999]]),
                               iter_gap=torch.tensor([[10.0, 10.0]])))
    fb = tcore.Feedback(num_acks=torch.tensor([[10.0, 10.0]]),
                        loss=torch.zeros(1, 2, dtype=torch.bool),
                        cnp=torch.zeros(1, 2, dtype=torch.bool),
                        now=torch.tensor([1.0]))
    st2, _ = tcore.cc_tick(cfg, state, fb, torch.full((1, 2), 1e6))
    # same acks, different bytes_ratio -> identical growth when OFF
    assert float(st2.cc.cwnd[0, 0]) == float(st2.cc.cwnd[0, 1])
