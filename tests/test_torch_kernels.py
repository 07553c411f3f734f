"""The fused CC-tick kernel's wrapper, dispatch and plain version.

* Inside the port: ``ops.mltcp_cc_tick`` on CPU tensors (which runs the
  kernel's plain version) equals ``core.cc_tick`` bitwise, for every
  algo x variant x Static factors x aggregation — the invariant the
  reference pins for its Pallas kernel against its jnp oracle.
* Across frameworks: the plain version against the reference's Pallas
  kernel run in interpret mode.  Unlike the eager reference core, the
  interpreted kernel body is one XLA program, so XLA contracts ``a*b+c``
  into an FMA (measured: 1 ulp on DCQCN's rate updates); the bound is
  2 ulp, and 4 on CUBIC's window for the cube root (``test_torch_core``).
* The wrapper raises on operands the kernel does not take, and the
  structural fallback is loud.
The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there, and the ``cuda`` test below does when a
card is present.
"""
import warnings

import numpy as np
import pytest

from _torch_reference import (assert_ulp, load_reference,
                              random_feedback_arrays, random_protocol_arrays)

import jax.numpy as jnp
import torch

from repro_torch import core as tcore
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import ops as tops

REF = load_reference()
rcore = REF["repro.core"]
rops = REF["repro.kernels.ops"]

N_FLOWS = 41
N_JOBS = 4


def _port_inputs(seed, k=2, n=N_FLOWS):
    rng = np.random.default_rng(seed)
    arrs = random_protocol_arrays(rng, (k, n))
    fb = random_feedback_arrays(rng, (k, n))
    state = tcore.MLTCPState(
        cc=tcore.FlowCCState(**{f: torch.from_numpy(v) for f, v in
                                arrs["cc"].items()}),
        det=tcore.IterDetectState(**{f: torch.from_numpy(v) for f, v in
                                     arrs["det"].items()}))
    tfb = tcore.Feedback(num_acks=torch.from_numpy(fb["num_acks"]),
                         loss=torch.from_numpy(fb["loss"]),
                         cnp=torch.from_numpy(fb["cnp"]),
                         now=torch.tensor([0.0123, 0.0171][:k]))
    total = torch.from_numpy(rng.uniform(1e7, 2e8, (k, n)).astype(np.float32))
    factors = torch.from_numpy(np.where(
        rng.uniform(size=(k, n)) < 0.5, rng.uniform(0.25, 2.0, (k, n)),
        -1.0).astype(np.float32))
    dyn = tcore.DynamicParams(
        *[torch.tensor(v, dtype=torch.float32)[:k] for v in
          ([1.75, 1.3], [0.25, 0.4], [0.75, 0.8], [0.5, 0.45],
           [1e-3, 2e-3])])
    return arrs, fb, state, tfb, total, factors, dyn


def _assert_state_equal(got, want, rate_got, rate_want):
    for grp in ("cc", "det"):
        for name in getattr(want, grp)._fields:
            g = getattr(getattr(got, grp), name)
            w = getattr(getattr(want, grp), name)
            assert g.dtype == w.dtype, (grp, name)
            assert torch.equal(g, w), f"{grp}.{name}"
    assert torch.equal(rate_got, rate_want)


@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("use_factors", [False, True])
@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("algo", [0, 1, 2])
def test_ops_tick_equals_core_bitwise(algo, variant, use_factors, aggregate):
    cfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=algo, variant=variant),
                            aggregate_by_job=aggregate)
    _, _, state, fb, total, factors, dyn = _port_inputs(algo * 4 + variant)
    f2j = np.arange(N_FLOWS) % N_JOBS
    kw = dict(flow_to_job=f2j, n_jobs=N_JOBS, dyn=dyn,
              static_factors=factors if use_factors else None)
    before = tops.FALLBACK_COUNT
    got, rate = tops.mltcp_cc_tick(cfg, state, fb, total, **kw)
    assert tops.FALLBACK_COUNT == before
    want, want_rate = tcore.cc_tick(cfg, state, fb, total, **kw)
    _assert_state_equal(got, want, rate, want_rate)
    assert got.cc.inc_stage.dtype == torch.int32


def test_plain_version_is_the_wrappers_cpu_path():
    """On CPU tensors the wrapper returns exactly the plain version and
    never counts a launch."""
    arrs, fb, state, tfb, total, factors, dyn = _port_inputs(3)
    p = ms.static_params(tcore.CCParams(algo=1, variant=3), aggregate=False)
    arrays = _kernel_arrays(state, tfb, total)
    before = ms.LAUNCH_COUNT
    got = ms.mltcp_tick(p, dyn.stacked(), arrays, tfb.now, factors)
    want = ms.mltcp_tick_reference(p, dyn.stacked(), arrays, tfb.now,
                                   factors)
    assert ms.LAUNCH_COUNT == before
    assert list(got) == list(ms.OUT_ORDER)
    for name in ms.OUT_ORDER:
        assert torch.equal(got[name], want[name]), name


def _kernel_arrays(state, fb, total, job_numer=None):
    d, c = state.det, state.cc
    arrays = {f: getattr(d, f) for f in ms.DET_FIELDS}
    arrays.update({f: getattr(c, f) for f in ms.CC_FIELDS})
    arrays.update(stage=c.inc_stage, prev_ratio=d.bytes_ratio,
                  num_acks=fb.num_acks, ack_bytes=fb.num_acks * 1500.0,
                  loss=fb.loss, cnp=fb.cnp, total_bytes=total)
    if job_numer is not None:
        arrays["job_numer"] = job_numer
    return arrays


# ulp bounds against the interpreted Pallas kernel (see the module note)
PALLAS_MAX_ULP = 2
PALLAS_MAX_ULP_CUBIC = 4

CROSS_CASES = [(a, v, (a + v) % 2 == 0, v % 2 == 1)
               for a in (0, 1, 2) for v in (0, 1, 2, 3)]


@pytest.mark.parametrize("algo,variant,use_factors,aggregate", CROSS_CASES)
def test_plain_version_matches_pallas_kernel(algo, variant, use_factors,
                                             aggregate):
    """The port's plain version (via ops on CPU) against the reference's
    Pallas kernel in interpret mode, one sweep point."""
    arrs, fb, state, tfb, total, factors, dyn = _port_inputs(
        100 + algo * 4 + variant, k=1)
    f2j = np.arange(N_FLOWS) % N_JOBS
    tcfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=algo, variant=variant),
                             aggregate_by_job=aggregate)
    got, got_rate = tops.mltcp_cc_tick(
        tcfg, state, tfb, total, flow_to_job=f2j, n_jobs=N_JOBS,
        static_factors=factors if use_factors else None, dyn=dyn)

    rcfg = rcore.MLTCPConfig(cc=rcore.CCParams(algo=algo, variant=variant),
                             aggregate_by_job=aggregate)
    rstate = rcore.MLTCPState(
        cc=rcore.FlowCCState(**{f: jnp.asarray(v[0]) for f, v in
                                arrs["cc"].items()}),
        det=rcore.IterDetectState(**{f: jnp.asarray(v[0]) for f, v in
                                     arrs["det"].items()}))
    rfb = rcore.Feedback(num_acks=jnp.asarray(fb["num_acks"][0]),
                         loss=jnp.asarray(fb["loss"][0]),
                         cnp=jnp.asarray(fb["cnp"][0]),
                         now=jnp.asarray(np.float32(0.0123)))
    want, want_rate = rops.mltcp_cc_tick(
        rcfg, rstate, rfb, jnp.asarray(total[0].numpy()),
        flow_to_job=jnp.asarray(f2j), n_jobs=N_JOBS,
        static_factors=(jnp.asarray(factors[0].numpy()) if use_factors
                        else None),
        dyn=rcore.DynamicParams(*[jnp.asarray(v[0].numpy()) for v in dyn]),
        interpret=True)
    cubic_fields = ("cwnd", "ssthresh", "w_max")
    for grp in ("cc", "det"):
        for name in getattr(want, grp)._fields:
            g = getattr(getattr(got, grp), name)[0].numpy()
            w = np.asarray(getattr(getattr(want, grp), name))
            if w.dtype != np.float32:
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                assert_ulp(g, w, PALLAS_MAX_ULP_CUBIC if algo == 1 and name
                           in cubic_fields else PALLAS_MAX_ULP,
                           f"{grp}.{name}")
    assert_ulp(got_rate[0].numpy(), np.asarray(want_rate),
               PALLAS_MAX_ULP_CUBIC if algo == 1 else PALLAS_MAX_ULP, "rate")


def test_wrapper_rejects_bad_operands():
    _, _, state, fb, total, factors, dyn = _port_inputs(5)
    p = ms.static_params(tcore.CCParams(), aggregate=False)
    good = _kernel_arrays(state, fb, total)

    def call(arrays=good, dyn_=dyn.stacked(), now=fb.now, fac=None):
        return ms.mltcp_tick(p, dyn_, arrays, now, fac)

    call()
    with pytest.raises(TypeError, match="stage"):
        call({**good, "stage": good["stage"].to(torch.int64)})
    with pytest.raises(TypeError, match="cwnd"):
        call({**good, "cwnd": good["cwnd"].double()})
    with pytest.raises(ValueError, match="total_bytes"):
        call({**good, "total_bytes": good["total_bytes"][:, :5]})
    with pytest.raises(ValueError, match="contiguous"):
        call({**good, "alpha": good["alpha"].t().contiguous().t()})
    with pytest.raises(ValueError, match="dyn"):
        call(dyn_=dyn.stacked()[:, :4].contiguous())
    with pytest.raises(ValueError, match="now"):
        call(now=fb.now[:1])
    with pytest.raises(ValueError, match="static_factors"):
        call(fac=factors[:1])
    with pytest.raises(ValueError, match="is on"):
        call({**good, "cwnd": good["cwnd"].to("meta")})
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        call({f: v[0] for f, v in good.items()})


def test_ops_rejects_unreduced_operands():
    cfg = tcore.MLTCPConfig()
    _, _, state, fb, total, _, dyn = _port_inputs(6)
    with pytest.raises(ValueError, match="total_bytes"):
        tops.mltcp_cc_tick(cfg, state, fb, total[None].expand(3, -1, -1),
                           dyn=dyn)


def _callable_f(x):
    """An F of the caller's own (a callable): no kernel computes it."""
    return 1.5 * x + 0.5


@pytest.mark.parametrize("kw,reason", [
    ({"favoritism": "earliest_iter_start"}, "favoritism"),
    ({"f_spec": _callable_f}, "f_spec")])
def test_fallback_is_loud(kw, reason):
    cfg = tcore.MLTCPConfig(cc=tcore.CCParams(algo=0, variant=1), **kw)
    _, _, state, fb, total, _, dyn = _port_inputs(7)
    tops.reset_fallback_warnings()
    before = tops.FALLBACK_COUNT
    with pytest.warns(UserWarning, match=reason):
        got, _ = tops.mltcp_cc_tick(cfg, state, fb, total, dyn=dyn)
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # warned once per reason
        tops.mltcp_cc_tick(cfg, state, fb, total, dyn=dyn)
    assert tops.FALLBACK_COUNT == before + 2
    want, _ = tcore.cc_tick(cfg, state, fb, total, dyn=dyn)
    assert torch.equal(got.cc.cwnd, want.cc.cwnd)


def test_defaults_never_fall_back():
    _, _, state, fb, total, factors, dyn = _port_inputs(8)
    before = tops.FALLBACK_COUNT
    tops.mltcp_cc_tick(tcore.MLTCPConfig(), state, fb, total, dyn=dyn)
    # Static factors make favoritism/F moot: still the kernel path
    tops.mltcp_cc_tick(tcore.MLTCPConfig(f_spec="F3"), state, fb, total,
                       static_factors=factors.abs(), dyn=dyn)
    assert tops.FALLBACK_COUNT == before


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs this comparison on the card)")
    _, _, state, fb, total, factors, dyn = _port_inputs(9)
    dev = torch.device("cuda")
    for algo in (0, 1, 2):
        p = ms.static_params(tcore.CCParams(algo=algo, variant=3),
                             aggregate=True)
        arrays = {f: v.to(dev) for f, v in
                  _kernel_arrays(state, fb, total, total * 0.5).items()}
        args = (p, dyn.stacked().to(dev), arrays, fb.now.to(dev),
                factors.to(dev))
        got = ms.mltcp_tick(*args)
        want = ms.mltcp_tick_reference(*args)
        for name in ms.OUT_ORDER:
            assert torch.equal(got[name].view(torch.int32)
                               if got[name].dtype == torch.float32
                               else got[name],
                               want[name].view(torch.int32)
                               if want[name].dtype == torch.float32
                               else want[name]), (algo, name)
