"""The port's optimizer (``repro_torch.optim``) against the JAX reference
on the CPU: the cosine schedule, AdamW (float32 and bfloat16 moments), the
global norm, both gradient-compression schemes and ``wire_bytes``; and
the reference's own optimizer properties (``tests/test_substrate.py``:
descent on a quadratic, error feedback keeps the signal).

Inputs are drawn with numpy and handed to both packages; the reference
runs eagerly (no ``jit``).  Bounds, with what was measured (CPU, jax
0.9.0, torch 2.13):

* schedule: within 8 ulp (float32 bit patterns); measured at most 4,
  from ``cos``, which the two libraries round differently;
* AdamW parameters and moments, and the global norm: rtol 1e-6; measured
  equal (one float32 rounding per operation, in the same order), except
  one global norm 1 ulp apart (the leaves' sums of squares add in
  another order);
* compression: sent gradients and residuals exactly equal (the same
  single operations: an add, a comparison against the k-th magnitude, a
  division and a round half to even);
* ``wire_bytes``: exactly equal (the same float arithmetic in Python).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_reference import load_reference

from repro_torch import optim

SHAPES = {"w": (7, 5), "b": (33,), "x": (4, 3, 2), "one": (1,)}


def _ref():
    return load_reference()["repro.optim"]


def _both(arrays: dict):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def _draw(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("warmup,total,min_frac", [
    (100, 10_000, 0.1), (5, 60, 0.1), (1, 7, 0.0), (0, 50, 0.3),
    (20, 20, 0.1)])
def test_cosine_schedule_matches_reference(warmup, total, min_frac):
    ro = _ref()
    steps = list(range(0, total + 20, max(1, total // 500)))
    want = [float(ro.cosine_schedule(s, warmup, total, min_frac))
            for s in steps]
    got = [float(optim.cosine_schedule(s, warmup, total, min_frac))
           for s in steps]
    assert _ulps(got, want) <= 8
    # a tensor step (the train state's int32) gives the int's value
    t = optim.cosine_schedule(torch.tensor(steps[3], dtype=torch.int32),
                              warmup, total, min_frac)
    assert t.dtype == torch.float32 and float(t) == got[3]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    ro = _ref()
    rng = np.random.default_rng(11)
    cfg_r = ro.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    cfg_p = optim.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    rp, pp = _both(_draw(rng))
    rs, ps = ro.adamw_init(cfg_r, rp), optim.adamw_init(cfg_p, pp)
    assert ps.m["w"].dtype == getattr(torch, state_dtype)
    for it in range(4):
        # the first gradient is clipped (norm ~27 > 1), the later not
        rg, pg = _both(_draw(rng, 3.0 if it == 0 else 0.1))
        scale = 0.5 + 0.1 * it
        rp, rs, rm = ro.adamw_update(cfg_r, rs, rp, rg, jnp.float32(scale))
        pp, ps, pm = optim.adamw_update(cfg_p, ps, pp, pg,
                                        torch.tensor(scale))
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
    assert int(ps.step) == int(rs.step) == 4
    for k in SHAPES:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=0)
        for mine, theirs in ((ps.m[k], rs.m[k]), (ps.v[k], rs.v[k])):
            np.testing.assert_allclose(
                mine.float().numpy(),
                np.asarray(theirs.astype(jnp.float32)), rtol=1e-6, atol=0)


def test_adamw_updates_the_tensors_in_place():
    cfg = optim.AdamWConfig()
    params = {"w": torch.ones(3)}
    state = optim.adamw_init(cfg, params)
    w, m = params["w"], state.m["w"]
    params, state, _ = optim.adamw_update(cfg, state, params,
                                          {"w": torch.full((3,), 0.5)})
    assert params["w"] is w and state.m["w"] is m
    assert not torch.equal(w, torch.ones(3)) and bool((m != 0).all())


def test_global_norm_matches_reference():
    radamw = load_reference()["repro.optim.adamw"]
    rng = np.random.default_rng(3)
    rg, pg = _both(_draw(rng, 5.0))
    np.testing.assert_allclose(float(optim.global_norm(pg)),
                               float(radamw.global_norm(rg)), rtol=1e-6)


@pytest.mark.parametrize("scheme", ["topk", "int8"])
@pytest.mark.parametrize("frac", [0.1, 0.25])
def test_compress_gradients_matches_reference(scheme, frac):
    ro = _ref()
    rng = np.random.default_rng(5)
    c_r = ro.CompressionConfig(scheme=scheme, topk_frac=frac)
    c_p = optim.CompressionConfig(scheme=scheme, topk_frac=frac)
    g0 = _draw(rng)
    rr = ro.init_error_feedback({k: jnp.asarray(v) for k, v in g0.items()})
    pr = optim.init_error_feedback({k: torch.from_numpy(v)
                                    for k, v in g0.items()})
    for _ in range(3):
        rg, pg = _both(_draw(rng))
        rs, rr = ro.compress_gradients(c_r, rg, rr)
        ps, pr = optim.compress_gradients(c_p, pg, pr)
        for k in SHAPES:
            np.testing.assert_array_equal(ps[k].numpy(), np.asarray(rs[k]))
            np.testing.assert_array_equal(pr[k].numpy(), np.asarray(rr[k]))


def test_compress_gradients_none_passes_through():
    g = {"w": torch.ones(3)}
    r = optim.init_error_feedback(g)
    sent, resid = optim.compress_gradients(optim.CompressionConfig(), g, r)
    assert sent is g and resid is r
    with pytest.raises(ValueError):
        optim.compress_gradients(optim.CompressionConfig(scheme="fp4"), g, r)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
@pytest.mark.parametrize("workers", [2, 3, 8])
def test_wire_bytes_matches_reference(scheme, workers):
    rgc = load_reference()["repro.optim.grad_compress"]
    for n in (1, 1_000_003, 2_894_481_920):
        assert optim.wire_bytes(optim.CompressionConfig(scheme, 0.01), n,
                                workers) == \
            rgc.wire_bytes(rgc.CompressionConfig(scheme, 0.01), n, workers)


# ---------------------------------------------------------------------------
# the reference's own optimizer properties (tests/test_substrate.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_decreases_loss_quadratic(state_dtype):
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0,
                            state_dtype=state_dtype)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = optim.adamw_init(cfg, params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = optim.adamw_update(cfg, opt, params, grads)
    assert float(params["w"].abs().max()) < 0.2


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_error_feedback_preserves_signal(scheme):
    """Accumulated (sent + residual) equals accumulated raw gradients."""
    cfg = optim.CompressionConfig(scheme=scheme, topk_frac=0.25)
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .normal(size=(64,)).astype(np.float32))}
    resid = optim.init_error_feedback(g)
    total_sent = torch.zeros(64)
    for _ in range(5):
        sent, resid = optim.compress_gradients(cfg, g, resid)
        total_sent = total_sent + sent["w"]
    recovered = total_sent + resid["w"]
    np.testing.assert_allclose(recovered.numpy(), 5 * g["w"].numpy(),
                               rtol=1e-4, atol=1e-4)
