"""The port's encoder-decoder stack (`repro_torch.models.encdec`) against
the JAX reference, on the CPU.

Weights come from the reference's initialiser (seamless-m4t-medium scaled
down: two encoder and two decoder blocks; and the same with QKV bias,
which the decoder's cross-attention adds at prefill and at decode),
carried over with `convert.params_from_reference`, whose ``enc``/``dec``
leaves carry a leading layer axis; tokens and frames are drawn with numpy.
`encode`, `forward`, `prefill` (logits, the self-attention cache and the
cross-attention cache of the memory) and teacher-forced `decode_step`;
`api.init_cache`'s encoder length; the loss and gradients of
`train_step.loss_fn`.

Bounds, with what was measured (CPU, jax 0.9.0, torch 2.13): atol = rtol =
1e-5 on the memory and logits, atol 5e-5 / rtol 1e-5 on caches
(tests/test_torch_models.py's bounds; measured at most 3.3e-6); the loss
within rtol 1e-5 (measured 6.9e-8) and each gradient leaf within 1e-4 of
its largest magnitude (measured 1.3e-6 of it at most).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import loss_and_grads

from repro.configs import get_config as ref_get_config
from repro.models import api as rapi
from repro.models import encdec as rencdec

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models import api, convert, encdec

TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=5e-5, rtol=1e-5)
ARCH = "seamless-m4t-medium"
B, T, T_ENC, NEW = 2, 16, 6, 3
CASES = {"plain": {}, "qkv_bias": dict(qkv_bias=True)}


@functools.lru_cache(maxsize=None)
def _setup(case):
    over = CASES[case]
    rcfg = ref_get_config(ARCH).scaled_down(**over)
    pcfg = get_config(ARCH).scaled_down(**over)
    params = rapi.init_params(rcfg, jax.random.PRNGKey(1))
    tree = jax.device_get(params)
    if pcfg.qkv_bias:
        # nonzero biases, so that the test sees them
        rng = np.random.default_rng(2)
        for stack in ("enc", "dec"):
            for name, attn in tree[stack].items():
                for b in ("bq", "bk", "bv") if "attn" in name else ():
                    attn[b] = rng.standard_normal(attn[b].shape
                                                  ).astype(np.float32)
        params = jax.tree.map(jnp.asarray, tree)
    model = convert.params_from_reference(pcfg, tree, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, pcfg.vocab, (B, T)).astype(np.int32)
    frames = rng.standard_normal((B, T_ENC, pcfg.d_model)).astype(np.float32)
    steps = rng.integers(0, pcfg.vocab, (NEW, B)).astype(np.int32)
    return rcfg, pcfg, params, model, toks, frames, steps


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


def _close_cache(pcfg, got, want):
    mine = convert.cache_to_reference_layout(pcfg, got)
    want = jax.device_get(want)
    assert mine.keys() == want.keys() == {"self", "cross"}
    for part in want:
        assert mine[part].keys() == want[part].keys() == {"k", "v"}
        for name in want[part]:
            assert mine[part][name].shape == want[part][name].shape
            _close(mine[part][name], want[part][name], CACHE_TOL,
                   f"{part}/{name}")


@pytest.mark.parametrize("case", CASES)
def test_encode_and_forward_match_reference(case):
    rcfg, pcfg, params, model, toks, frames, _ = _setup(case)
    rmem = rencdec.encode(rcfg, params, jnp.asarray(frames))
    rlogits, _ = rencdec.forward(rcfg, params, jnp.asarray(toks),
                                 jnp.asarray(frames))
    with torch.no_grad():
        pmem = encdec.encode(pcfg, model, torch.from_numpy(frames))
        plogits, aux = encdec.forward(pcfg, model, torch.from_numpy(toks),
                                      torch.from_numpy(frames))
    _close(pmem, rmem)
    assert plogits.shape == (B, T, pcfg.vocab_padded)
    _close(plogits, rlogits)
    assert float(aux) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_reference(case):
    rcfg, pcfg, params, model, toks, frames, steps = _setup(case)
    max_len = T + NEW + 2
    rlogits, rcache = rencdec.prefill(rcfg, params, jnp.asarray(toks),
                                      jnp.asarray(frames), max_len)
    with torch.no_grad():
        plogits, pcache = encdec.prefill(pcfg, model, torch.from_numpy(toks),
                                         torch.from_numpy(frames), max_len)
    _close(plogits, rlogits)
    # the cross cache holds the memory's K/V, one row per frame
    assert pcache["cross"]["k"].shape == (pcfg.n_layers, B, T_ENC,
                                          pcfg.n_kv_heads, pcfg.head_dim)
    _close_cache(pcfg, pcache, rcache)
    for i, tok in enumerate(steps):
        rlogits, rcache = rencdec.decode_step(
            rcfg, params, rcache, jnp.asarray(tok), jnp.asarray(T + i))
        with torch.no_grad():
            plogits, pcache = encdec.decode_step(
                pcfg, model, pcache, torch.from_numpy(tok).long(), T + i)
        _close(plogits, rlogits, what=f"step {i}")
    _close_cache(pcfg, pcache, rcache)


@pytest.mark.parametrize("max_len,enc_len", [(40, 0), (12, 0), (40, 7)])
def test_init_cache_matches_reference(max_len, enc_len):
    rcfg, pcfg, *_ = _setup("plain")
    want = rapi.init_cache(rcfg, B, max_len, enc_len=enc_len)
    got = api.init_cache(pcfg, B, max_len, device="cpu", enc_len=enc_len)
    _close_cache(pcfg, got, want)


def test_loss_and_gradients_match_reference():
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 512, (2, 24)).astype(np.int32),
             "frames": rng.standard_normal((2, 6, 128)).astype(np.float32)}
    out = loss_and_grads(ARCH, batch)
    np.testing.assert_allclose(*out["loss"], rtol=1e-5)
    assert out["aux"] == (0.0, 0.0)
    assert any("cross_attn" in k for k in out["grads"])
    for leaf, (diff, scale) in out["grads"].items():
        assert diff <= 1e-4 * (scale or 1.0), (leaf, diff, scale)


def test_params_to_reference_inverts_params_from_reference():
    _, pcfg, params, model, *_ = _setup("qkv_bias")
    back = convert.params_to_reference(pcfg, model)
    want = jax.device_get(params)
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(back)[0]}
    ref_flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat.keys() == ref_flat.keys()
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_train_launcher_feeds_the_frames():
    """`launch.train` on the audio config: the data pipeline's frames reach
    the encoder (a batch without them would raise), and the loss is
    finite."""
    out = train(ARCH, steps=2, seq_len=16, batch=2, device="cpu",
                log_every=1)
    assert out["steps"] == 2
    assert all(np.isfinite(out["losses"]))
