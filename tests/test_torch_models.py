"""The port's language-model stack against the JAX reference, on the CPU.

Parameters come from the reference's own initialiser and are carried over
with `convert.params_from_reference`; prompts, patches and decode tokens
are drawn with numpy and handed to both packages.  The reference runs with
``use_kernel=False`` (its jnp `attend` and associative `scan_rg_lru`, the
oracles of its Pallas kernels), the port likewise.

Configs: recurrentgemma-2b scaled down to 8 layers with a 16-token window
and a 40-token prompt, so the ring cache wraps and the 2-block tail after
the two groups runs; gemma2-27b with an 8-token window (softcaps,
post-norm, local attention); qwen3-1.7b (qk-norm), olmo-1b
(non-parametric norm), qwen1.5-4b (QKV bias), internvl2-1b (vision
patches), deepseek-moe-16b (a dense lead layer, then MoE with a shared
expert), llama4-maverick (dense and MoE layers interleaved), xlstm-125m
(mLSTM and sLSTM blocks, their recurrent caches) and seamless-m4t-medium
(the encoder-decoder over numpy frames: self and cross caches), all scaled
down.  The MoE configs' routing at these seeds lies at least 4.3e-4 from a
flip (tests/test_torch_moe.py), and their auxiliary loss is compared too.

Tolerances.  The two packages round differently (XLA fuses `a*b+c` into
FMAs and sums in another order; torch's `tanh`/`sin`/`pow` differ by ulps,
and the reference's associative scan associates otherwise than the port's
log-depth scan).  Measured on the CPU (jax 0.9.0, torch 2.13): logits
within 2.2e-6 absolute (largest logit ~3.2), caches within 5.3e-6.  The
bounds below are about 5x and 10x those: atol 1e-5 / rtol 1e-5 on logits,
atol 5e-5 / rtol 1e-5 on caches; ring positions exactly.  The auxiliary
loss within rtol 1e-6 (measured 1-2 ulp).  xlstm-125m comes closest to
them: its mLSTM's cumulative log-gates are summed in another order, and
the parallel form divides by their exponentials (forward logits 9.3e-6,
prefill 4.5e-6, decode 5.6e-6; caches 2.9e-5, in the last block's conv
state, the residual stream after seven blocks, up to 3.7); the other new
configs stay under 2.7e-6.

bf16 prefill (the dry run's serving dtype): the same float32 weights cast
to bfloat16 on both sides (round to nearest even, so the bf16 weights are
equal), the patches left float32, as both packages take them.  The two
round their bf16 activations at other points (XLA keeps a fusion's
intermediates in float32, eager torch rounds after every op), so they
differ by about as much as bf16 does from float32.  Each logit and cache
array is held within `BF16_REL_TOL` of its largest value in the
reference's result: measured 2.7e-2 (logits) and 2.5e-2 (caches) for
recurrentgemma-2b, 5.1e-3 and 6.3e-3 for internvl2-1b, 6.0e-3 and 4.3e-3
for deepseek-moe-16b, 7.2e-3 and 8.2e-3 for seamless-m4t-medium.
xlstm-125m reads 1.9e-1 (logits) and up to 1.8e-1 (caches): each
package's bf16 prefill is as far from the float32 prefill of the same
weights (logits 1.49e-1 for the reference, 1.43e-1 for the port; the
first block's cell state C already 8.7e-2 and 6.4e-2), through the
mLSTM's and sLSTM's exponential gates and their cumulative sums, which
each package rounds at its own points, so neither is at fault; that case
is a strict xfail (`scripts/bf16_prefill_gap.py` measures all three).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import api as rapi

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api, convert

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=5e-5, rtol=1e-5)
BATCH = 2

# arch -> (scaled_down overrides, prompt length)
CASES = {
    "recurrentgemma-2b": (dict(window=16, n_layers=8), 40),
    "gemma2-27b": (dict(window=8), 24),
    "qwen3-1.7b": ({}, 24),
    "olmo-1b": ({}, 24),
    "qwen1.5-4b": ({}, 24),
    "internvl2-1b": ({}, 16),
    "deepseek-moe-16b": ({}, 24),
    "llama4-maverick-400b-a17b": ({}, 24),
    "xlstm-125m": ({}, 24),
    "seamless-m4t-medium": ({}, 24),
}
AUX_RTOL = 1e-6
BF16_REL_TOL = 5e-2
# the prefill cases: every config in float32; in bf16 too the two serving
# configs of the dry run's card cells and the MoE, xLSTM and
# encoder-decoder families
XLSTM_BF16_GAP = pytest.mark.xfail(strict=True, reason=(
    "xLSTM's bf16 prefill: the two packages differ by 1.9e-1 of the largest "
    "logit, each 1.4e-1-1.5e-1 from the float32 prefill; both round the "
    "exponential gates at their own points"))
PREFILL_CASES = ([pytest.param(arch, "float32", id=arch) for arch in CASES]
                 + [pytest.param(arch, "bfloat16", id=f"{arch}-bfloat16",
                                 marks=XLSTM_BF16_GAP if arch == "xlstm-125m"
                                 else ())
                    for arch in ("recurrentgemma-2b", "internvl2-1b",
                                 "deepseek-moe-16b", "xlstm-125m",
                                 "seamless-m4t-medium")])


@functools.lru_cache(maxsize=None)
def _setup(arch):
    over, prompt = CASES[arch]
    rcfg = ref_get_config(arch).scaled_down(**over)
    pcfg = get_config(arch).scaled_down(**over)
    params = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    model = convert.params_from_reference(pcfg, jax.device_get(params),
                                          device="cpu")
    rng = np.random.default_rng(sum(map(ord, arch)))
    toks = rng.integers(0, pcfg.vocab, (BATCH, prompt)).astype(np.int32)
    rbatch = {"tokens": jnp.asarray(toks)}
    pbatch = {"tokens": torch.from_numpy(toks).long()}
    n_pos = prompt
    if pcfg.family == "vlm":
        pat = rng.standard_normal(
            (BATCH, pcfg.vision_tokens, pcfg.vit_dim)).astype(np.float32)
        rbatch["patches"] = jnp.asarray(pat)
        pbatch["patches"] = torch.from_numpy(pat)
        n_pos += pcfg.vision_tokens
    if pcfg.family == "audio":
        frames = rng.standard_normal(
            (BATCH, prompt // pcfg.enc_seq_divisor, pcfg.d_model)
        ).astype(np.float32)
        rbatch["frames"] = jnp.asarray(frames)
        pbatch["frames"] = torch.from_numpy(frames)
    decode_toks = rng.integers(0, pcfg.vocab, (4, BATCH)).astype(np.int32)
    return dict(rcfg=rcfg, pcfg=pcfg, params=params, model=model,
                rbatch=rbatch, pbatch=pbatch, n_pos=n_pos,
                max_len=n_pos + 8, decode_toks=decode_toks)


def _prefill_both(s, dtype="float32"):
    params, model = s["params"], s["model"]
    if dtype != "float32":
        params = jax.tree.map(lambda x: x.astype(dtype), params)
        model = convert.params_from_reference(
            s["pcfg"], jax.device_get(s["params"]), device="cpu"
        ).to(getattr(torch, dtype))
    rlogits, rcache = rapi.prefill(s["rcfg"], params, s["rbatch"],
                                   s["max_len"])
    with torch.no_grad():
        plogits, pcache = api.prefill(s["pcfg"], model, s["pbatch"],
                                      s["max_len"])
    return rlogits, rcache, plogits, pcache


def _leaves(tree):
    """(path, leaf) pairs of a nested dict, by sorted key."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += [((k,) + p, x) for p, x in _leaves(v)]
        else:
            out.append(((k,), v))
    return out


def _assert_caches_close(want_tree, got_tree):
    want = _leaves(jax.device_get(want_tree))
    got = _leaves(got_tree)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        w = np.asarray(w)
        assert w.shape == g.shape, (path, w.shape, g.shape)
        if path[-1] == "pos":
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, err_msg=str(path), **CACHE_TOL)


def test_ported_configs_equal_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        want = dataclasses.asdict(ref_get_config(arch))
        assert dataclasses.asdict(get_config(arch)) == want, arch
        assert (dataclasses.asdict(get_config(arch).scaled_down())
                == dataclasses.asdict(ref_get_config(arch).scaled_down()))


def _float32(tree):
    """A cache with its floating tensors in float32 (numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _assert_bf16_close(want, got, what):
    """Within BF16_REL_TOL of the largest |value| of ``want``."""
    want = np.asarray(want, dtype=np.float32)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = float(np.abs(got - want).max())
    assert err <= BF16_REL_TOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("arch,dtype", PREFILL_CASES)
def test_prefill_matches_reference(arch, dtype):
    s = _setup(arch)
    rlogits, rcache, plogits, pcache = _prefill_both(s, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(plogits.numpy(), np.asarray(rlogits),
                                   **LOGIT_TOL)
        _assert_caches_close(rcache, convert.cache_to_reference_layout(
            s["pcfg"], pcache))
        return
    assert plogits.dtype == torch.bfloat16 and rlogits.dtype == jnp.bfloat16
    assert {t.dtype for entry in pcache.values() for t in entry.values()
            if t.is_floating_point()} == {torch.bfloat16}
    _assert_bf16_close(rlogits, plogits.float().numpy(), "logits")
    want = _leaves(jax.device_get(rcache))
    got = _leaves(convert.cache_to_reference_layout(s["pcfg"],
                                                    _float32(pcache)))
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        if path[-1] == "pos":
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
        else:
            assert np.asarray(w).dtype == jnp.bfloat16, path
            _assert_bf16_close(w, g, path)


def test_recurrentgemma_case_wraps_the_ring_and_runs_the_tail():
    s = _setup("recurrentgemma-2b")
    cfg = s["pcfg"]
    assert cfg.n_layers % len(cfg.block_pattern) == 2      # 2-block tail
    assert s["n_pos"] > cfg.window                          # ring wraps
    _, _, _, pcache = _prefill_both(s)
    layout = convert.cache_to_reference_layout(cfg, pcache)
    assert set(layout) == {"groups", "tail"}
    ring = layout["groups"]["b2"]["pos"]
    assert ring.shape == (2, cfg.window)
    assert ring.min() == s["n_pos"] - cfg.window and ring.max() == s["n_pos"] - 1


@pytest.mark.parametrize("arch", list(CASES))
def test_forward_matches_reference(arch):
    s = _setup(arch)
    rlogits, raux = rapi.forward(s["rcfg"], s["params"], s["rbatch"])
    with torch.no_grad():
        plogits, aux = api.forward(s["pcfg"], s["model"], s["pbatch"])
    np.testing.assert_allclose(plogits.numpy(), np.asarray(rlogits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=AUX_RTOL)
    assert (float(aux) > 0) is (s["pcfg"].moe is not None)


@pytest.mark.parametrize("arch", list(CASES))
def test_teacher_forced_decode_matches_reference(arch):
    s = _setup(arch)
    _, rcache, _, pcache = _prefill_both(s)
    for step, tok in enumerate(s["decode_toks"]):
        index = s["n_pos"] + step
        rlogits, rcache = rapi.decode_step(s["rcfg"], s["params"], rcache,
                                           jnp.asarray(tok),
                                           jnp.asarray(index, jnp.int32))
        with torch.no_grad():
            plogits, pcache = api.decode_step(
                s["pcfg"], s["model"], pcache, torch.from_numpy(tok).long(),
                index)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(rlogits),
                                   err_msg=f"step {step}", **LOGIT_TOL)
    _assert_caches_close(rcache,
                         convert.cache_to_reference_layout(s["pcfg"], pcache))


def test_params_from_reference_rejects_a_wrong_shape():
    s = _setup("qwen3-1.7b")
    tree = jax.device_get(s["params"])
    tree["embed"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_reference(s["pcfg"], tree, device="cpu")
