"""The port's training step against the JAX reference, and the LM kernels'
backward passes, on the CPU.

Weights come from the reference's initialiser (carried over with
`convert.params_from_reference`); gradients, parameters and moments come
back with `convert.params_to_reference` and are compared leaf by leaf.
Tokens are drawn with numpy.  Configs: recurrentgemma-2b scaled down to 5
layers (one remat group of (rec, rec, attn_local) and a 2-block tail) with
a 16-token window under a 40-token sequence, olmo-1b scaled down
(non-parametric norm, plain attention), deepseek-moe-16b scaled down (its
auxiliary loss weighs in, and the metrics carry it) and xlstm-125m scaled
down.  The reference runs with
``use_kernel=False`` unless a test says otherwise; its step is jitted.

Bounds, with what was measured (CPU, jax 0.9.0, torch 2.13):

* loss: relative 1e-5; measured equal for the plain path, ~1e-7 against
  the reference's kernels in interpret mode;
* each gradient leaf: max |diff| <= 1e-4 * max |g| of that leaf; measured
  at most ~3e-6 (the recurrent block's conv weights);
* parameters after two steps: max |diff| <= 1e-5 * max |p|, the largest
  magnitude of any parameter (a leaf that starts at zero, a norm scale,
  holds only two steps' updates, and AdamW's update of an element is a
  ratio of its own gradients, so the gradients' rounding shows there at
  ~2e-5 of the leaf); measured at most 3.5e-7 of max |p|; the moments
  and the top-k residual by the gradients' bound, measured at most 4e-6
  (2.4e-5 for the residual).

Top-k compression keeps the entries at or above the k-th magnitude; two
entries whose magnitudes tie within the gradients' rounding may take the
k-th place in one package each.  The microbatched top-k case allows at
most one such swap a leaf and step, found where the two residuals
disagree on being zero, with the two magnitudes within 1e-4 of each other
(measured: one swap, in ``tail.1.ffn.down`` at the first step, 7.6290e-4
against 7.6290e-4, 1.5e-6 apart), and holds every other entry to the
bounds above.

Inside the port, ``remat=True`` equals ``remat=False`` bit for bit, and the
backward passes of the kernels' ``torch.autograd.Function``s equal
autograd through their plain versions bit for bit (`torch.equal`): the
RG-LRU reverse scan against the sequential loop, flash's recomputed VJP
against the dense attention.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import load_reference, reference_modules

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as trl
from repro_torch.models import convert
from repro_torch.optim import CompressionConfig
from repro_torch.train import (TrainHyper, init_train_state, loss_fn,
                               make_train_step)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_REL = 1e-5
BATCH, SEQ = 2, 40

CASES = {
    "recurrentgemma-2b": dict(n_layers=5, window=16),
    "olmo-1b": {},
    # the MoE load-balance loss in the loss and the metrics; the xLSTM
    # blocks' recurrences under remat
    "deepseek-moe-16b": {},
    "xlstm-125m": {},
}


def _ref():
    return load_reference()


def _hypers(**kw):
    ro = _ref()["repro.optim"]
    rts = _ref()["repro.train.train_step"]
    comp = kw.pop("compression", None)
    rh = rts.TrainHyper(warmup=1, **kw,
                        compression=ro.CompressionConfig(**comp)
                        if comp else ro.CompressionConfig())
    ph = TrainHyper(warmup=1, **kw,
                    compression=CompressionConfig(**comp)
                    if comp else CompressionConfig())
    return rh, ph


@functools.lru_cache(maxsize=None)
def _configs(arch):
    rcfg = _ref()["repro.configs"].get_config(arch).scaled_down(**CASES[arch])
    return rcfg, get_config(arch).scaled_down(**CASES[arch])


def _tokens(seed, shape=(BATCH, SEQ), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _port_state(pcfg, ph, rparams):
    state = init_train_state(pcfg, ph, device="cpu")
    model = convert.params_from_reference(pcfg, jax.device_get(rparams),
                                          device="cpu")
    return state._replace(model=model)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


def _assert_leaves_close(got, want, rel, what, scale=None, skip=None):
    """Each leaf: max |got - want| <= rel * (``scale``, else the leaf's max
    |want|), over the entries ``skip`` (a dict of masks by leaf) leaves."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), set(g) ^ set(w)
    for k in w:
        keep = ~skip[k] if skip else np.ones(w[k].shape, bool)
        leaf_scale = scale or float(np.abs(w[k]).max()) or 1.0
        diff = float(np.abs(g[k] - w[k])[keep].max(initial=0.0))
        assert diff <= rel * leaf_scale, \
            f"{what} {k}: {diff} > {rel} * {leaf_scale}"


def _max_abs(tree) -> float:
    return max(float(np.abs(v).max()) for v in _flat(tree).values())


def _ref_value_and_grad(rcfg, rh, rparams, toks):
    rts = _ref()["repro.train.train_step"]
    (loss, _), grads = jax.value_and_grad(
        lambda p: rts.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}, rh),
        has_aux=True)(rparams)
    return float(loss), grads


def _port_value_and_grad(pcfg, ph, model, toks):
    params = dict(model.named_parameters())
    loss, _ = loss_fn(pcfg, model, {"tokens": torch.from_numpy(toks)}, ph)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    rcfg, _ = _configs(arch)
    rh, _ = _hypers()
    return _ref()["repro.train.train_step"].init_train_state(
        rcfg, rh, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_gradients_match_reference(arch):
    rcfg, pcfg = _configs(arch)
    rh, ph = _hypers()
    rstate = _ref_init(arch)
    toks = _tokens(1)
    rloss, rgrads = _ref_value_and_grad(rcfg, rh, rstate.params, toks)
    model = _port_state(pcfg, ph, rstate.params).model
    ploss, pgrads = _port_value_and_grad(pcfg, ph, model, toks)
    np.testing.assert_allclose(float(ploss), rloss, rtol=LOSS_RTOL)
    _assert_leaves_close(convert.params_to_reference(pcfg, pgrads), rgrads,
                         GRAD_REL, "gradient")


def _two_steps(arch, toks_seeds=(2, 3), microbatches=1, skip=None,
               **hyper):
    rcfg, pcfg = _configs(arch)
    rh, ph = _hypers(microbatches=microbatches, **hyper)
    rts = _ref()["repro.train.train_step"]
    rstate = rts.init_train_state(rcfg, rh, jax.random.PRNGKey(0))
    pstate = _port_state(pcfg, ph, rstate.params)
    rstep = jax.jit(rts.make_train_step(rcfg, rh))
    pstep = make_train_step(pcfg, ph)
    shape = ((microbatches, BATCH // microbatches, SEQ) if microbatches > 1
             else (BATCH, SEQ))
    losses, flips = [], None
    for seed in toks_seeds:
        toks = _tokens(seed, shape)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks)})
        pstate, pm = pstep(pstate, {"tokens": torch.from_numpy(toks)})
        if skip:            # entries excused from here on, step by step
            new = skip(pcfg, pstate, rstate)
            flips = new if flips is None else {k: flips[k] | new[k]
                                               for k in new}
        losses.append((float(pm["loss"]), float(rm["loss"])))
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["lr_scale"]),
                                   float(rm["lr_scale"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["aux"]), float(rm["aux"]),
                                   rtol=LOSS_RTOL)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert int(pstate.step) == int(rstate.step) == len(toks_seeds)
    _assert_leaves_close(convert.params_to_reference(pcfg, pstate.model),
                         rstate.params, PARAM_REL, "parameter",
                         scale=_max_abs(rstate.params), skip=flips)
    for which in ("m", "v"):
        _assert_leaves_close(
            convert.params_to_reference(pcfg, getattr(pstate.opt, which)),
            getattr(rstate.opt, which), GRAD_REL, f"moment {which}",
            skip=flips)
    return pcfg, pstate, rstate, flips


@pytest.mark.parametrize("arch", list(CASES))
def test_two_train_steps_match_reference(arch):
    _two_steps(arch)


def _topk_flips(pcfg, pstate, rstate) -> dict:
    """Entries one package sent this step and the other kept in its
    residual (a residual is exactly 0 where its entry was sent).  The only
    difference allowed is a swap at the k-th place: in a leaf, two entries,
    each kept by one package, whose magnitudes agree within the gradients'
    bound."""
    mine = _flat(convert.params_to_reference(pcfg, pstate.residual))
    theirs = _flat(rstate.residual)
    flips = {k: (mine[k] == 0) != (theirs[k] == 0) for k in theirs}
    for k, f in flips.items():
        if not f.any():
            continue
        kept = np.abs(mine[k][f] + theirs[k][f])    # one of each is 0
        assert len(kept) == 2 and (mine[k][f] == 0).sum() == 1, (k, kept)
        assert abs(kept[0] - kept[1]) <= GRAD_REL * kept.max(), (k, kept)
    return flips


def test_microbatches_and_topk_compression_match_reference():
    pcfg, pstate, rstate, flips = _two_steps(
        "recurrentgemma-2b", microbatches=2, skip=_topk_flips,
        compression=dict(scheme="topk", topk_frac=0.1))
    _assert_leaves_close(convert.params_to_reference(pcfg, pstate.residual),
                         rstate.residual, GRAD_REL, "residual", skip=flips)


def test_gradients_match_the_reference_kernels_in_interpret_mode():
    """The reference with ``use_kernel=True``: its Pallas kernels in
    interpret mode and their ``custom_vjp`` backward (the dense attention's
    and the associative scan's VJPs)."""
    arch = "recurrentgemma-2b"
    rcfg, pcfg = _configs(arch)
    rh, ph = _hypers()
    rh = dataclasses.replace(rh, use_kernel=True)
    rstate = _ref_init(arch)
    toks = _tokens(4)
    with reference_modules():
        rloss, rgrads = _ref_value_and_grad(rcfg, rh, rstate.params, toks)
    model = _port_state(pcfg, ph, rstate.params).model
    ploss, pgrads = _port_value_and_grad(pcfg, ph, model, toks)
    np.testing.assert_allclose(float(ploss), rloss, rtol=LOSS_RTOL)
    _assert_leaves_close(convert.params_to_reference(pcfg, pgrads), rgrads,
                         GRAD_REL, "gradient")


@pytest.mark.parametrize("arch", list(CASES))
def test_remat_equals_no_remat_bitwise(arch):
    _, pcfg = _configs(arch)
    _, ph = _hypers()
    model = _port_state(pcfg, ph, _ref_init(arch).params).model
    toks = _tokens(5)
    out = [_port_value_and_grad(pcfg, dataclasses.replace(ph, remat=r),
                                model, toks) for r in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name


def test_kernel_wrappers_in_the_model_match_the_plain_path():
    """``use_kernel=True`` on the CPU runs the kernels' autograd Functions
    around their plain versions (the sequential scan, the dense attention):
    their gradients agree with the model's own plain path by the reference
    bound."""
    _, pcfg = _configs("recurrentgemma-2b")
    _, ph = _hypers()
    model = _port_state(pcfg, ph, _ref_init("recurrentgemma-2b").params).model
    toks = _tokens(6)
    before = (tfa.LAUNCH_COUNT, trl.LAUNCH_COUNT)
    lk, gk = _port_value_and_grad(
        pcfg, dataclasses.replace(ph, use_kernel=True), model, toks)
    assert (tfa.LAUNCH_COUNT, trl.LAUNCH_COUNT) == before
    lp, gp = _port_value_and_grad(pcfg, ph, model, toks)
    np.testing.assert_allclose(float(lk), float(lp), rtol=LOSS_RTOL)
    _assert_leaves_close(convert.params_to_reference(pcfg, gk),
                         convert.params_to_reference(pcfg, gp), GRAD_REL,
                         "gradient")


@pytest.mark.parametrize("arch", list(CASES))
def test_params_to_reference_inverts_params_from_reference(arch):
    rcfg, pcfg = _configs(arch)
    rparams = _ref_init(arch).params
    model = convert.params_from_reference(pcfg, jax.device_get(rparams),
                                          device="cpu")
    back = _flat(convert.params_to_reference(pcfg, model))
    want = _flat(rparams)       # a non-parametric norm is no leaf
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def test_train_state_holds_the_model_moments_and_step():
    _, pcfg = _configs("olmo-1b")
    ph = TrainHyper(compression=CompressionConfig(scheme="int8"),
                    param_dtype="bfloat16")
    state = init_train_state(pcfg, ph, torch.Generator().manual_seed(0),
                             device="cpu")
    names = [n for n, _ in state.model.named_parameters()]
    assert list(state.opt.m) == names == list(state.residual)
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    assert state.residual[names[0]].dtype == torch.float32
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    with pytest.raises(ValueError, match="leading dim 2"):
        make_train_step(pcfg, dataclasses.replace(ph, microbatches=2))(
            state, {"tokens": torch.zeros((3, 4, 8), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# the kernels' backward passes, on the CPU (their plain versions)
# ---------------------------------------------------------------------------

# (B, T, D, dtype, h0): a ragged D, T = 1 (with and without h0), bf16
RGLRU_GRAD_CASES = [
    (2, 33, 130, torch.float32, False), (2, 33, 130, torch.float32, True),
    (3, 1, 16, torch.float32, False), (3, 1, 16, torch.float32, True),
    (2, 17, 8, torch.bfloat16, True), (1, 64, 40, torch.float32, True),
]


def _rglru_grad_inputs(b, t, d, dtype, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.2, 0.99, (b, t, d)).astype(np.float32))
    x, g = (torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)) for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return [v.to(dtype) for v in (a, x, h0, g)]


@pytest.mark.parametrize("case", RGLRU_GRAD_CASES, ids=str)
def test_rg_lru_backward_equals_autograd_through_the_plain_loop(case):
    b, t, d, dtype, with_h0 = case
    a, x, h0, g = _rglru_grad_inputs(b, t, d, dtype, seed=b * t + d)
    h0 = h0 if with_h0 else None
    ins = [v.clone().requires_grad_(True) for v in (a, x)]
    ins += [h0.clone().requires_grad_(True)] if with_h0 else []
    got = torch.autograd.grad(trl.rg_lru(ins[0], ins[1], *ins[2:]), ins, g)
    ref_ins = [v.clone().requires_grad_(True) for v in ins]
    want = torch.autograd.grad(
        tref.ref_rg_lru(ref_ins[0], ref_ins[1], *ref_ins[2:]), ref_ins, g)
    for name, x_got, x_want in zip(("da", "db", "dh0"), got, want):
        assert x_got.dtype == dtype
        assert torch.equal(x_got, x_want), name


def test_rg_lru_reverse_scan_is_the_gradient_recurrence():
    a, _, _, g = _rglru_grad_inputs(2, 9, 5, torch.float32, seed=1)
    gh = trl.reverse_scan(a, g)
    want = torch.empty_like(g)
    acc = torch.zeros_like(g[:, 0])
    for t in reversed(range(9)):
        nxt = a[:, t + 1] if t + 1 < 9 else torch.zeros_like(acc)
        acc = nxt * acc + g[:, t]
        want[:, t] = acc
    assert torch.equal(gh, want)


def test_rg_lru_backward_skips_inputs_without_grad():
    a, x, _, g = _rglru_grad_inputs(2, 5, 4, torch.float32, seed=2)
    xr = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(trl.rg_lru(a, xr), (xr,), g)
    assert torch.equal(dx, trl.reverse_scan(a, g))


# (B, T, S, H, KV, D, causal, window, softcap, dtype)
FLASH_GRAD_CASES = [
    (2, 16, 16, 4, 1, 32, True, 0, None, torch.float32),
    (1, 24, 24, 4, 2, 16, True, 8, None, torch.float32),
    (1, 12, 20, 2, 2, 16, False, 0, 30.0, torch.float32),
    (2, 16, 16, 2, 1, 32, True, 5, None, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=str)
def test_flash_backward_equals_autograd_through_ref_attention(case):
    b, t, s, h, kv, dh, causal, window, softcap, dtype = case
    rng = np.random.default_rng(t + s + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((b, t, h, dh), (b, s, kv, dh),
                                             (b, s, kv, dh)))
    g = torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(
        np.float32)).to(dtype)
    opts = dict(causal=causal, window=window, softcap=softcap)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*ins, **opts), ins, g)
    ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tref.ref_attention(*ref_ins, **opts),
                               ref_ins, g)
    for name, x_got, x_want in zip("qkv", got, want):
        assert torch.equal(x_got, x_want), name


def test_flash_backward_only_for_inputs_that_need_it():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    kr = k.clone().requires_grad_(True)
    out = tfa.flash_attention(q, kr, v)
    (dk,) = torch.autograd.grad(out.sum(), (kr,))
    kr2 = k.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tref.ref_attention(q, kr2, v).sum(), (kr2,))
    assert torch.equal(dk, want)
