"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX reference,
on the CPU.

Weights come from the reference's initialiser (the whole scaled-down
model, carried over with `convert.params_from_reference`); the MoE layer's
input is drawn with numpy.  Configs: deepseek-moe-16b scaled down (4
routed experts, top-2, one shared expert, the first layer dense) and
llama4-maverick scaled down (top-1, MoE on every second layer, a shared
expert), with the port's one dispatch (stable-argsort positions) against
the reference in both its dispatch modes (the stable-argsort positions and
the one-hot cumsum), with a capacity that drops tokens (capacity factor
0.5) and one that cannot (capacity factor E / k: every expert has room for
every token).

Routing is discontinuous: a token whose k-th and (k+1)-th router
probabilities lie within rounding of each other could pick another
expert in each package.  The tests compare the routing (``top_i``, each
entry's rank in its expert, the keep mask) exactly, and assert that the
smallest top-k margin at their seed exceeds MIN_MARGIN, so a flip would
show as that assertion.

Bounds, with what was measured (CPU, jax 0.9.0, torch 2.13): the output
``y`` within atol = rtol = 1e-5 (measured at most 7.2e-7, |y| up to 4.3);
the auxiliary loss within rtol 1e-6 (measured equal, or 1 ulp apart).  The
smallest top-k margin measured: 4.3e-4 (deepseek), 6.4e-3 (llama4).
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import loss_and_grads, reference_layer

from repro.configs import get_config as ref_get_config
from repro.models import api as rapi
from repro.models import moe as rmoe

from repro_torch.configs import get_config
from repro_torch.models import api, convert, moe

Y_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_RTOL = 1e-6
MIN_MARGIN = 1e-5
B, T = 2, 24
ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]


def _positions_cumsum(flat_e, n_experts: int):
    """Each entry's rank within its expert by a one-hot cumsum: the
    reference's other dispatch mode, an oracle for `_positions_sort`."""
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]


def _no_drop_factor(cfg) -> float:
    """A capacity factor that gives every expert room for every token."""
    return cfg.moe.n_experts / cfg.moe.top_k


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg = ref_get_config(arch).scaled_down()
    pcfg = get_config(arch).scaled_down()
    params = jax.device_get(rapi.init_params(rcfg, jax.random.PRNGKey(0)))
    model = convert.params_from_reference(pcfg, params, device="cpu")
    # the first MoE layer: its reference subtree and the port's module
    i = next(i for i, blk in enumerate(model.layers) if blk.ffn_kind == "moe")
    sub = reference_layer(params, convert._layer_slots(pcfg)[i])["moe"]
    rng = np.random.default_rng(sum(map(ord, arch)))
    x = rng.standard_normal((B, T, pcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, sub, model.layers[i].moe, x


def _ref_routing(rcfg, p, x):
    """The reference's routing, by its own lines (``moe_forward`` returns
    only y and aux): probs, top_i and each entry's rank in its expert."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), axis=-1)
    _, top_i = jax.lax.top_k(probs, rcfg.moe.top_k)
    flat_e = top_i.reshape(-1)
    pos = (rmoe._positions_sort(flat_e, rcfg.moe.n_experts)
           if rmoe.DISPATCH_MODE == "sort"
           else rmoe._positions_cumsum(flat_e, rcfg.moe.n_experts))
    return np.asarray(probs), np.asarray(top_i), np.asarray(pos)


CASES = [(arch, mode, drops) for arch in ARCHS
         for mode in ("sort", "cumsum") for drops in (True, False)]


@pytest.mark.parametrize("arch,mode,drops", CASES,
                         ids=[f"{a}-{m}-{'drops' if d else 'nodrop'}"
                              for a, m, d in CASES])
def test_moe_forward_matches_reference(arch, mode, drops, monkeypatch):
    rcfg, pcfg, p, module, x = _setup(arch)
    factor = 0.5 if drops else _no_drop_factor(pcfg)
    rcfg = dataclasses.replace(rcfg, capacity_factor=factor)
    pcfg = dataclasses.replace(pcfg, capacity_factor=factor)
    monkeypatch.setattr(rmoe, "DISPATCH_MODE", mode)
    ry, raux = rmoe.moe_forward(p, rcfg, jnp.asarray(x))
    rprobs, rtop_i, rpos = _ref_routing(rcfg, p, x)

    xt = torch.from_numpy(x)
    with torch.no_grad():
        py, paux = moe.moe_forward(module, pcfg, xt)
        probs, _, top_i = moe.route(module, pcfg, xt.reshape(B * T, -1))
        pos, keep, slot = moe.dispatch(top_i.reshape(-1), pcfg,
                                       moe.expert_capacity(B * T, pcfg))

    margin = float(moe.topk_margin(probs, pcfg.moe.top_k).min())
    assert margin > MIN_MARGIN, f"a routing choice within {margin} of a flip"
    np.testing.assert_array_equal(top_i.numpy(), rtop_i)
    np.testing.assert_array_equal(pos.numpy(), rpos)
    cap = rmoe.expert_capacity(B * T, rcfg)
    assert cap == moe.expert_capacity(B * T, pcfg)
    np.testing.assert_array_equal(keep.numpy(), rpos < cap)
    # the case drops tokens, or none
    assert bool((~keep).any()) is drops
    assert int(slot[~keep].abs().sum()) == 0
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **Y_TOL)
    np.testing.assert_allclose(float(paux), float(raux), rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sort_and_cumsum_positions_are_equal(arch):
    _, pcfg, _, _, _ = _setup(arch)
    gen = torch.Generator().manual_seed(7)
    flat_e = torch.randint(0, pcfg.moe.n_experts, (300,), generator=gen)
    assert torch.equal(moe._positions_sort(flat_e, pcfg.moe.n_experts),
                       _positions_cumsum(flat_e, pcfg.moe.n_experts))


def test_dropped_tokens_contribute_only_the_shared_experts():
    """With capacity 4 and every token routed to the same experts, the
    tokens past the fourth of each expert get only the shared experts'
    output: earlier tokens win."""
    _, pcfg, _, module, _ = _setup("deepseek-moe-16b")
    module = copy.deepcopy(module)
    k = pcfg.moe.top_k
    x = torch.randn((1, 12, pcfg.d_model),
                    generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        module.router.zero_()
        module.router[:, :k] = 1.0           # every token picks experts 0..k-1
        x = x.abs()                          # ... by a clear margin
        cfg = dataclasses.replace(pcfg, capacity_factor=1e-3)
        assert moe.expert_capacity(12, cfg) == 4
        y, _ = moe.moe_forward(module, cfg, x)
        shared = moe.layers.mlp(module.shared, x[0])
    torch.testing.assert_close(y[0, 4:], shared[4:], rtol=0, atol=0)
    assert float((y[0, :4] - shared[:4]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_model_routing_margins_at_the_seed(arch, monkeypatch):
    """Every routing decision of the prompt that tests/test_torch_models.py
    runs through forward and prefill (the same seed, shape and weights)
    lies further than MIN_MARGIN from a flip, through the whole model."""
    _, pcfg, _, _, _ = _setup(arch)
    params = jax.device_get(rapi.init_params(
        ref_get_config(arch).scaled_down(), jax.random.PRNGKey(0)))
    model = convert.params_from_reference(pcfg, params, device="cpu")
    margins = []
    route = moe.route

    def recorded(params, cfg, xf):
        probs, top_w, top_i = route(params, cfg, xf)
        margins.append(float(moe.topk_margin(probs, cfg.moe.top_k).min()))
        return probs, top_w, top_i
    monkeypatch.setattr(moe, "route", recorded)
    rng = np.random.default_rng(sum(map(ord, arch)))
    toks = torch.from_numpy(
        rng.integers(0, pcfg.vocab, (B, T)).astype(np.int64))
    with torch.no_grad():
        api.forward(pcfg, model, {"tokens": toks})
    n_moe = sum(blk.ffn_kind == "moe" for blk in model.layers)
    assert len(margins) == n_moe >= 1
    assert min(margins) > MIN_MARGIN, margins


def test_loss_and_gradients_match_reference():
    """`loss_fn` (cross-entropy plus 0.01 x the summed load-balance loss)
    and its gradients against the reference's ``jax.grad``: deepseek
    scaled down, tokens from numpy.  Loss within rtol 1e-5, aux within
    AUX_RTOL, each gradient leaf within 1e-4 of its largest magnitude
    (test_torch_train.py's bounds; measured 1.4e-7, equal, and 1.4e-6 of
    the leaf at most, the router's)."""
    toks = np.random.default_rng(5).integers(0, 512, (2, 24)
                                             ).astype(np.int32)
    out = loss_and_grads("deepseek-moe-16b", {"tokens": toks})
    np.testing.assert_allclose(*out["loss"], rtol=1e-5)
    np.testing.assert_allclose(*out["aux"], rtol=AUX_RTOL)
    assert out["aux"][0] > 0
    assert any("moe" in k and "router" in k for k in out["grads"])
    for leaf, (diff, scale) in out["grads"].items():
        assert diff <= 1e-4 * (scale or 1.0), (leaf, diff, scale)
