"""The port's xLSTM blocks (`repro_torch.models.xlstm`) against the JAX
reference, on the CPU.

Weights come from the reference's initialiser (xlstm-125m scaled down:
three mLSTM blocks and an sLSTM block a group, two groups), carried over
with `convert.params_from_reference`; each block's input is drawn with
numpy.  For the first mLSTM and the first sLSTM block: the forward, the
forward with ``return_state`` (the recurrent state a decode continues
from), and one decode step from that state; the initial caches; and the
loss and gradients of `train_step.loss_fn` through the whole model.

Bounds, with what was measured (CPU, jax 0.9.0, torch 2.13): block outputs
and states within atol = rtol = 1e-5 (measured at most 1.7e-6 on outputs
up to 2.9, 4.8e-7 on the states); the loss within rtol 1e-5 (measured
7.6e-8) and each gradient leaf within 1e-4 of its largest magnitude
(test_torch_train.py's bounds; measured 3.8e-5 of it at most, the first
mLSTM block's ``conv_b``).  The mLSTM's parallel form sums its cumulative
log-gates in another order than XLA, and divides by their exponentials,
so its gradients round further from the reference than the attention
blocks' do.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import loss_and_grads, reference_layer

from repro.configs import get_config as ref_get_config
from repro.models import api as rapi
from repro.models import xlstm as rxlstm

from repro_torch.configs import get_config
from repro_torch.models import convert, xlstm

TOL = dict(atol=1e-5, rtol=1e-5)
B, T = 2, 20
ARCH = "xlstm-125m"
KINDS = ("mlstm", "slstm")
REF_FNS = {"mlstm": (rxlstm.mlstm_forward, rxlstm.mlstm_decode,
                     rxlstm.init_mlstm_cache),
           "slstm": (rxlstm.slstm_forward, rxlstm.slstm_decode,
                     rxlstm.init_slstm_cache)}
PORT_FNS = {"mlstm": (xlstm.mlstm_forward, xlstm.mlstm_decode,
                      xlstm.init_mlstm_cache),
            "slstm": (xlstm.slstm_forward, xlstm.slstm_decode,
                      xlstm.init_slstm_cache)}


@functools.lru_cache(maxsize=None)
def _setup(kind):
    rcfg = ref_get_config(ARCH).scaled_down()
    pcfg = get_config(ARCH).scaled_down()
    params = jax.device_get(rapi.init_params(rcfg, jax.random.PRNGKey(0)))
    model = convert.params_from_reference(pcfg, params, device="cpu")
    i = next(i for i, blk in enumerate(model.layers) if blk.kind == kind)
    ref_p = reference_layer(params, convert._layer_slots(pcfg)[i])[kind]
    rng = np.random.default_rng(11 + KINDS.index(kind))
    x = rng.standard_normal((B, T + 1, pcfg.d_model)).astype(np.float32)
    return rcfg, pcfg, ref_p, getattr(model.layers[i], kind), x


def _close(got: dict, want: dict, what: str):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   err_msg=f"{what} {name}", **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_reference(kind):
    rcfg, pcfg, rp, module, x = _setup(kind)
    want = REF_FNS[kind][0](rp, rcfg, jnp.asarray(x[:, :T]))
    with torch.no_grad():
        got = PORT_FNS[kind][0](module, pcfg, torch.from_numpy(x[:, :T]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_return_state_and_one_decode_step_match_reference(kind):
    rcfg, pcfg, rp, module, x = _setup(kind)
    rforward, rdecode, _ = REF_FNS[kind]
    pforward, pdecode, _ = PORT_FNS[kind]
    ry, rstate = rforward(rp, rcfg, jnp.asarray(x[:, :T]), return_state=True)
    with torch.no_grad():
        py, pstate = pforward(module, pcfg, torch.from_numpy(x[:, :T]),
                              return_state=True)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **TOL)
    _close(pstate, rstate, "state")
    # the next token continues from the state
    ry1, rstate = rdecode(rp, rcfg, jnp.asarray(x[:, T:]), rstate)
    with torch.no_grad():
        py1, pstate = pdecode(module, pcfg, torch.from_numpy(x[:, T:]),
                              pstate)
    np.testing.assert_allclose(py1.numpy(), np.asarray(ry1), **TOL)
    _close(pstate, rstate, "decoded state")


@pytest.mark.parametrize("kind", KINDS)
def test_decode_from_a_fresh_cache_matches_reference(kind):
    rcfg, pcfg, rp, module, x = _setup(kind)
    _, rdecode, rinit = REF_FNS[kind]
    _, pdecode, pinit = PORT_FNS[kind]
    rcache, pcache = rinit(rcfg, B), pinit(pcfg, B, device="cpu")
    _close(pcache, rcache, "initial cache")
    ry, rcache = rdecode(rp, rcfg, jnp.asarray(x[:, :1]), rcache)
    with torch.no_grad():
        py, pcache = pdecode(module, pcfg, torch.from_numpy(x[:, :1]),
                             pcache)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **TOL)
    _close(pcache, rcache, "cache")


def test_loss_and_gradients_match_reference():
    toks = np.random.default_rng(6).integers(0, 512, (2, 24)
                                             ).astype(np.int32)
    out = loss_and_grads(ARCH, {"tokens": toks})
    np.testing.assert_allclose(*out["loss"], rtol=1e-5)
    assert out["aux"] == (0.0, 0.0)
    assert any("slstm" in k and "r_gates" in k for k in out["grads"])
    for leaf, (diff, scale) in out["grads"].items():
        assert diff <= 1e-4 * (scale or 1.0), (leaf, diff, scale)
