"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory with exponential gating).

The port of ``repro/models/xlstm.py``.  mLSTM runs the stabilized parallel
form over a sequence (quadratic in T, like attention with cumulative
log-gates: [B, T, T, H] f32 intermediates); decode keeps the recurrent
state (C: [B, H, D, D], n: [B, H, D], m: [B, H]), constant in sequence
length.  sLSTM has a hidden-to-hidden recurrence (block-diagonal per head)
and is sequential: the forward walks time in a Python loop, one step of
torch ops per token, where the reference scans with ``lax.scan``.  Neither
recurrence has a kernel, in the reference or here.

Block structure follows the paper: mLSTM block = pre-LN -> up-projection x2
-> (conv -> q, k, v -> mLSTM) * swish(gate branch) -> down-projection;
sLSTM block = pre-LN -> conv -> 4-gate sLSTM -> group-norm -> gated FFN.
``jax.nn.softplus`` has no linear cut-off; `rglru._softplus` computes it
the same way.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.ref import f32_sqrt
from repro_torch.launch import layout
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.rglru import _softplus, conv1d_causal

Tensor = torch.Tensor

PF_MLSTM = 2.0   # mLSTM up-projection factor
PF_SLSTM = 4.0 / 3.0


def _init(generator, device):
    """The blocks' initialisers on ``device``: (dense, zeros, ones)."""
    def dense(shape, in_axis=-2, scale=1.0):
        t = dense_init(generator, shape, in_axis=in_axis, device=device)
        return nn.Parameter(t * scale if scale != 1.0 else t)

    def zeros(shape):
        return nn.Parameter(torch.zeros(shape, device=device))

    def ones(shape):
        return nn.Parameter(torch.ones(shape, device=device))
    return dense, zeros, ones


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``w_up``/``w_gate`` [d, di], ``conv_w`` [W, di], ``conv_b`` [di],
    ``wq``/``wk``/``wv`` [di, H, dh], ``w_if`` [di, H, 2], ``b_if``
    [H, 2], ``skip``/``out_norm`` [di], ``w_down`` [di, d]; di = 2 d."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        dense, zeros, ones = _init(
            generator, device if device is not None else generator.device)
        d = cfg.d_model
        di = int(PF_MLSTM * d)
        h = cfg.n_heads
        dh = di // h
        self.w_up = dense((d, di))
        self.w_gate = dense((d, di))
        self.conv_w = dense((cfg.conv_width, di), in_axis=0, scale=0.1)
        self.conv_b = zeros((di,))
        self.wq = dense((di, h, dh), in_axis=0)
        self.wk = dense((di, h, dh), in_axis=0)
        self.wv = dense((di, h, dh), in_axis=0)
        self.w_if = dense((di, h, 2), in_axis=0)    # input/forget gates
        self.b_if = zeros((h, 2))
        self.skip = ones((di,))
        self.out_norm = zeros((di,))
        self.w_down = dense((di, d))


def init_mlstm_block(cfg, generator=None, device=None) -> MLSTM:
    return MLSTM(cfg, generator, device)


def _mlstm_parallel(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor,
                    log_f: Tensor) -> Tensor:
    """Stabilized parallel mLSTM. q/k/v: [B, T, H, D]; gates: [B, T, H]."""
    t, dh = q.shape[1], q.shape[3]
    cum_f = torch.cumsum(log_f, dim=1)                      # [B,T,H]
    # D[t, s] = cum_f[t] - cum_f[s] + log_i[s]  for s <= t
    dmat = (cum_f[:, :, None, :] - cum_f[:, None, :, :]
            + log_i[:, None, :, :])                         # [B,T,S,H]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    dmat = torch.where(mask[None, :, :, None], dmat, float("-inf"))
    m = torch.amax(dmat, dim=2, keepdim=True)               # [B,T,1,H]
    w = torch.exp(dmat - m)                                 # stabilized
    del dmat
    scores = torch.einsum("bthd,bshd->btsh", q, k) / f32_sqrt(dh)
    ws = w * scores
    del w, scores
    num = torch.einsum("btsh,bshd->bthd", ws, v)
    den = torch.maximum(torch.abs(torch.sum(ws, dim=2)),
                        torch.exp(-m[:, :, 0, :]))          # [B,T,H]
    return num / den[..., None]


def _mlstm_cell(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor,
                log_f: Tensor) -> Tensor:
    """`_mlstm_parallel`; on DTensors on each device's own rows of the
    batch (every mesh axis splits the rows, `layout.by_rows`): DTensor's
    own einsums would split the flattened batch x heads, which the
    backward pass of a multi-pod mesh cannot view back."""
    return layout.on_rows(_mlstm_parallel, (q, k, v, log_i, log_f),
                          (True,) * 5, q.shape, q,
                          {d: d for d in range(q.ndim)})


def _mlstm_inputs(params: MLSTM, x: Tensor, conv_state=None):
    """The block's branches up to the cell: (gate, c, q, k, v, log_i,
    log_f, conv_state)."""
    up = x @ params.w_up
    gate = x @ params.w_gate
    c, conv_state = conv1d_causal(params, up, conv_state)
    c = F.silu(c)
    # on a mesh DTensor's einsum cannot view its result back by heads where
    # the model axis splits the contracted dimension (`layout.project_heads`)
    q = layout.project_heads(c, params.wq)
    k = layout.project_heads(c, params.wk)
    v = layout.project_heads(up, params.wv)
    gif = layout.project_heads(up, params.w_if) + params.b_if
    log_i = gif[..., 0] - _softplus(gif[..., 0])            # log sigmoid-ish
    log_f = -_softplus(-gif[..., 1])                        # log sigmoid
    return gate, c, q, k, v, log_i, log_f, conv_state


def _mlstm_out(params: MLSTM, hten: Tensor, c: Tensor, gate: Tensor
               ) -> Tensor:
    b, t = hten.shape[:2]
    # on a mesh, the gradient comes back as the merged heads' shards:
    # laid out whole per head first, else the reshape cannot view it back
    hflat = rms_norm(layout.grad_as(hten.reshape(b, t, -1)),
                     params.out_norm)
    hflat = hflat + params.skip * c
    return (hflat * F.silu(gate)) @ params.w_down


def mlstm_forward(params: MLSTM, cfg, x: Tensor, return_state: bool = False):
    gate, c, q, k, v, log_i, log_f, conv_state = _mlstm_inputs(params, x)
    hten = _mlstm_cell(q, k, v, log_i, log_f)
    y = _mlstm_out(params, hten, c, gate)
    if not return_state:
        return y
    # final recurrent state for decode continuation:
    # m_T = max_s (cumf_T - cumf_s + logi_s); C/n accumulate exp(.-m_T) terms
    dh = q.shape[-1]
    cum_f = torch.cumsum(log_f, dim=1)                       # [B,T,H]
    w_log = cum_f[:, -1:, :] - cum_f + log_i                 # [B,T,H]
    m_t = torch.amax(w_log, dim=1)                           # [B,H]
    w = torch.exp(w_log - m_t[:, None, :])                   # [B,T,H]
    c_state = torch.einsum("bth,bthv,bthk->bhvk", w, v, k) / f32_sqrt(dh)
    n_state = torch.einsum("bth,bthk->bhk", w, k) / f32_sqrt(dh)
    # the conv state is a view of the padded input: copy it
    return y, {"C": c_state, "n": n_state, "m": m_t,
               "conv": conv_state.clone()}


def init_mlstm_cache(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    di = int(PF_MLSTM * cfg.d_model)
    h = cfg.n_heads
    dh = di // h
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
        "m": torch.full((batch, h), -1e30, dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                            device=device),
    }


def mlstm_decode(params: MLSTM, cfg, x: Tensor, cache: dict
                 ) -> tuple[Tensor, dict]:
    """x: [B, 1, D].  Returns (y, the new state) as a new dict."""
    gate, c, q, k, v, log_i, log_f, conv_state = _mlstm_inputs(
        params, x, cache["conv"])
    q, k, v, log_i, log_f = q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0]
    m_new = torch.maximum(cache["m"] + log_f, log_i)         # [B,H]
    fs = torch.exp(cache["m"] + log_f - m_new)
    is_ = torch.exp(log_i - m_new)
    sq = f32_sqrt(q.shape[-1])
    c_new = (fs[..., None, None] * cache["C"]
             + is_[..., None, None] * (v[..., :, None] * k[..., None, :] / sq))
    n_new = fs[..., None] * cache["n"] + is_[..., None] * k / sq
    num = torch.einsum("bhvk,bhk->bhv", c_new, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)),
                        torch.exp(-m_new))
    hten = num / den[..., None]                              # [B,H,dh]
    y = _mlstm_out(params, hten[:, None], c, gate)
    return y, {"C": c_new, "n": n_new, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``conv_w`` [W, d], ``conv_b`` [d], ``w_gates`` [d, H, 4, dh] (z, i,
    f, o), ``r_gates`` [H, 4, dh, dh], ``b_gates`` [H, 4, dh],
    ``out_norm`` [d], ``ff_gate``/``ff_up`` [d, dff], ``ff_down``
    [dff, d]; dff = 4/3 d."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        dense, zeros, _ = _init(
            generator, device if device is not None else generator.device)
        d = cfg.d_model
        h = cfg.n_heads
        dh = d // h
        dff = int(PF_SLSTM * d)
        self.conv_w = dense((cfg.conv_width, d), in_axis=0, scale=0.1)
        self.conv_b = zeros((d,))
        self.w_gates = dense((d, h, 4, dh), in_axis=0)      # z i f o
        self.r_gates = dense((h, 4, dh, dh), in_axis=2, scale=0.1)
        self.b_gates = zeros((h, 4, dh))
        self.out_norm = zeros((d,))
        self.ff_gate = dense((d, dff))
        self.ff_up = dense((d, dff))
        self.ff_down = dense((dff, d))


def init_slstm_block(cfg, generator=None, device=None) -> SLSTM:
    return SLSTM(cfg, generator, device)


def _slstm_step(params: SLSTM, carry, xg: Tensor):
    """carry: (c, n, h, m) each [B, H, dh]; xg: [B, H, 4, dh]."""
    c, n, hprev, m = carry
    rec = torch.einsum("bhd,hgde->bhge", hprev, params.r_gates)
    g = xg + rec + params.b_gates
    z = torch.tanh(g[:, :, 0])
    i_ = g[:, :, 1]
    f_ = g[:, :, 2]
    o = torch.sigmoid(g[:, :, 3])
    log_f = -_softplus(-f_)
    m_new = torch.maximum(log_f + m, i_)
    i_s = torch.exp(i_ - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = torch.clamp_min(f_s * n + i_s, 1e-6)
    h_new = o * (c_new / n_new)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_ffn(params: SLSTM, cfg, hs: Tensor) -> Tensor:
    hs = rms_norm(hs, params.out_norm, cfg.norm_eps)
    return (F.silu(hs @ params.ff_gate) * (hs @ params.ff_up)) @ params.ff_down


def _slstm_gates(params: SLSTM, x: Tensor, conv_state=None):
    u, conv_state = conv1d_causal(params, x, conv_state)
    u = F.silu(u)
    return (torch.einsum("btd,dhge->bthge", u, params.w_gates),  # [B,T,H,4,dh]
            conv_state)


def _slstm_scan(params, xg: Tensor, h: int, dh: int):
    """The sLSTM's loop over time from its gate inputs xg [B, T, H, 4, dh]
    (``params``: anything with ``r_gates`` and ``b_gates``): (hs [B, T, H,
    dh], the final carry (c, n, h, m))."""
    b, t = xg.shape[:2]

    def full(value):
        return torch.full((b, h, dh), value, dtype=xg.dtype,
                          device=xg.device)

    carry = (full(0.0), full(1e-6), full(0.0), full(-1e30))
    hs = []
    for step in range(t):
        carry, h_new = _slstm_step(params, carry, xg[:, step])
        hs.append(h_new)
    return torch.stack(hs, dim=1), carry


def _slstm_scan_on_rows(params: SLSTM, xg: Tensor, h: int, dh: int):
    """`_slstm_scan` on DTensors: each device runs the loop on its own rows
    of the batch (`layout.by_rows`) with the recurrent weights whole (a
    loop of DTensor ops would pay DTensor's dispatch per step); the final
    carry rides as four more positions of the result."""
    from types import SimpleNamespace

    t = xg.shape[1]

    def local(xl, rl, bl):
        hs, carry = _slstm_scan(SimpleNamespace(r_gates=rl, b_gates=bl), xl,
                                h, dh)
        return torch.cat([hs, torch.stack(carry, dim=1)], dim=1)

    # laid out back as the gates, their gate axis dropped
    out = layout.on_rows(local, (xg, params.r_gates, params.b_gates),
                         (True, False, False), (xg.shape[0], t + 4, h, dh),
                         xg, {0: 0, 1: 1, 2: 2, 4: 3})
    return out[:, :t], tuple(out[:, t + i] for i in range(4))


def slstm_forward(params: SLSTM, cfg, x: Tensor, return_state: bool = False):
    b, t, d = x.shape
    h, dh = cfg.n_heads, d // cfg.n_heads
    xg, conv_state = _slstm_gates(params, x)
    scan = _slstm_scan_on_rows if layout.is_sharded(xg) else _slstm_scan
    hs, carry = scan(params, xg, h, dh)
    y = _slstm_ffn(params, cfg, layout.grad_as(hs.reshape(b, t, d)))
    if return_state:
        cc, nn_, hh, mm = carry
        return y, {"c": cc, "n": nn_, "h": hh, "m": mm,
                   "conv": conv_state.clone()}
    return y


def init_slstm_cache(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "c": full((batch, h, dh), 0.0),
        "n": full((batch, h, dh), 1e-6),
        "h": full((batch, h, dh), 0.0),
        "m": full((batch, h, dh), -1e30),
        "conv": full((batch, cfg.conv_width - 1, d), 0.0),
    }


def slstm_decode(params: SLSTM, cfg, x: Tensor, cache: dict
                 ) -> tuple[Tensor, dict]:
    """x: [B, 1, D].  Returns (y, the new state) as a new dict."""
    b, _, d = x.shape
    xg, conv_state = _slstm_gates(params, x, cache["conv"])
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, hh, m), h_new = _slstm_step(params, carry, xg[:, 0])
    y = _slstm_ffn(params, cfg, h_new.reshape(b, 1, d))
    return y, {"c": c, "n": n, "h": hh, "m": m, "conv": conv_state}
