"""Mixture-of-Experts FFN (DeepSeekMoE / Llama-4 Maverick families).

The port of ``repro/models/moe.py``.  Shared experts (always on,
DeepSeekMoE) plus routed experts with softmax top-k gating.  Dispatch is
the capacity-based scatter/gather formulation (GShard-style): each
(token, slot) entry gets its rank within its expert (`_positions_sort`, a
stable argsort: earlier tokens win), entries past an expert's capacity
are dropped, the kept tokens are scattered into per-expert buffers
[E, C, d] (`index_add_`; a dropped entry adds exact zeros into slot 0),
the expert products run as batched ``torch.bmm`` over the expert axis,
and the outputs gather back with their routing weights.  A Switch-style
load-balance loss comes back beside the output.

The reference also pins the expert buffers to a mesh axis
(``_ep_constrain`` / ``EP_CONSTRAINT_AXIS``) so that XLA shards them for
expert parallelism; on one card there is no mesh, so nothing here stands
for it.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor

class MoE(nn.Module):
    """``router`` [d, E], ``w_gate``/``w_up`` [E, d, de], ``w_down``
    [E, de, d], and with shared experts ``shared`` (``gate``/``up``
    [d, de * n_shared], ``down`` [de * n_shared, d])."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        m = cfg.moe
        d, de = cfg.d_model, (m.d_expert or cfg.d_ff)

        def dense(shape, in_axis):
            return nn.Parameter(dense_init(generator, shape, in_axis=in_axis,
                                           device=device))

        self.router = dense((d, m.n_experts), 0)
        self.w_gate = dense((m.n_experts, d, de), 1)
        self.w_up = dense((m.n_experts, d, de), 1)
        self.w_down = dense((m.n_experts, de, d), 1)
        if m.n_shared:
            self.shared = layers.MLP(d, de * m.n_shared, generator, device)


def init_moe(cfg, generator=None, device=None) -> MoE:
    return MoE(cfg, generator, device)


def expert_capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k * cfg.capacity_factor / m.n_experts) + 1
    return max(cap, 4)


def _positions_sort(flat_e: Tensor, n_experts: int) -> Tensor:
    """Per-(token, slot) rank within its expert via a stable argsort: no
    [N, E] intermediate, and stability keeps the earlier-token-wins
    capacity semantics of the reference's one-hot cumsum."""
    nk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, dim=0) - counts
    rank_sorted = (torch.arange(nk, device=flat_e.device)
                   - starts[flat_e[order]])
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    return pos


def route(params: MoE, cfg, xf: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(probs [N, E] f32, top_w [N, k], top_i [N, k]): the softmax in f32,
    the top k in descending order, the weights renormalised."""
    probs = torch.softmax((xf @ params.router).float(), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w.to(xf.dtype), top_i


def dispatch(flat_e: Tensor, cfg, cap: int) -> tuple[Tensor, Tensor, Tensor]:
    """(pos, keep, slot) of each flattened (token, slot) entry: its rank in
    its expert, whether it fits the capacity, and its row of the [E*C, d]
    buffer (0 for a dropped entry, whose weight is zero)."""
    pos = _positions_sort(flat_e, cfg.moe.n_experts)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + torch.clamp_max(pos, cap - 1),
                       torch.zeros_like(pos))
    return pos, keep, slot


def moe_forward(params: MoE, cfg, x: Tensor) -> tuple[Tensor, Tensor]:
    """x: [B, T, D] -> (y, aux_loss)."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    cap = expert_capacity(n, cfg)

    probs, top_w, top_i = route(params, cfg, xf)
    flat_e = top_i.reshape(-1)                            # [N*k]
    _, keep, slot = dispatch(flat_e, cfg, cap)
    keep_f = keep[:, None].to(xf.dtype)

    # scatter tokens into the expert buffers [E*C, d]: every kept slot
    # receives one entry, dropped ones add zeros into slot 0
    tok_rep = torch.arange(n, device=x.device).repeat_interleave(m.top_k)
    buf = torch.zeros((m.n_experts * cap, d), dtype=xf.dtype,
                      device=x.device)
    buf = buf.index_add(0, slot, xf[tok_rep] * keep_f)
    eb = buf.reshape(m.n_experts, cap, d)

    # expert compute, batched over the experts
    h = F.silu(torch.bmm(eb, params.w_gate)) * torch.bmm(eb, params.w_up)
    out = torch.bmm(h, params.w_down)

    # combine: gather back, weight, and sum over the k slots
    out_flat = out.reshape(m.n_experts * cap, d)
    gathered = out_flat[slot] * (top_w.reshape(-1)[:, None] * keep_f)
    y = torch.sum(gathered.reshape(n, m.top_k, d), dim=1)

    if m.n_shared:
        y = y + layers.mlp(params.shared, xf)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)                                 # mean router prob
    counts = torch.bincount(flat_e, minlength=m.n_experts).to(torch.float32)
    aux = torch.sum(me * (counts / n)) * m.n_experts
    return y.reshape(b, t, d), aux.to(torch.float32)


def topk_margin(probs: Tensor, k: int) -> Tensor:
    """Per token, the k-th largest router probability minus the (k+1)-th:
    how far a choice is from flipping (inf where k is every expert)."""
    if k >= probs.shape[-1]:
        return torch.full(probs.shape[:-1], float("inf"),
                          device=probs.device)
    top = torch.topk(probs, k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]

