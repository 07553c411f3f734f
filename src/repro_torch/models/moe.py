"""Mixture-of-Experts FFN (DeepSeekMoE / Llama-4 Maverick families).

The port of ``repro/models/moe.py``.  Shared experts (always on,
DeepSeekMoE) plus routed experts with softmax top-k gating.  Dispatch is
the capacity-based scatter/gather formulation (GShard-style): each
(token, slot) entry gets its rank within its expert (`DISPATCH_MODE`:
`_positions_sort`, a stable argsort, or `_positions_cumsum`, the
reference's first one-hot cumsum; earlier tokens win either way), entries
past an expert's capacity
are dropped, the kept tokens are scattered into per-expert buffers
[E, C, d] (`index_add_`; a dropped entry adds exact zeros into slot 0),
the expert products run as batched ``torch.bmm`` over the expert axis,
and the outputs gather back with their routing weights.  A Switch-style
load-balance loss comes back beside the output.

On a device mesh the expert buffers are pinned to the mesh axis
`EP_CONSTRAINT_AXIS` (`_ep_constrain`, the reference's knob): DTensor
then runs the expert products where the experts lie (expert parallelism)
and moves the tokens there.  On a plain tensor it is a no-op.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.launch import layout
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


# How `dispatch` ranks the entries in their experts: "sort" (the default,
# `_positions_sort`) or "cumsum" (`_positions_cumsum`, the reference's
# original baseline, the hillclimb's D0).
DISPATCH_MODE = "sort"

# Expert-parallel sharding constraint: the mesh axis the expert buffers
# [E, C, d] are pinned to (None: not pinned).  Without it the buffer would
# be replicated and all-reduced.
EP_CONSTRAINT_AXIS: Optional[str] = "model"


def _ep_constrain(x: Tensor, spec_axes) -> Tensor:
    """``x`` with its "E" dimension on `EP_CONSTRAINT_AXIS`
    (`layout.constrain`); a no-op on a plain tensor."""
    if EP_CONSTRAINT_AXIS is None:
        return x
    return layout.constrain(x, [EP_CONSTRAINT_AXIS if a == "E" else None
                                for a in spec_axes])


def _expert_parallel(xf: Tensor, n_experts: int) -> bool:
    """Whether the dispatch runs expert parallel (`layout.expert_scatter`):
    DTensor tokens, the buffers pinned to the model axis, and the experts
    splitting evenly over it (else DTensor's own rules run the one-card
    dispatch)."""
    if EP_CONSTRAINT_AXIS != "model" or not layout.is_sharded(xf):
        return False
    m = layout.model_size(xf)
    return m > 1 and n_experts % m == 0


def expert_capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k * cfg.capacity_factor / m.n_experts) + 1
    return max(cap, 4)


def _positions_cumsum(flat_e: Tensor, n_experts: int) -> Tensor:
    """Per-(token, slot) rank within its expert via a one-hot cumsum: an
    int32 one-hot of N*k x E entries and O(N*E) prefix work (int32
    ranks).  The one-hot is laid out [E, N*k], the reference's [N*k, E]
    transposed, so that the scan runs along the innermost dimension (the
    card scans an outer dimension one thread a column)."""
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (experts[:, None] == flat_e[None, :]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return torch.gather(pos_in_e, 0, flat_e[None, :])[0]


def _positions_sort(flat_e: Tensor, n_experts: int) -> Tensor:
    """Per-(token, slot) rank within its expert via a stable argsort: no
    [N, E] intermediate, and stability keeps the earlier-token-wins
    capacity semantics of the reference's one-hot cumsum."""
    nk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = layout.bincount(flat_e, n_experts)
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
    # the ranks are over every token: on a mesh each device ranks them all
    positions = (_positions_sort if DISPATCH_MODE == "sort"
                 else _positions_cumsum)
    pos = layout.whole_call(lambda fe: positions(fe, cfg.moe.n_experts),
                            flat_e, flat_e.shape)
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
    if _expert_parallel(xf, m.n_experts):
        eb = layout.expert_scatter(xf, slot, keep, m.n_experts, cap,
                                   m.top_k)
    else:
        tok_rep = torch.arange(n, device=x.device).repeat_interleave(
            m.top_k)
        buf = torch.zeros((m.n_experts * cap, d), dtype=xf.dtype,
                          device=x.device)
        buf = buf.index_add(0, slot, xf[tok_rep] * keep_f)
        eb = buf.reshape(m.n_experts, cap, d)
    eb = _ep_constrain(eb, ("E", None, None))

    # expert compute, batched over the experts
    w_gate, w_up, w_down = (layout.gathered(w) for w in (
        params.w_gate, params.w_up, params.w_down))
    h = F.silu(torch.bmm(eb, w_gate)) * torch.bmm(eb, w_up)
    out = _ep_constrain(torch.bmm(h, w_down), ("E", None, None))

    # combine: gather back, weight, and sum over the k slots
    if _expert_parallel(xf, m.n_experts):
        y = layout.expert_gather(out, slot,
                                 top_w.reshape(-1) * keep.to(top_w.dtype),
                                 m.top_k)
    else:
        out_flat = out.reshape(m.n_experts * cap, d)
        gathered = out_flat[slot] * (top_w.reshape(-1)[:, None] * keep_f)
        y = torch.sum(gathered.reshape(n, m.top_k, d), dim=1)

    if m.n_shared:
        y = y + layers.mlp(params.shared, xf)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)                                 # mean router prob
    counts = layout.bincount(flat_e, m.n_experts).to(torch.float32)
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

