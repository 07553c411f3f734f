"""Plain PyTorch versions of the language-model kernels.

  ref_attention  <-> csrc/flash_attention.cu (flash_attention.flash_attention)
  ref_rg_lru     <-> csrc/rg_lru.cu (rg_lru.rg_lru)

Each wrapper uses its plain version for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against it on the card: `ref_rg_lru` bit for bit (the
same sequential loop, one rounding per multiply and per add), and
`ref_attention` within 2e-5 in float32 and 2e-2 for bf16 inputs (a dense
softmax sums in another order than an online one).  They are the port's
counterparts of ``repro/kernels/ref.py``; the reference's `ref_rg_lru` is an
associative scan, so the two agree by tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor
NEG_INF = -1e30


def f32_sqrt(n: int) -> float:
    """sqrt(n) rounded to float32, as ``jnp.sqrt`` of an int gives it."""
    return torch.sqrt(torch.tensor(float(n), dtype=torch.float32)).item()


def ref_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: int = 0, softcap: Optional[float] = None) -> Tensor:
    """Dense GQA attention in float32.  q: [B,T,H,D]; k/v: [B,S,K,D];
    query head h reads KV head h // (H // K).  Returns q's dtype."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bthd,bshd->bths", q.float(), k.float()) \
        / f32_sqrt(dh)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(t, device=q.device)
    kpos = torch.arange(s, device=q.device)
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window and window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask[None, :, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bths,bshd->bthd", probs, v.float())
    return out.to(q.dtype)


def ref_rg_lru(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1, one step at a time in the
    inputs' dtype (a separate multiply and add, as the kernel does).
    a/b: [B,T,D]; h0: [B,D] or None (zeros)."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h
        h = h + b[:, t]
        out[:, t] = h
    return out
