"""The flash kernel's numerical scheme, emulated in plain PyTorch on the CPU.

``src/repro_torch/kernels/csrc/flash_attention.cu`` computes attention on
the tensor cores.  A CUDA kernel cannot run here, so this file repeats its
arithmetic tile by tile and holds the emulation against the JAX package's
dense oracle (``repro.kernels.ref.ref_attention``) and the port's plain
version (``repro_torch.kernels.ref.ref_attention``):

* float32 inputs, split TF32: x = hi + lo with hi = x with its 13 low
  mantissa bits cleared and lo = x - hi (exact in f32); the tensor core
  reads the top 19 bits of each operand, so lo is truncated the same way;
  each product is hi*hi + hi*lo + lo*hi with f32 sums (products of TF32
  values are exact in f32), for Q.K^T and for P.V;
* bfloat16 inputs: Q.K^T exact products in f32 sums; P rounded to bf16 for
  P.V (the row sum takes the unrounded p); the output rounded to bf16;
* the online softmax over the kernel's key tiles (their width read from the
  source), with s = (q.k) * scale, the softcap, masked p = 0,
  p = exp2((s - m) * log2(e)) and acc / max(l, 1e-30).

Bounds: atol = rtol = 2e-5 in float32 and 2e-2 for bf16 inputs (the JAX
package's, tests/test_kernels.py).  One more case shows that a single TF32
product, rounded to nearest even, misses 2e-5: the reason the kernel splits.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from _torch_reference import load_reference

import jax.numpy as jnp
import torch

from repro_torch.kernels import ref as tref

REF = load_reference()
rref = REF["repro.kernels.ops"].ref       # repro.kernels.ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attention.cu").read_text()
BK = int(re.search(r"constexpr int BK = (\d+);", SOURCE).group(1))
TF32_MASK = -(1 << 13)             # 0xffffe000: sign, exponent, 10 bits
NEG_INF = -1e30
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)

# (b, t, s, h, kv, dh, causal, window, softcap, dtype):
# tests/test_torch_lm_kernels.py's matrix, then D=256 with a window
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, None, "float32"),
    (1, 256, 256, 4, 2, 64, True, 0, None, "float32"),
    (2, 128, 128, 4, 1, 32, True, 0, None, "float32"),
    (1, 256, 256, 2, 2, 128, True, 64, None, "float32"),
    (1, 128, 128, 2, 2, 64, True, 0, 50.0, "float32"),
    (2, 128, 128, 4, 4, 64, False, 0, None, "float32"),
    (1, 192, 192, 2, 2, 64, True, 0, None, "float32"),
    (2, 128, 128, 4, 4, 64, True, 0, None, "bfloat16"),
    (1, 1024, 1024, 4, 1, 256, True, 512, None, "float32"),
    (1, 1024, 1024, 4, 1, 256, True, 512, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared (what the tensor core reads
    of an f32 register given as a .tf32 operand)."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    u = x.view(torch.int32)
    return ((u + 0xFFF + ((u >> 13) & 1)) & TF32_MASK).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's split TF32: hi*hi + (hi*lo + lo*hi)."""
    ah, bh = tf32_truncate(a), tf32_truncate(b)
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def single_tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_round(a) @ tf32_round(b)


def emulate(q, k, v, *, causal, window, softcap, mm=split_mm):
    """The kernel's arithmetic: q [B,T,H,D], k/v [B,S,K,D] -> [B,T,H,D]."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    g = h // k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)                       # [B,H,T,D]
    kh = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vh = v.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    scale = 1.0 / dh ** 0.5
    qpos = torch.arange(t)[:, None]
    m = torch.full((b, h, t, 1), NEG_INF)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, dh))
    for k0 in range(0, s, BK):
        kt, vt = kh[:, :, k0:k0 + BK], vh[:, :, k0:k0 + BK]
        kpos = torch.arange(k0, min(k0 + BK, s))[None, :]
        sc = (qh @ kt.transpose(-1, -2) if bf16
              else mm(qh, kt.transpose(-1, -2))) * np.float32(scale)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        ok = torch.ones((t, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        sc = torch.where(ok, sc, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.where(ok, torch.exp2((sc - m_new) * LOG2E),
                        torch.tensor(0.0))
        l = corr * l + p.sum(-1, keepdim=True)
        pv = (p.bfloat16().float() @ vt) if bf16 else mm(p, vt)
        acc = corr * acc + pv
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _inputs(case, seed):
    b, t, s, h, kv, dh, _, _, _, dtype = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, h, dh), (b, s, kv, dh), (b, s, kv, dh))]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(x).astype(jdt) for x in arrs],
            [torch.from_numpy(x).to(tdt) for x in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_kernel_scheme_holds_the_reference(case):
    _, _, _, _, _, _, causal, window, softcap, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, seed=case[1] + case[3])
    got = emulate(tq, tk, tv, causal=causal, window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    oracle = rref.ref_attention(jq, jk, jv, causal=causal, window=window,
                                softcap=softcap)
    plain = tref.ref_attention(tq, tk, tv, causal=causal, window=window,
                               softcap=softcap)
    for want in (oracle, plain):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_single_tf32_misses_the_f32_bound():
    """One TF32 product per f32 product (rounded to nearest even, the best
    single rounding) is off by ~1e-3 at D=256: 50x the 2e-5 bound."""
    case = (1, 1024, 1024, 4, 1, 256, True, 512, None, "float32")
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, seed=7)
    oracle = _f32(rref.ref_attention(jq, jk, jv, causal=True, window=512))
    single = _f32(emulate(tq, tk, tv, causal=True, window=512, softcap=None,
                          mm=single_tf32_mm))
    split = _f32(emulate(tq, tk, tv, causal=True, window=512, softcap=None))
    assert np.abs(single - oracle).max() > 10 * TOL["float32"]
    assert np.abs(split - oracle).max() < TOL["float32"] / 4


def test_split_is_exact_and_rounding_is_to_nearest_even():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32))
    hi = tf32_truncate(x)
    assert torch.equal(hi + (x - hi), x)                 # lo is exact
    assert torch.all((hi.view(torch.int32) & ~TF32_MASK) == 0)
    assert torch.all((x - hi).abs() <= x.abs() * 2.0 ** -10)
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10: even (1) wins; just above
    # the tie rounds up; 1 + 3 * 2^-11 ties to the even 1 + 2^-9
    ties = torch.tensor([1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -20,
                         1 + 3 * 2 ** -11], dtype=torch.float32)
    assert tf32_round(ties).tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -9]


def test_kernel_tile_width_is_read_from_the_source():
    assert BK in (16, 32, 64, 128)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in SOURCE
    assert "cp.async.cg.shared.global" in SOURCE
