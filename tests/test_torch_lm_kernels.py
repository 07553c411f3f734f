"""The language-model kernels' wrappers and plain versions against the JAX
reference, on the CPU.

* Flash attention: the port's `ops.flash_attention` on CPU tensors (its
  plain version, the dense `ref_attention`) against the reference's Pallas
  kernel in interpret mode (`ops.flash_attention`) and its jnp oracle
  (`ref.ref_attention`), on the reference's own case matrix
  (tests/test_kernels.py FLASH_CASES) with its bounds: atol = rtol = 2e-5
  in float32, 2e-2 for bf16 inputs.
* RG-LRU: the port's `ops.rg_lru` (plain version: the sequential loop)
  against the reference's Pallas scan and its associative-scan oracle, on
  RGLRU_CASES plus an ``h0`` case, with the reference's bounds (1e-5
  float32, 5e-2 bf16); the models' log-depth `scan_rg_lru` likewise.
* On CPU tensors the wrappers take the plain version and count no launch;
  they raise on operands the kernels do not take.
* The RG-LRU kernel's launch geometry, computed in Python: its units cover
  every (b, d) once, and the 16-byte-copy route is taken only where every
  row of the operands is 16-byte aligned.
The CUDA kernels run only on the card: ``chip_smoke.py`` holds them against
their plain versions there, and the ``cuda`` test below does when a card is
present.
"""
import re

import numpy as np
import pytest

from _torch_reference import load_reference

import jax.numpy as jnp
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as trl
from repro_torch.models import rglru as trglru

REF = load_reference()
rops = REF["repro.kernels.ops"]
rref = rops.ref          # repro.kernels.ref, as the reference's ops loaded it
rrl = rops.rl            # repro.kernels.rg_lru

# (b, t, s, h, kv, dh, causal, window, softcap, dtype), as in
# tests/test_kernels.py
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, None, "float32"),
    (1, 256, 256, 4, 2, 64, True, 0, None, "float32"),
    (2, 128, 128, 4, 1, 32, True, 0, None, "float32"),     # MQA
    (1, 256, 256, 2, 2, 128, True, 64, None, "float32"),   # sliding window
    (1, 128, 128, 2, 2, 64, True, 0, 50.0, "float32"),     # softcap
    (2, 128, 128, 4, 4, 64, False, 0, None, "float32"),    # bidirectional
    (1, 192, 192, 2, 2, 64, True, 0, None, "float32"),     # T not a tile
    (2, 128, 128, 4, 4, 64, True, 0, None, "bfloat16"),
]
# (b, t, d, dtype), as in tests/test_kernels.py
RGLRU_CASES = [
    (2, 64, 128, "float32"),
    (1, 128, 256, "float32"),
    (3, 33, 130, "float32"),     # ragged D
    (2, 64, 128, "bfloat16"),
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(x: np.ndarray, dtype: str):
    """The same values in both packages (bf16 rounds to nearest-even in
    both)."""
    return (jnp.asarray(x).astype(JAX_DTYPES[dtype]),
            torch.from_numpy(x).to(TORCH_DTYPES[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _flash_inputs(case, seed):
    b, t, s, h, kv, dh, causal, window, softcap, dtype = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    return [_both(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_plain_matches_reference(case):
    b, t, s, h, kv, dh, causal, window, softcap, dtype = case
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(case, seed=t + h + kv)
    before = tfa.LAUNCH_COUNT
    got = tops.flash_attention(tq, tk, tv, causal, window, softcap)
    assert tfa.LAUNCH_COUNT == before          # the plain version ran
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = rops.flash_attention(jq, jk, jv, causal, window, softcap)
    oracle = rref.ref_attention(jq, jk, jv, causal=causal, window=window,
                                softcap=softcap)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (kernel, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _rglru_inputs(case, seed):
    b, t, d, dtype = case
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.99, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return _both(a, dtype), _both(x, dtype)


@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rg_lru_plain_matches_reference(case):
    b, t, d, dtype = case
    (ja, ta), (jx, tx) = _rglru_inputs(case, seed=b * t + d)
    before = trl.LAUNCH_COUNT
    got = tops.rg_lru(ta, tx)
    assert trl.LAUNCH_COUNT == before
    assert got.dtype == ta.dtype and got.shape == ta.shape
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    for want in (rops.rg_lru(ja, jx), rref.ref_rg_lru(ja, jx)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_rg_lru_with_h0_matches_reference():
    case = (2, 48, 256, "float32")
    (ja, ta), (jx, tx) = _rglru_inputs(case, seed=5)
    h0 = np.random.default_rng(6).standard_normal((2, 256)).astype(np.float32)
    jh0, th0 = _both(h0, "float32")
    got = tops.rg_lru(ta, tx, th0)
    for want in (rrl.rg_lru_scan(ja, jx, jh0),
                 rref.ref_rg_lru(ja, jx, jh0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_models_scan_rg_lru_matches_the_sequential_scan(with_h0):
    (ja, ta), (jx, tx) = _rglru_inputs((3, 37, 130, "float32"), seed=9)
    h0 = torch.randn(3, 130, generator=torch.Generator().manual_seed(1)) \
        if with_h0 else None
    got = trglru.scan_rg_lru(ta, tx, h0)
    np.testing.assert_allclose(got.numpy(), tref.ref_rg_lru(ta, tx, h0).numpy(),
                               atol=1e-5, rtol=1e-5)
    want = rref.ref_rg_lru(ja, jx, None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_ref_rg_lru_is_the_separate_multiply_and_add():
    """The plain version rounds the product before the add (the kernel is
    built with --fmad=false to do the same): the exact recurrence."""
    (_, ta), (_, tx) = _rglru_inputs((2, 9, 17, "float32"), seed=3)
    h = torch.zeros(2, 17)
    for t in range(9):
        h = (ta[:, t] * h) + tx[:, t]
    assert torch.equal(tref.ref_rg_lru(ta, tx)[:, -1], h)


def test_wrappers_raise_on_operands_the_kernels_do_not_take():
    a = torch.rand(2, 5, 8)
    with pytest.raises(ValueError, match="shape"):
        trl.rg_lru(a, torch.rand(2, 5, 9))
    with pytest.raises(TypeError, match="dtype"):
        trl.rg_lru(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        trl.rg_lru(a, torch.rand(2, 8, 5).transpose(1, 2))
    with pytest.raises(ValueError, match="h0"):
        trl.rg_lru(a, a, torch.zeros(2, 7))
    q = torch.rand(1, 4, 3, 32)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, torch.rand(1, 4, 2, 32), torch.rand(1, 4, 2, 32))
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="fit"):
        tfa.flash_attention(q, torch.rand(1, 4, 3, 16), torch.rand(1, 4, 3, 16))


# (b, d) grids of the unit tests: the serve shape, a ragged D, tiny ones
RGLRU_UNIT_SHAPES = [(4, 4096, 2560), (3, 33, 130), (2, 5, 9), (1, 1, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RGLRU_UNIT_SHAPES, ids=str)
def test_rg_lru_units_cover_every_channel_once(shape, dtype):
    b, _, d = shape
    tdt = TORCH_DTYPES[dtype]
    width = trl.UNIT_BYTES // tdt.itemsize
    units = trl.units(b, d, tdt)
    assert len(units) == b * -(-d // width)
    hits = np.zeros((b, d), dtype=int)
    for bi, c0, c1 in units:
        assert c0 % width == 0 and 0 < c1 - c0 <= width
        hits[bi, c0:c1] += 1
    assert (hits == 1).all()


def test_rg_lru_units_are_the_kernel_sources_and_spread_evenly():
    src = trl.LIBRARY.source.read_text()
    assert re.search(r"constexpr int UNIT_BYTES = (\d+);", src).group(1) \
        == str(trl.UNIT_BYTES)
    # the serve shape: 640 one-warp units, 5 on the busiest of 132 SMs
    # against a mean of 4.85
    n = len(trl.units(4, 2560, torch.float32))
    assert n == 640 and -(-n // 132) == 5


# pointers: (a, b); h0 and the output are read and written an element at
# a time, so their alignment does not enter the route
@pytest.mark.parametrize("d,dtype,pointers,want", [
    (2560, "float32", (0, 1 << 20), "aligned"),
    (4, "float32", (16, 32), "aligned"),       # one 16-byte row
    (136, "float32", (16, 32), "aligned"),     # a ragged last unit
    (136, "bfloat16", (16, 32), "aligned"),    # 272-byte rows
    (130, "float32", (0, 0), "general"),       # 520-byte rows
    (130, "bfloat16", (0, 0), "general"),      # 260-byte rows
    (1, "float32", (0, 0), "general"),
    (2560, "float32", (4, 0), "general"),      # `a` 4 bytes off
    (2560, "float32", (0, 4), "general"),      # `b` 4 bytes off
    (2560, "bfloat16", (0, 6), "general"),     # `b` 6 bytes off
    (2560, "bfloat16", (2, 0), "general"),
], ids=str)
def test_rg_lru_route_takes_16_byte_copies_only_where_rows_are_aligned(
        d, dtype, pointers, want):
    assert trl.route((2, 7, d), TORCH_DTYPES[dtype], pointers) == want


def test_rg_lru_takes_an_operand_at_a_storage_offset():
    (_, ta), (_, tx) = _rglru_inputs((2, 9, 16, "float32"), seed=8)
    buf = torch.empty(1 + ta.numel())
    a = buf[1:].view(ta.shape)
    a.copy_(ta)
    assert a.storage_offset() == 1 and a.is_contiguous()
    assert torch.equal(trl.rg_lru(a, tx), tref.ref_rg_lru(ta, tx))


@pytest.mark.cuda
def test_cuda_kernels_equal_their_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs this comparison on the card)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # ((b, t, d), bytes of `a`'s storage offset): a whole number of 16-row
    # tiles, a ragged D (general route), T = 1, T below one tile, a ragged
    # T with a ragged last unit (aligned route), an operand 4 bytes off
    for (b, t, d), offset in (((2, 64, 128), 0), ((3, 33, 130), 0),
                              ((2, 1, 256), 0), ((2, 9, 256), 0),
                              ((2, 77, 136), 0), ((2, 70, 256), 4)):
        for dtype, bits in ((torch.float32, torch.int32),
                            (torch.bfloat16, torch.int16)):
            skip = offset // dtype.itemsize
            a = torch.empty(skip + b * t * d, dtype=dtype, device=dev
                            )[skip:].view(b, t, d)
            a.copy_(torch.rand((b, t, d), generator=gen, device=dev) * 0.8
                    + 0.2)
            x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
            h0 = torch.randn((b, d), generator=gen, device=dev).to(dtype)
            for hh in (None, h0):
                got = trl.rg_lru(a, x, hh)
                want = tref.ref_rg_lru(a, x, hh)
                assert torch.equal(got.view(bits), want.view(bits)), \
                    ((b, t, d), offset, dtype, hh is not None)
    for case in FLASH_CASES:
        b, t, s, h, kv, dh, causal, window, softcap, dtype = case
        (_, tq), (_, tk), (_, tv) = _flash_inputs(case, seed=1)
        tq, tk, tv = tq.to(dev), tk.to(dev), tv.to(dev)
        got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  softcap=softcap)
        want = tref.ref_attention(tq, tk, tv, causal=causal, window=window,
                                  softcap=softcap)
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_every_kernel_shares_one_hashed_build(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    from repro_torch.kernels import mltcp_step as tms

    libs = (tms.LIBRARY, tfa.LIBRARY, trl.LIBRARY)
    assert [lib.name for lib in libs] == ["mltcp_step", "flash_attention",
                                          "rg_lru"]
    # the bitwise kernels share the flags that keep their rounding; the
    # flash kernel, held by tolerance, builds for the same card without them
    assert tms.LIBRARY.flags == trl.LIBRARY.flags == build.NVCC_FLAGS
    assert "--fmad=false" not in tfa.LIBRARY.flags
    assert "arch=compute_90a,code=sm_90a" in tfa.LIBRARY.flags
    for lib in libs:
        assert lib.source.exists()
        name = lib.library_path().name
        assert name.startswith(lib.name + "_") and name.endswith(".so")
        assert len(name) == len(lib.name) + 1 + 16 + 3
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert trl.LIBRARY.library_path().parent == tmp_path
    # an existing library is not rebuilt
    trl.LIBRARY.library_path().write_bytes(b"")
    assert trl.LIBRARY.start_build() is None


def test_flash_probe_exits_without_a_card(capsys):
    """The card probe (``python3 chip_smoke.py --probe-flash``) measures
    nothing on the CPU: it exits 2 before building anything and prints no
    result."""
    import chip_smoke

    assert chip_smoke.main(["--probe-flash"]) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_kernel_table_rows_need_every_key_and_a_route():
    """chip_smoke refuses a kernels line whose row lacks a key or names
    something other than how the kernel was written as its route."""
    import chip_smoke

    row = {key: 0 for key in chip_smoke.KERNEL_ROW_KEYS}
    row.update(name="rg_lru", route="cuda")
    chip_smoke.check_kernel_table([row, dict(row, route="triton")])
    for bad in (dict(row, route="aligned"),
                {k: v for k, v in row.items() if k != "bound_ms"}):
        with pytest.raises(AssertionError, match="rg_lru"):
            chip_smoke.check_kernel_table([row, bad])


@pytest.mark.cuda
def test_cuda_kernels_backward_equals_autograd_through_plain_versions():
    """Both LM kernels take inputs that need a gradient; the check itself is
    kept once, in the JAX-free ``test_torch_cuda.py`` that runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels launch only there")
    from test_torch_cuda import (
        test_cuda_kernels_backward_equals_autograd_through_plain_versions
        as on_the_card)

    on_the_card()


@pytest.mark.parametrize("argv", [["--probe", "rg_lru"],
                                  ["--probe", "flash_attention", "x.cu"]])
def test_kernel_probes_exit_without_a_card(capsys, argv):
    """``--probe KERNEL`` measures nothing on the CPU either; a kernel it
    does not know is refused before anything runs."""
    import chip_smoke

    assert chip_smoke.main(argv) == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""
    with pytest.raises(SystemExit):
        chip_smoke.main(["--probe", "mltcp_step"])
    assert "--probe takes one of" in capsys.readouterr().err
