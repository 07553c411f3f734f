"""The one-card dry run and roofline (`repro_torch.launch.dryrun`,
`repro_torch.roofline.analysis`) on the CPU, against the reference's
``repro/launch/dryrun.py`` and ``repro/roofline/analysis.py``.

The reference's two modules set ``XLA_FLAGS`` when they are imported (512
host devices); the fixture brings jax's backend up first, imports them
under `reference_modules`, and restores the variable.  Their
``run_cell``/``roofline_cell`` build the TPU meshes and are never called.

Bounds, measured here (torch 2.13, jax 0.9, CPU):

* the plain route's FLOPs against XLA's ``cost_analysis()["flops"]`` of the
  reference's own step, unrolled, with ``use_kernel=False``: the port's
  count is at most XLA's (it counts the matrix products only; XLA also
  counts elementwise work) and XLA's within `XLA_FACTOR` of it (1.006 to
  1.080 over the ten architectures at the scaled-down widths);
* the meta count's peak equals ``MemTracker``'s peak of the same cell run
  on the CPU exactly (bound 0);
* the counter's FLOPs equal ``FlopCounterMode``'s exactly.
"""
import dataclasses
import importlib
import math
import os
import resource
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_reference import load_reference, reference_modules

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_skip_reason
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rg_lru as rl
from repro_torch.launch import dryrun as dr
from repro_torch.launch.serve import serve
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100

XLA_FACTOR = 1.10
# one architecture of each family
FAMILIES = {"dense": "qwen3-1.7b", "moe": "deepseek-moe-16b",
            "hybrid": "recurrentgemma-2b", "ssm": "xlstm-125m",
            "audio": "seamless-m4t-medium", "vlm": "internvl2-1b"}


@pytest.fixture(scope="module")
def ref():
    """The reference's dry run and roofline modules (and what they use)."""
    import jax

    jax.devices()           # the backend is up before XLA_FLAGS changes
    saved = os.environ.get("XLA_FLAGS")
    loaded = load_reference()
    try:
        with reference_modules():
            mods = {name: importlib.import_module(name) for name in (
                "repro.launch.dryrun", "repro.roofline.analysis",
                "repro.train.serve_step", "repro.models.transformer")}
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return {**loaded, **mods}


def _small(arch, **over):
    return get_config(arch).scaled_down(**over)


def _count(cfg, shape, rows=2, seq_len=32, use_kernel=True, **kw):
    return dr.count_cell(dr.build_cell(cfg, shape, rows, seq_len=seq_len,
                                       use_kernel=use_kernel,
                                       microbatches=1), **kw)


# ---------------------------------------------------------------------------
# Parity with the reference's own arithmetic, on all 40 cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_match_the_reference(ref, arch):
    rdr, ran = ref["repro.launch.dryrun"], ref["repro.roofline.analysis"]
    rcfg = ref["repro.configs"].get_config(arch)
    cfg = get_config(arch)
    # the reference's parameter count is a full eval_shape: count it once
    n_active = ref["repro.models.transformer"].active_param_count(rcfg)
    assert n_active == analysis.transformer.active_param_count(cfg)
    for name, shape in SHAPES.items():
        rshape = ref["repro.configs"].SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == (
            rshape.seq_len, rshape.global_batch, rshape.kind)
        assert shape_skip_reason(cfg, name) == \
            ref["repro.configs"].shape_skip_reason(rcfg, name)
        mult = {"train": 6.0 * shape.global_batch * shape.seq_len,
                "prefill": 2.0 * shape.global_batch * shape.seq_len,
                "decode": 2.0 * shape.global_batch}[shape.kind]
        assert analysis.model_flops(cfg, shape) == mult * n_active
    for g in (1, 2, 3):
        assert dataclasses.asdict(analysis._reduced_cfg(cfg, g)) == \
            dataclasses.asdict(ran._reduced_cfg(rcfg, g))
    mine, theirs = dr.train_hyper_for(arch), rdr.train_hyper_for(arch)
    assert (mine.param_dtype, mine.opt.state_dtype, mine.microbatches) == (
        theirs.param_dtype, theirs.opt.state_dtype, theirs.microbatches)
    import jax.numpy as jnp

    assert str(dr.SERVE_DTYPE) == "torch." + jnp.dtype(rdr.SERVE_DTYPE).name


def test_model_flops_calls_equal_the_reference(ref):
    """`model_flops` itself, beside the reference's, on one cell a kind."""
    ran = ref["repro.roofline.analysis"]
    rc = ref["repro.configs"]
    for arch, name in (("olmo-1b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                       ("xlstm-125m", "long_500k")):
        assert analysis.model_flops(get_config(arch), SHAPES[name]) == \
            ran.model_flops(rc.get_config(arch), rc.SHAPES[name])


def test_extrapolate_equals_the_reference(ref):
    ran = ref["repro.roofline.analysis"]
    rng = np.random.default_rng(22)
    for _ in range(20):
        kinds = [k for k in ("all-gather", "all-reduce", "reduce-scatter")
                 if rng.random() < 0.6]

        def measure():
            return {"flops": float(rng.integers(0, 10**12)),
                    "bytes": float(rng.integers(0, 10**11)),
                    "coll_bytes": float(rng.integers(0, 10**9)),
                    "coll_by_kind": {k: float(rng.integers(0, 10**8))
                                     for k in kinds if rng.random() < 0.8}}
        m1, m2, g = measure(), measure(), int(rng.integers(1, 64))
        assert analysis._extrapolate(m1, m2, g) == ran._extrapolate(m1, m2,
                                                                     g)


# ---------------------------------------------------------------------------
# The plain route's FLOPs against XLA's cost analysis of the reference
# ---------------------------------------------------------------------------

def _xla_flops(ref, arch, kind, b, s) -> float:
    import jax
    import jax.numpy as jnp

    rcfg = ref["repro.configs"].get_config(arch).scaled_down()
    rts = ref["repro.train.train_step"]
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if rcfg.family == "audio":
        batch["frames"] = jax.ShapeDtypeStruct(
            (b, max(s // rcfg.enc_seq_divisor, 8), rcfg.d_model), jnp.float32)
    if rcfg.family == "vlm":
        batch["patches"] = jax.ShapeDtypeStruct(
            (b, rcfg.vision_tokens, rcfg.vit_dim), jnp.float32)
        batch["tokens"] = jax.ShapeDtypeStruct((b, s - rcfg.vision_tokens),
                                               jnp.int32)
    with reference_modules():
        if kind == "prefill":
            params = jax.eval_shape(
                lambda k: ref["repro.models.api"].init_params(rcfg, k), key)
            step = ref["repro.train.serve_step"].make_prefill_step(
                rcfg, max_len=s, unroll=True)
            args = (params, batch)
        else:
            hyper = rts.TrainHyper(unroll=True)
            args = (jax.eval_shape(
                lambda k: rts.init_train_state(rcfg, hyper, k), key), batch)
            step = rts.make_train_step(rcfg, hyper)
        return jax.jit(step).lower(*args).compile().cost_analysis()["flops"]


# prefill for every family; train, whose compile takes 2-6 s a config
# here, for the three whose backward differs most (attention and MLP,
# routed experts, the RG-LRU's scan)
XLA_CASES = ([(family, "prefill") for family in sorted(FAMILIES)]
             + [(family, "train") for family in ("dense", "hybrid", "moe")])


@pytest.mark.parametrize("family,kind", XLA_CASES)
def test_plain_route_flops_against_xla(ref, family, kind):
    arch = FAMILIES[family]
    cfg = _small(arch)
    b, s = 2, 32
    shape = "prefill_32k" if kind == "prefill" else "train_4k"
    # FLOPs do not depend on the dtype: the port's bf16 cell against the
    # reference's float32 one
    mine = _count(cfg, shape, rows=b, seq_len=s, use_kernel=False)["flops"]
    theirs = _xla_flops(ref, arch, kind, b, s)
    assert mine <= theirs <= XLA_FACTOR * mine, (mine, theirs)


# ---------------------------------------------------------------------------
# Exact counts inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_dense_prefill_flops_closed_form(use_kernel):
    """2 x tokens x (matrix parameters) + the head at the last position +
    attention: 4 B H T S dh (the plain route's full product) or
    4 dh B H x the causal pairs (the kernel's formula)."""
    cfg = _small("olmo-1b")
    b, t = 3, 48
    got = _count(cfg, "prefill_32k", rows=b, seq_len=t,
                 use_kernel=use_kernel)
    d, h, k, dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    per_layer = d * h * dh + 2 * d * k * dh + h * dh * d + 3 * d * ff
    pairs = t * t if not use_kernel else fa.attention_pairs(t, t, True, 0)
    want = (2 * b * t * per_layer * cfg.n_layers
            + 2 * b * d * cfg.vocab_padded
            + 4 * b * h * dh * pairs * cfg.n_layers)
    assert got["flops"] == want
    assert got["kernel_flops"] == (4 * b * h * dh * pairs * cfg.n_layers
                                   if use_kernel else 0)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-2b"])
def test_counts_are_affine_in_depth(arch, shape):
    """Counts at 1, 2 and 3 layer groups lie on one line, and the full
    depth (4 groups here) equals the reference's extrapolation of the
    one- and two-group counts."""
    cfg = _small(arch)
    plen = len(cfg.block_pattern)
    full = dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 4 * plen
                               + (1 if arch == "recurrentgemma-2b" else 0))
    m = {g: analysis._measure(analysis._reduced_cfg(full, g), shape, 2, 24)
         for g in (1, 2, 3)}
    for key in ("flops", "bytes"):
        assert m[3][key] - m[2][key] == m[2][key] - m[1][key] > 0
    at_full = analysis._measure(full, shape, 2, 24)
    ext = analysis._extrapolate(m[1], m[2], 4)
    assert (ext["flops"], ext["bytes"]) == (at_full["flops"],
                                            at_full["bytes"])


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_xlstm_length_polynomial_is_exact(monkeypatch, shape, rows):
    """Solved from three lengths, every count (the peak and the live bytes
    along `loop_points` too) equals the direct count at a fourth."""
    cfg = _small("xlstm-125m")
    monkeypatch.setattr(dr, "POLY_LENGTHS", (7, 11, 13))
    got = dr._count(cfg, shape, rows=rows, seq_len=17, keep_trace=True)
    want = _count(cfg, shape, rows=rows, seq_len=17)
    assert "peak_fitted" not in got and got["poly_lengths"] == [7, 11, 13]
    for key in dr.EXACT_COUNTS + ("peak_bytes", "temp_bytes"):
        assert got[key] == want[key], key
    assert dr.uses_poly(cfg, shape) and not dr.uses_poly(cfg, "decode_32k")
    assert not dr.uses_poly(_small("qwen3-1.7b"), shape)


def test_solve_poly_is_exact_or_says_so():
    assert dr.solve_poly((2, 3, 5), [3 + 2 * t + 7 * t * t
                                     for t in (2, 3, 5)], 1000) == 7002003
    with pytest.raises(ArithmeticError):          # 1/3
        dr.solve_poly((2, 3, 5), [0, 0, 1], 4)
    assert dr.solve_poly((2, 3, 5), [0, 0, 3], 4) == 1
    assert dr.solve_poly((2, 3, 5), [0, 0, 1], 4, exact=False) == 0


def test_counter_flops_equal_flop_counter_mode():
    for use_kernel in (True, False):
        cell = dr.build_cell(_small("recurrentgemma-2b"), "train_4k", 2,
                             seq_len=24, use_kernel=use_kernel,
                             microbatches=1)
        got = dr.count_cell(cell)
        cell = dr.build_cell(_small("recurrentgemma-2b"), "train_4k", 2,
                             seq_len=24, use_kernel=use_kernel,
                             microbatches=1)
        with FlopCounterMode(display=False) as counter:
            cell.step(*cell.args)
        assert got["flops"] - got["kernel_flops"] == \
            counter.get_total_flops()


# ---------------------------------------------------------------------------
# The kernels' formulas and meta branches
# ---------------------------------------------------------------------------

def _pairs_loop(t, s, causal, window):
    total = 0
    for q in range(t):
        hi = min(q, s - 1) if causal else s - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def test_attention_pairs_closed_form_equals_the_loop():
    for t in (1, 2, 7, 64, 100):
        for s in (1, 3, 64, 150):
            for causal in (True, False):
                for window in (0, 1, 5, 64, 300):
                    assert fa.attention_pairs(t, s, causal, window) == \
                        _pairs_loop(t, s, causal, window), (t, s, causal,
                                                            window)
    # GQA: FLOP by query heads, bytes by KV heads
    flop, nbytes = fa.cost(2, 64, 64, 8, 2, 32, True, 16, torch.bfloat16)
    assert flop == 4 * 32 * 2 * 8 * _pairs_loop(64, 64, True, 16)
    assert nbytes == 2 * (2 * 2 * 64 * 8 * 32 + 2 * 2 * 64 * 2 * 32)
    assert rl.cost(2, 5, 7, torch.float32) == (140, 4 * 3 * 70)
    assert rl.cost(2, 5, 7, torch.bfloat16, h0=True) == (140, 2 * (210 + 14))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_flash_meta_branch_plans_one_launch(dtype, causal, window):
    b, t, s, h, kv, dh = 2, 24, 24, 4, 2, 32
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, t, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    want = fa.flash_attention(q, k, v, causal=causal, window=window)
    before = (fa.LAUNCH_COUNT, fa.PLANNED_LAUNCHES, fa.PLANNED_FLOP,
              fa.PLANNED_BYTES)
    got = fa.flash_attention(*(x.to("meta") for x in (q, k, v)),
                             causal=causal, window=window)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    flop, nbytes = fa.cost(b, t, s, h, kv, dh, causal, window, dtype)
    assert (fa.LAUNCH_COUNT, fa.PLANNED_LAUNCHES, fa.PLANNED_FLOP,
            fa.PLANNED_BYTES) == (before[0], before[1] + 1,
                                  before[2] + flop, before[3] + nbytes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_lru_meta_branch_plans_forward_and_reverse_scan(dtype):
    b, t, d = 2, 9, 16
    gen = torch.Generator().manual_seed(6)
    a = (torch.rand((b, t, d), generator=gen) * 0.8 + 0.1).to(dtype)
    x = torch.randn((b, t, d), generator=gen).to(dtype)
    h0 = torch.randn((b, d), generator=gen).to(dtype)
    want = rl.rg_lru(a, x, h0)
    before = (rl.LAUNCH_COUNT, rl.PLANNED_LAUNCHES, rl.PLANNED_FLOP,
              rl.PLANNED_BYTES)
    am, xm, hm = (z.to("meta").requires_grad_(True) for z in (a, x, h0))
    got = rl.rg_lru(am, xm, hm)
    assert (got.device.type, got.shape, got.dtype) == ("meta", want.shape,
                                                       want.dtype)
    grads = torch.autograd.grad(got, (am, xm, hm), torch.ones_like(got))
    assert [g.shape for g in grads] == [am.shape, xm.shape, hm.shape]
    fwd, bwd = rl.cost(b, t, d, dtype, h0=True), rl.cost(b, t, d, dtype)
    assert (rl.LAUNCH_COUNT, rl.PLANNED_LAUNCHES, rl.PLANNED_FLOP,
            rl.PLANNED_BYTES) == (before[0], before[1] + 2,
                                  before[2] + fwd[0] + bwd[0],
                                  before[3] + fwd[1] + bwd[1])


@pytest.mark.parametrize("arch,shape,launches", [
    ("recurrentgemma-2b", "prefill_32k", {"flash_attention": 2, "rg_lru": 4}),
    ("recurrentgemma-2b", "train_4k", {"flash_attention": 4, "rg_lru": 12}),
    ("qwen3-1.7b", "train_4k", {"flash_attention": 4, "rg_lru": 0}),
    ("qwen3-1.7b", "decode_32k", {"flash_attention": 0, "rg_lru": 0}),
])
def test_planned_launches_per_cell(arch, shape, launches):
    """Prefill plans a launch a layer; training adds the remat recompute
    of every group and a reverse scan per RG-LRU layer (the scaled-down
    recurrentgemma: 6 layers, 2 attention and 4 recurrent)."""
    got = _count(_small(arch), shape, seq_len=20)
    assert got["planned_launches"] == launches


# ---------------------------------------------------------------------------
# Memory: the meta peak, rows that fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m",
                                  "deepseek-moe-16b"])
def test_meta_peak_equals_memtracker_on_the_cpu(arch, shape):
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = _small(arch)
    cell = dr.build_cell(cfg, shape, 2, device="cpu", seq_len=16,
                         use_kernel=False, microbatches=1)
    tracker = MemTracker()
    tracker.track_external(*cell.args[:3])
    with tracker:
        cell.step(*cell.args)
    cpu_peak = tracker.get_tracker_snapshot("peak")[torch.device("cpu")][
        "Total"]
    meta = _count(cfg, shape, seq_len=16, use_kernel=False)
    assert meta["peak_bytes"] == cpu_peak


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_rows_that_fit_against_a_small_capacity(shape):
    """Solved from 2 and 3 rows: n rows fit and n + 1 do not, counted."""
    cfg = _small("qwen3-1.7b")
    peak = {r: dr.count_cell(dr.build_cell(cfg, shape, r, microbatches=1)
                             )["peak_bytes"] for r in (1, 2, 5, 6)}
    assert dr._fit_rows(cfg, shape, (peak[5] + peak[6]) / 2) == (5, None)
    assert dr._fit_rows(cfg, shape, (peak[1] + peak[2]) / 2) == (1, None)
    fit, why = dr._fit_rows(cfg, shape, peak[1] - 1)
    assert fit == 0 and "one row" in why
    fit, why = dr._fit_rows(cfg, shape, 1.0)
    assert fit == 0 and "arguments" in why


def test_full_size_decode_cell_counts_without_allocating():
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    rec = dr.run_cell("qwen3-1.7b", "decode_32k", verbose=False)
    seconds = time.perf_counter() - t0
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert rec["status"] == "ok" and seconds < 30
    assert grown_kb < 1e6           # 451 GiB of cache counted, none made
    cfg = get_config("qwen3-1.7b")
    cache = (cfg.n_layers * 2 * 128 * 32_768 * cfg.n_kv_heads * cfg.head_dim
             * 2)
    params = sum(p.numel() for p in dr.build_cell(
        cfg, "decode_32k").args[0].parameters())
    assert rec["argument_bytes_per_device"] == cache + 2 * params + 8 * 128
    assert not rec["fits"] and rec["rows_that_fit"] >= 1
    assert rec["planned_launches"] == {"flash_attention": 0, "rg_lru": 0}
    full = analysis.roofline_cell("qwen3-1.7b", "decode_32k", record=rec,
                                  verbose=False)
    assert full["dominant"] == "memory" and full["t_collective_s"] == 0.0
    assert full["roofline_bound_s"] == full["bytes_accessed_per_device"] \
        / H100.hbm_bw
    assert math.isclose(full["useful_flops_ratio"],
                        full["model_flops"] / full["flops_per_device"])


def test_counter_counts_meta_tensors_only():
    """A cell off the meta device is refused: the counter's memo would hand
    its repeated ops empty tensors in place of values."""
    cell = dr.build_cell(_small("olmo-1b"), "decode_32k", 1, device="cpu")
    with pytest.raises(ValueError, match="meta tensors only"):
        dr.count_cell(cell)
    assert dr._template(torch.zeros(2)) is None
    assert dr._template(torch.zeros(2, device="meta")) is not None


def test_allocator_slack_bounds_the_count():
    """512-byte rounding, and 1 MiB more over 1 MiB; the counted slacks
    are those of the storages they cover."""
    assert [dr.alloc_slack(n) for n in (0, 1, 512, 2**20, 2**20 + 1)] == [
        0, 511, 0, 0, 511 + 2**20]
    cell = dr.build_cell(_small("qwen3-1.7b"), "prefill_32k", 2, seq_len=24)
    sizes = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
             for t in dr._tensors(cell.args)}
    got = dr.count_cell(cell)
    assert got["argument_slack_bytes"] == sum(map(dr.alloc_slack,
                                                  sizes.values()))
    assert got["temp_bytes"] <= got["temp_upper_bytes"]


def test_entry_points_need_cuda_but_the_count_does_not():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        dr.build_cell(_small("olmo-1b"), "decode_32k", 1, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("olmo-1b", device=None)
    rec = dr.run_cell("olmo-1b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def test_cli_counts_one_cell(capsys):
    dr.main(["--arch", "recurrentgemma-2b", "--shape", "long_500k"])
    said = capsys.readouterr().out
    assert "dry-run: 1 ok, 0 skipped (documented), 0 failed" in said


def test_bf16_serving_on_the_cpu():
    out = serve("recurrentgemma-2b", batch=2, prompt_len=12, new_tokens=3,
                device="cpu", dtype="bfloat16")
    assert {p.dtype for p in out["model"].parameters()} == {torch.bfloat16}
    assert out["generated"].shape == (2, 3)
    # the plain path in bf16 against the same model in float32
    model32 = out["model"].float()
    with torch.no_grad():
        from repro_torch.models import api
        l32, _ = api.prefill(out["cfg"], model32, out["request"], 20)
        l16, c16 = api.prefill(out["cfg"], model32.to(torch.bfloat16),
                               out["request"], 20)
    assert l16.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for e in c16.values()
               for name, t in e.items() if name != "pos")
    assert float((l16.float() - l32).abs().max()) <= 5e-2 * float(
        l32.abs().max())
