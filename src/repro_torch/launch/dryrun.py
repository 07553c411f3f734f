"""The dry run: every (architecture x input shape) cell built from
stand-ins on the ``meta`` device, its step run once and counted, nothing
allocated, on one card or per device of a production mesh.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The port of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for a 256- or 512-chip TPU mesh and reads XLA's memory and cost
analyses.  Here a cell is the port's own step (`train.make_train_step`,
`make_prefill_step`, `make_decode_step`) on meta tensors of the cell's
full published widths, depth and global batch, and `count_cell` runs it
once under one ``TorchDispatchMode``, `StepCounter`, which counts:

* FLOPs, by the formulas ``FlopCounterMode`` counts with (aten's matrix
  products; the elementwise work is not counted, as XLA's cost analysis
  does);
* bytes: every op's operands and results (views, allocations and
  host-side scalars move none).  It is the unfused counterpart of XLA's
  "bytes accessed", an upper bound on what the step must move: each eager
  op of the port does read its inputs and write its outputs, but an
  operand the L2 cache still holds is not read from memory again;
* live bytes: the storages of the step's arguments and of what its ops
  allocate, each until it is freed, so the step's peak.

On meta tensors the kernels' wrappers compute nothing and plan their
launches (`kernels.flash_attention`, `kernels.rg_lru`): `count_cell`
adds each kernel's formula FLOPs and bytes (their ``cost``) and reports
its planned launches.  `run_cell` counts a cell on both routes: the
kernels (``use_kernel=True``), the path the card runs, whose numbers the
roofline reads; and the plain path (``use_kernel=False``), the
reference's own semantics (its dry run lowers with ``use_kernel=False``),
kept for parity only.  A train cell is counted with one microbatch, as
the reference's roofline lowers it: every op of the step once.

On one card (``--mesh card``, the default) the collectives are zero and
a record gains what one card needs: ``fits`` (the peak within
`hw.H100`'s 80 GB), ``rows_that_fit`` (the live bytes after each op are
affine in the batch rows: counted at 2 and 3 rows every point is solved,
and at one row where two do not fit; for a train cell it is the rows of
one microbatch), ``planned_launches`` per kernel and ``count_s``.

On the production meshes (``--mesh single|multi|both``: 16 x 16, 2 x 16 x
16; `run_mesh_cell`) a cell is built with the reference's rules
(`default_rules_for`, ``FSDP_TRAIN_ARCHS``, ``FSDP_SERVE_ARCHS``, and
``SEQ_SHARD_ARCHS`` on train and prefill cells through
`production_knobs`): its parameters, AdamW moments, batch and cache are
DTensors whose local shards are meta tensors (`shard_cell`,
`train.sharding`, `batch_pspecs`, `cache_pspecs`), on a fake process
group of 256 or 512 ranks in which this process is rank 0
(`launch.mesh`).  DTensor's sharding propagation stands for GSPMD:
`StepCounter` lets each DTensor op lower first and counts what rank 0
runs on its shards, and `roofline.collectives.CollectiveCounter` counts
the collectives it issues.  The record has the reference's per-device
keys and ``collectives``, and states its ``rules``, the four hillclimb
``knobs`` and its ``route``.  The dry run counts the kernel route (the
card's) by the production rules; `run_mesh_cell` also counts the plain
route, and by the reference roofline's own rules (`reference_rules`,
the knobs as the caller left them), as `roofline.analysis` and
`roofline.hillclimb` count a mesh cell.  Every mesh cell is counted at its own length,
the xLSTM family's too: on a mesh no count is a polynomial in the length
(DTensor picks other layouts and collectives at short lengths, so a
count solved from short lengths misses the FLOPs, the peak and the
collectives alike), and the loop over time runs on each device's local
rows, a few minutes an xLSTM cell on the CPU.

The xLSTM family's sLSTM is a Python loop over time (some 35 ops a token
and block, ~3 ms a token of counting in prefill, four times that in
training), so its train and prefill cells are counted at three short
lengths (`POLY_LENGTHS`) and solved for the cell's length.  The FLOPs and
bytes are exactly quadratics in T (`EXACT_COUNTS`: the mLSTM's parallel
form is quadratic, the loop linear; `solve_poly`).  The peak is not (the
op at which it falls moves with T), but the live bytes at each op are,
once the ops line up across lengths: `loop_points` keeps every op outside
the loops and the first two and last two iterations of each loop (an
inner iteration adds the same bytes, so a loop's most is at one end), and
each point is solved on its own.

Serving cells run in bf16 (`SERVE_DTYPE`) with a bf16 cache; train cells
take the reference's hyper-parameters (`train_hyper_for`).
`build_cell(..., device="cuda")` makes the same cell on the card (random
weights from a seed), where ``chip_smoke.py`` holds the counts against
the card's launches, peak memory and time.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref
from array import array
from fractions import Fraction
from typing import Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_skip_reason)
from repro_torch.device import resolve
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rg_lru as rl
from repro_torch.launch import mesh as meshes
from repro_torch.models import api
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline import collectives
from repro_torch.roofline.hw import H100
from repro_torch.train import sharding
from repro_torch.train.sharding import ShardingRules
from repro_torch.train import (TrainHyper, init_train_state,
                               make_decode_step, make_prefill_step,
                               make_train_step)

Tensor = torch.Tensor
aten = torch.ops.aten

SERVE_DTYPE = torch.bfloat16

# The reference's per-arch training hyper-parameters: bf16 parameters
# everywhere, bf16 AdamW moments and more microbatches for the largest.
_BF16_OPT = AdamWConfig(state_dtype="bfloat16")
_DEFAULT_HYPER = TrainHyper(param_dtype="bfloat16", microbatches=2)
TRAIN_HYPER_OVERRIDES = {
    "llama4-maverick-400b-a17b": TrainHyper(param_dtype="bfloat16",
                                            opt=_BF16_OPT, microbatches=8),
    "gemma2-27b": TrainHyper(param_dtype="bfloat16", opt=_BF16_OPT,
                             microbatches=8),
    "deepseek-moe-16b": TrainHyper(param_dtype="bfloat16", opt=_BF16_OPT,
                                   microbatches=8),
    "recurrentgemma-2b": TrainHyper(param_dtype="bfloat16", microbatches=4),
    "qwen1.5-4b": TrainHyper(param_dtype="bfloat16", microbatches=4),
    "internvl2-1b": TrainHyper(param_dtype="bfloat16", microbatches=4),
}

# the kernels whose wrappers plan launches on meta tensors
KERNELS = {"flash_attention": fa, "rg_lru": rl}
# lengths at which the xLSTM family's long cells are counted (see the
# module's docstring); primes, so that no model dimension equals one
POLY_LENGTHS = (23, 37, 53)
# the counts the xLSTM polynomial solves exactly
EXACT_COUNTS = ("flops", "bytes", "argument_bytes", "output_bytes",
                "kernel_flops", "kernel_bytes")


# big models also shard weights and optimizer state over the data axes
# when training (the reference's production defaults)
FSDP_TRAIN_ARCHS = {"llama4-maverick-400b-a17b", "gemma2-27b",
                    "deepseek-moe-16b"}
# sequence-parallel attention scores where the heads do not divide the
# model axis (train and prefill cells), and FSDP for the MoE serving cells
SEQ_SHARD_ARCHS = {"qwen1.5-4b", "llama4-maverick-400b-a17b",
                   "internvl2-1b"}
FSDP_SERVE_ARCHS = {"llama4-maverick-400b-a17b", "deepseek-moe-16b"}
# --mesh: the card's count, or the production meshes (multi_pod flags)
MESH_CHOICES = {"card": (None,), "single": (False,), "multi": (True,),
                "both": (False, True)}


def train_hyper_for(arch: str) -> TrainHyper:
    return TRAIN_HYPER_OVERRIDES.get(arch, _DEFAULT_HYPER)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in meshes.axis_names(mesh) if a != "model")


def default_rules_for(arch: str, shape_kind: str, mesh) -> ShardingRules:
    """The reference's production rules of a cell on ``mesh``."""
    dp = _data_axes(mesh)
    if shape_kind == "decode":
        return ShardingRules(data_axes=dp, decode_cache_seq_shard=True,
                             fsdp=arch in FSDP_SERVE_ARCHS)
    if shape_kind == "prefill":
        return ShardingRules(data_axes=dp, fsdp=arch in FSDP_SERVE_ARCHS)
    return ShardingRules(data_axes=dp, fsdp=arch in FSDP_TRAIN_ARCHS)


def batch_pspecs(batch: dict, mesh, microbatches: int = 1,
                 rules: Optional[ShardingRules] = None) -> dict:
    """The reference's ``_batch_specs`` of a batch (each leaf [mb?, b,
    ...]): the rows over the data axes where they divide them, the
    microbatch axis (with gradient accumulation) and the rest
    unsharded."""
    dp = rules.data_axes if rules is not None else _data_axes(mesh)
    sizes = meshes.axis_sizes(mesh)
    dsize = math.prod(sizes[a] for a in dp)
    lead = (None,) if microbatches > 1 else ()
    out = {}
    for name, t in batch.items():
        rows = t.shape[len(lead)]
        bspec = dp if rows % dsize == 0 else None
        out[name] = lead + (bspec,) + (None,) * (t.ndim - len(lead) - 1)
    return out


def cache_pspec(name: str, shape, mesh, rules: Optional[ShardingRules],
                stacked: bool = False) -> tuple:
    """The reference's spec of a cache leaf: a [B, S, K, dh] K or V
    sequence-sharded over "model" with ``decode_cache_seq_shard`` (each
    axis only where its dim divides the mesh axes), else `auto_pspec`.
    ``stacked``: the leaf carries a leading layer axis (the
    encoder-decoder's caches)."""
    nd = len(shape) - (1 if stacked else 0)
    if (rules is not None and rules.decode_cache_seq_shard and nd == 4
            and name in ("k", "v")):
        sizes = meshes.axis_sizes(mesh)
        dsize = math.prod(sizes.get(a, 1) for a in rules.data_axes)
        shp = shape[1:] if stacked else shape
        bspec = rules.data_axes if shp[0] % dsize == 0 else None
        sspec = "model" if shp[1] % sizes.get("model", 1) == 0 else None
        spec = (bspec, sspec, None, None)
        return ((None,) + spec) if stacked else spec
    return sharding.auto_pspec(shape, mesh, rules, stacked=stacked)


def cache_pspecs(cfg: ModelConfig, cache: dict, mesh,
                 rules: Optional[ShardingRules]) -> dict:
    """`cache_pspec` of every leaf of a port cache ({layer: {name:
    tensor}}, or the encoder-decoder's {"self"/"cross": {name: [L,
    ...]}}), in the same structure."""
    stacked = api.is_encdec(cfg)
    return {key: {name: cache_pspec(name, t.shape, mesh, rules, stacked)
                  for name, t in part.items()}
            for key, part in cache.items()}


def _batch_specs(cfg: ModelConfig, b: int, s: int, microbatches: int = 1,
                 device=None, generator=None) -> dict:
    """One batch of ``b`` rows of ``s`` positions: empty stand-ins on the
    meta device, random values from ``generator`` elsewhere.  With
    gradient accumulation every leaf is [mb, b/mb, ...].  Audio configs
    carry ``max(s // enc_seq_divisor, 8)`` float32 frames; vision configs
    ``vision_tokens`` float32 patches, which prepend to the sequence (the
    tokens are ``s - vision_tokens``, so the total stays ``s``)."""
    dev = resolve(device)
    lead = (microbatches,) if microbatches > 1 else ()
    bb = b // microbatches
    stand_in = dev.type == "meta"

    def tokens(shape):
        if stand_in:
            return torch.empty(lead + shape, dtype=torch.int64, device=dev)
        return torch.randint(0, cfg.vocab, lead + shape, generator=generator,
                             device=dev)

    def floats(shape):
        if stand_in:
            return torch.empty(lead + shape, device=dev)
        return torch.randn(lead + shape, generator=generator, device=dev)

    batch = {"tokens": tokens((bb, s))}
    if cfg.family == "audio":
        batch["frames"] = floats((bb, max(s // cfg.enc_seq_divisor, 8),
                                  cfg.d_model))
    if cfg.family == "vlm":
        batch["patches"] = floats((bb, cfg.vision_tokens, cfg.vit_dim))
        batch["tokens"] = tokens((bb, s - cfg.vision_tokens))
    return batch


class Cell(NamedTuple):
    """One cell's step and its arguments: ``step(*args)`` runs it on
    ``rows`` rows (over the whole mesh, where there is one: ``mesh``, the
    arguments DTensors on it)."""
    rows: int
    step: Callable
    args: tuple
    mesh: object = None


def build_cell(cfg: ModelConfig, shape_name: str, rows: Optional[int] = None,
               device="meta", use_kernel: bool = True,
               seq_len: Optional[int] = None,
               microbatches: Optional[int] = None, seed: int = 0,
               mesh=None, rules: Optional[ShardingRules] = None) -> Cell:
    """The cell of ``cfg`` at ``shape_name``: ``rows`` (default: the
    shape's global batch) of ``seq_len`` (default: the shape's) positions.

    With a ``mesh`` (a ``DeviceMesh``) the cell is placed on it
    (`shard_cell`, by ``rules``, default `default_rules_for`) and
    ``device`` is where each device's shards lie: "meta" to count, the
    card ("cuda"; the shards are drawn from ``seed`` on the card, the
    whole cell is never made) or the CPU (the whole cell is made from
    ``seed`` and split, as every rank makes it alike).

    A train cell is the train state in the reference's hyper-parameters
    (``microbatches`` overrides theirs) and one batch; a prefill cell the
    bf16 model and a prompt of ``seq_len``; a decode cell the bf16 model,
    a zeroed bf16 cache of ``seq_len`` positions and one token at the last
    one.  On ``device="meta"`` everything is a stand-in; elsewhere the
    weights and inputs are random, drawn from ``seed``.  ``use_kernel``:
    the kernels (True) or the plain path (False), as the model API takes
    it."""
    if mesh is not None:
        dev = resolve(device)
        whole = build_cell(cfg, shape_name, rows,
                           "meta" if dev.type == "cuda" else dev,
                           use_kernel, seq_len, microbatches, seed)
        return shard_cell(cfg, shape_name, whole, mesh, rules, dev, seed)
    shape = SHAPES[shape_name]
    rows = shape.global_batch if rows is None else rows
    s = shape.seq_len if seq_len is None else seq_len
    dev = resolve(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

    if shape.kind == "train":
        hyper = train_hyper_for(cfg.name)
        mb = hyper.microbatches if microbatches is None else microbatches
        if rows % mb:
            raise ValueError(f"{rows} rows do not split into {mb} "
                             f"microbatches")
        hyper = dataclasses.replace(hyper, microbatches=mb,
                                    use_kernel=use_kernel)
        state = init_train_state(cfg, hyper, gen, dev)
        batch = _batch_specs(cfg, rows, s, mb, dev, gen)
        return Cell(rows, make_train_step(cfg, hyper), (state, batch))

    model = api.init_params(cfg, gen, dev).to(SERVE_DTYPE)
    model.requires_grad_(False)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=s, use_kernel=use_kernel)
        return Cell(rows, step,
                    (model, _batch_specs(cfg, rows, s, 1, dev, gen)))

    # decode: one new token against a cache of s positions, at the last
    cache = api.init_cache(cfg, rows, s, SERVE_DTYPE, dev)
    if dev.type == "meta":
        token = torch.empty((rows,), dtype=torch.int64, device=dev)
    else:
        token = torch.randint(0, cfg.vocab, (rows,), generator=gen,
                              device=dev)
    return Cell(rows, make_decode_step(cfg), (model, cache, token, s - 1))


def distribute(t: Tensor, spec: tuple, mesh, device: torch.device,
               gen: Optional[torch.Generator]) -> DTensor:
    """``t`` (the whole tensor) as a DTensor of ``spec`` on ``mesh``, its
    shard on ``device``: split where ``t`` has values; where it is a meta
    stand-in, an empty shard on meta, else one drawn from ``gen`` (ids
    below 2**15 for an integer tensor, N(0, 0.02**2) for a float one)."""
    placements = sharding.placements(spec, mesh)
    if t.device.type != "meta":
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = sharding.local_shape(t.shape, spec, mesh,
                                 tuple(mesh.get_coordinate()))
    if device.type == "meta":
        shard = torch.empty(local, dtype=t.dtype, device=device)
    elif t.dtype.is_floating_point:
        shard = (torch.randn(local, generator=gen, device=device)
                 * 0.02).to(t.dtype)
    else:
        shard = torch.randint(0, 2 ** 15, local, generator=gen,
                              device=device, dtype=t.dtype)
    return DTensor.from_local(shard, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_module(model: torch.nn.Module, specs: dict, mesh, device, gen
                 ) -> None:
    """Each parameter of ``model`` replaced by its DTensor (`distribute`)
    in place, its ``requires_grad`` kept."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), specs[name], mesh, device, gen),
            requires_grad=p.requires_grad)


def _placed_outputs(step: Callable, specs: Callable, mesh) -> Callable:
    """``step`` with its results laid out as the reference's
    ``out_shardings`` ask: the next tokens replicated, the cache by
    ``specs(cache)``."""
    def placed(*args):
        tok, cache = step(*args)
        tok = tok.redistribute(mesh, [sharding.Replicate()] * mesh.ndim) \
            if isinstance(tok, DTensor) else tok
        want = specs(cache)
        return tok, {key: {name: (t.redistribute(
            mesh, sharding.placements(want[key][name], mesh))
            if isinstance(t, DTensor) else t) for name, t in part.items()}
            for key, part in cache.items()}
    return placed


def shard_cell(cfg: ModelConfig, shape_name: str, cell: Cell, mesh,
               rules: Optional[ShardingRules] = None, device="meta",
               seed: int = 0) -> Cell:
    """``cell`` (built whole, on meta or with values) placed on ``mesh``
    by ``rules`` (default: `default_rules_for` the cell): the parameters
    by `sharding.param_pspecs`, the AdamW moments as their parameters,
    the batch by `batch_pspecs` (the train hyper's microbatches), a
    decode cell's cache by `cache_pspecs`; a serving step's results are
    laid out as the reference's ``out_shardings``.  The step count, the
    next token and the position stay plain (replicated)."""
    kind = SHAPES[shape_name].kind
    rules = rules or default_rules_for(cfg.name, kind, mesh)
    dev = resolve(device)
    gen = None
    if dev.type not in ("meta", "cpu"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

    def batch_of(batch, mb=1, batch_rules=None):
        specs = batch_pspecs(batch, mesh, mb, batch_rules)
        return {k: distribute(t, specs[k], mesh, dev, gen)
                for k, t in batch.items()}

    if kind == "train":
        state, batch = cell.args
        place_module(state.model,
                     sharding.param_pspecs(cfg, state.model, mesh, rules),
                     mesh, dev, gen)
        params = dict(state.model.named_parameters())
        state = state._replace(
            opt=adamw_init(train_hyper_for(cfg.name).opt, params),
            step=(torch.zeros_like(state.step, device=dev)
                  if state.step.device.type == "meta" else state.step))
        mb = batch["tokens"].shape[0] if batch["tokens"].ndim == 3 else 1
        return Cell(cell.rows, cell.step,
                    (state, batch_of(batch, mb, rules)), mesh)

    model = cell.args[0]
    place_module(model, sharding.param_pspecs(cfg, model, mesh, rules),
                 mesh, dev, gen)

    def specs(cache):
        return cache_pspecs(cfg, cache, mesh, rules)

    step = _placed_outputs(cell.step, specs, mesh)
    if kind == "prefill":
        return Cell(cell.rows, step, (model, batch_of(cell.args[1])), mesh)
    _, cache, token, index = cell.args
    if token.device.type == "meta" and dev.type != "meta":
        # a stand-in token (the cell was built on meta for the card)
        token = torch.randint(0, cfg.vocab, tuple(token.shape),
                              generator=gen, device=dev)
    want = specs(cache)
    cache = {key: {name: distribute(t, want[key][name], mesh, dev, gen)
                   for name, t in part.items()}
             for key, part in cache.items()}
    return Cell(cell.rows, step, (model, cache, token, index), mesh)


def build_dtype(cfg: ModelConfig, shape_name: str) -> torch.dtype:
    """The dtype a cell's parameters are in: the train hyper's, else
    `SERVE_DTYPE`."""
    if SHAPES[shape_name].kind == "train":
        return getattr(torch, train_hyper_for(cfg.name).param_dtype)
    return SERVE_DTYPE


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def storage_bytes(tree) -> int:
    """Bytes of the distinct storages behind the tensors of ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def alloc_slack(n: int) -> int:
    """The most bytes the card's caching allocator can hand out beyond a
    request of ``n``: it rounds a block up to 512 B, and gives a request
    over 1 MiB a free block of up to 1 MiB more, unsplit."""
    n_round = n + (-n % 512)
    return n_round - n + (2**20 if n_round > 2**20 else 0)


def _touched(t: Tensor) -> int:
    """Bytes an op reads or writes of ``t``: its elements, a broadcast
    (stride 0) dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _leaves(x, out: list) -> list:
    """The tensors in ``x`` (an op's arguments or results, a step's), in
    order, appended to ``out``: nested tuples, lists and dicts, and a
    module's parameters and buffers."""
    if isinstance(x, Tensor):
        out.append(_local(x))
    elif isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    elif isinstance(x, torch.nn.Module):
        out.extend(_local(t) for t in x.parameters())
        out.extend(_local(t) for t in x.buffers())
    return out


def _local(t: Tensor) -> Tensor:
    """A DTensor's local shard (this device's part); a tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list:
    return _leaves(tree, [])


_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.memory_format, torch.layout)
_UNKEYED = object()     # an argument `_signature` has no key for


def _signature(x):
    """A hashable key for an op's arguments: each tensor's shape, strides,
    dtype and device (a meta tensor holds nothing else), every other
    argument's value; `_UNKEYED` where an argument has no such key."""
    if isinstance(x, Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        parts = tuple(_signature(y) for y in x)
        return _UNKEYED if any(p is _UNKEYED for p in parts) else parts
    if isinstance(x, dict):
        return _signature(tuple(sorted(x.items())))
    return x if isinstance(x, _HASHABLE) else _UNKEYED


def _template(out):
    """What rebuilds an op's result without running it: (shape, strides,
    dtype, device) of each tensor in its structure; None where the result
    holds anything else, or a tensor that is not on the meta device (an
    empty one would stand in for values)."""
    if isinstance(out, Tensor):
        if out.device.type != "meta":
            return None
        return ("t", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (tuple, list)):
        parts = tuple(_template(y) for y in out)
        return None if any(p is None for p in parts) else ("s", parts)
    return None


def _rebuild(tpl):
    if tpl[0] == "t":
        _, shape, stride, dtype, device = tpl
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)
    return tuple(_rebuild(p) for p in tpl[1])


# views whose schema does not say so
_UNMARKED_VIEWS = {aten._unsafe_view.default}


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """Whether ``func``'s results are new tensors: no argument or result
    of its schema aliases another (no view, no in-place or out= op)."""
    schema = func._schema
    return func not in _UNMARKED_VIEWS and not any(
        a.alias_info is not None
        for a in list(schema.arguments) + list(schema.returns))


# (op, its arguments' `_signature`) -> (FLOPs, bytes, `_template` of its
# results), for the ops `StepCounter` runs once per signature
_RESULTS: dict = {}

# ops that move no bytes: allocations without a fill
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default}
# gathers: they read of their source only what they write (an embedding
# lookup reads the looked-up rows, not the table)
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# a loop over time takes position t of a [B, T, ...] tensor, and its
# backward puts the gradient back there: the ops that mark its iterations
_STEP_SELECTS = {aten.select.int, aten.select_backward.default}


def _op_bytes(func, ins: list, outs: list) -> int:
    """The bytes one op moves: its operands read and results written
    (`_touched`), a gather's source as much as its result."""
    if func in _NO_TRAFFIC:
        return 0
    if func in _GATHERS:
        written = sum(_touched(t) for t in outs)
        return 2 * written + sum(_touched(t) for t in ins[1:])
    return sum(_touched(t) for t in ins + outs)


class StepCounter(TorchDispatchMode):
    """Counts, for the ops on meta tensors (the others, host-side scalars,
    run and are not counted) run after ``arguments`` (meta tensors,
    modules, containers of them; any other tensor among them raises) were
    made: ``flops``, by the formulas
    ``FlopCounterMode`` counts with (``flop_counter.flop_registry``: the
    matrix products and convolutions); ``bytes``, the sum of each op's
    operand and result bytes (`_op_bytes`; view ops and allocations
    without a fill move none, a gather reads what it writes); ``live``,
    the bytes of the arguments' storages and of those the ops allocated,
    while they are alive (a decode step that replaces a cache entry frees
    the old one); ``peak``, the most of ``live`` at once; ``trace``,
    ``live`` after every op; and with a ``loop_length`` T, ``marks``:
    (position in the trace, t) of each op that selects (or puts back)
    position t of a dimension of T, where a loop over time starts an
    iteration.  ``peak_upper`` is the most of ``live`` with each storage
    the ops allocated taken at its most on the card (`alloc_slack`), and
    ``argument_slack`` what the arguments' storages may take beyond their
    bytes there: the card's allocator can sit above the count by those,
    and below it only where the step frees an argument (a decode step's
    replaced cache entries), whose whole block goes.

    On meta tensors an op's results depend on its arguments' shapes,
    strides and dtypes only, so an op whose results are new meta tensors
    (`_fresh`) is run once per signature (`_RESULTS`, kept across
    counts): a repeat gets empty results of the same layout and the same
    counts (a model's layers repeat, and so do its cells).  The 40 cells'
    kernel-route count, ``rows_that_fit`` included, takes 82.7 s with it
    and 215.4 s without it, with equal counts, on one core of an Intel
    Xeon host (``scripts/dryrun_memo_cost.py``).
    ``aten.bincount`` has no meta kernel: on meta tensors it returns its
    ``minlength`` bins (an MoE router's expert ids are below its expert
    count, so the bins are exactly ``minlength``).  With ``sharded`` (the
    arguments are DTensors on a mesh) an op on DTensors is let through
    first (``NotImplemented``: DTensor lowers it to what this device runs
    on its shards, which the counter then sees), DTensor's sharding
    propagation on fake tensors is not counted, and a collective moves no
    memory bytes (`roofline.collectives` counts it)."""

    def __init__(self, arguments=(), loop_length: int = 0,
                 sharded: bool = False):
        super().__init__()
        self.sharded = sharded
        self.device = torch.device("meta")
        elsewhere = {str(t.device) for t in _tensors(arguments)
                     if t.device != self.device}
        if elsewhere:
            raise ValueError(f"StepCounter counts meta tensors only, not "
                             f"tensors on {sorted(elsewhere)}")
        self.loop_length = loop_length
        self.marks: list[tuple[int, int]] = []
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.trace = array("q")
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self._slack = 0     # alloc_slack of the live storages
        for t in _tensors(arguments):
            self._hold(t)
        self._arguments = set(self._sizes)
        self.argument_slack, self._slack = self._slack, 0
        self.peak = self.peak_upper = self.live

    def _release(self, key: int) -> None:
        n = self._sizes.pop(key, 0)
        self.live -= n
        if key in self._arguments:      # its address may come back
            self._arguments.discard(key)
        else:
            self._slack -= alloc_slack(n)
        self._refs.pop(key, None)

    def _hold(self, t: Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._release(k))
        self.live += n
        self._slack += alloc_slack(n)

    def allocated(self, tree) -> int:
        """Bytes of the storages behind ``tree`` that counted ops
        allocated and that are alive."""
        keys = {t.untyped_storage()._cdata
                for t in _tensors(tree)} - self._arguments
        return sum(self._sizes.get(k, 0) for k in keys)

    def _run(self, func, args, kwargs):
        if (func is aten.bincount.default
                and args[0].device.type == "meta"):
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            return torch.empty(n, dtype=torch.int64, device=args[0].device)
        return func(*args, **kwargs)

    def _flops(self, func, args, kwargs, out) -> int:
        formula = flop_registry.get(func._overloadpacket)
        return 0 if formula is None else formula(*args, **kwargs,
                                                 out_val=out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.sharded:
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(issubclass(t, collectives.SUBCLASSES) for t in types):
                # DTensor lowers the op to local ops and collectives
                # first: those are what one device runs
                return NotImplemented
            if collectives.is_propagation(types):
                return func(*args, **kwargs)
            if collectives.is_collective(func):
                # its bytes cross the links (`roofline.collectives`), not
                # memory; its results are live like any other
                out = self._run(func, args, kwargs)
                for t in _leaves(out, []):
                    if t.device == self.device:
                        self._hold(t)
                self._note()
                return out
        if _fresh(func):
            key = (func, _signature(args), _signature(kwargs))
            if key[1] is _UNKEYED or key[2] is _UNKEYED:
                key = None
            hit = _RESULTS.get(key) if key is not None else None
            if hit is not None:
                flops, nbytes, tpl = hit
                out = _rebuild(tpl)
            else:
                out = self._run(func, args, kwargs)
                outs = _leaves(out, [])
                ins = _leaves((args, kwargs), [])
                if not any(t.device == self.device for t in ins + outs):
                    return out
                flops = self._flops(func, args, kwargs, out)
                nbytes = _op_bytes(func, ins, outs)
                tpl = _template(out)
                if key is not None and tpl is not None:
                    _RESULTS[key] = (flops, nbytes, tpl)
            self.flops += flops
            self.bytes += nbytes
            for t in _leaves(out, []):
                self._hold(t)
        else:
            out = self._run(func, args, kwargs)
            ins = _leaves((args, kwargs), [])
            outs = _leaves(out, [])
            if not any(t.device == self.device for t in ins + outs):
                return out
            self.flops += self._flops(func, args, kwargs, out)
            if not (func.is_view or func in _UNMARKED_VIEWS):
                self.bytes += _op_bytes(func, ins, outs)
                held = {t.untyped_storage()._cdata for t in ins}
                for t in outs:
                    if t.untyped_storage()._cdata not in held:
                        self._hold(t)
        self._note()
        if self.loop_length and func in _STEP_SELECTS:
            size = args[0].shape if func is aten.select.int else args[1]
            if size[args[-2]] == self.loop_length:
                self.marks.append((len(self.trace) - 1, args[-1]))
        return out

    def _note(self) -> None:
        """The live bytes after an op: the peaks, the trace."""
        if self.live > self.peak:
            self.peak = self.live
        if self.live + self._slack > self.peak_upper:
            self.peak_upper = self.live + self._slack
        self.trace.append(self.live)


def _planned() -> dict:
    return {name: (m.PLANNED_LAUNCHES, m.PLANNED_FLOP, m.PLANNED_BYTES)
            for name, m in KERNELS.items()}


@contextlib.contextmanager
def on_mesh(mesh):
    """Where a step runs on ``mesh`` (not None): its plain tensors (the
    positions, the step count, the token) count as replicated on it."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield


def count_cell(cell: Cell, keep_trace: bool = False,
               loop_length: int = 0) -> dict:
    """Run ``cell``'s step once on its meta tensors (a cell built with
    ``device="meta"``; any other raises) under `StepCounter`.
    Returns its FLOPs and bytes (the kernels' formula counts included, and
    also apart as ``kernel_*``), ``argument_bytes`` (the storages of the
    step's arguments: parameters, optimizer state, batch, cache),
    ``output_bytes`` (the storages of its results that it allocated),
    ``peak_bytes`` (the most bytes its arguments and its own allocations
    held at once), ``temp_bytes`` = peak - argument, what the card's
    allocator may add to them (``argument_slack_bytes``,
    ``temp_upper_bytes``: `StepCounter`), the planned launches per kernel
    and ``count_s``; with ``keep_trace`` also ``trace``, the
    live bytes after every op (for `rows_that_fit`), and ``marks``
    (`StepCounter`, for ``loop_length``)."""
    before = _planned()
    arg_bytes = storage_bytes(cell.args)
    t0 = time.perf_counter()
    sharded = cell.mesh is not None
    colls = collectives.CollectiveCounter() if sharded else None
    with StepCounter(cell.args, loop_length, sharded) as counter, \
            on_mesh(cell.mesh), colls or contextlib.nullcontext():
        out = cell.step(*cell.args)
        out_bytes = counter.allocated(out)
    del out
    count_s = time.perf_counter() - t0
    after = _planned()
    launches = {name: after[name][0] - before[name][0] for name in KERNELS}
    k_flops = sum(after[n][1] - before[n][1] for n in KERNELS)
    k_bytes = sum(after[n][2] - before[n][2] for n in KERNELS)
    rec = {
        "rows": cell.rows,
        "flops": counter.flops + k_flops,
        "bytes": counter.bytes + k_bytes,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": counter.peak - arg_bytes,
        "peak_bytes": counter.peak,
        "argument_slack_bytes": counter.argument_slack,
        "temp_upper_bytes": counter.peak_upper - arg_bytes,
        "kernel_flops": k_flops,
        "kernel_bytes": k_bytes,
        "planned_launches": launches,
        "collectives": (colls.result() if sharded
                        else collectives.empty_result()),
        "count_s": count_s,
    }
    if keep_trace:
        rec["trace"] = counter.trace
        rec["marks"] = counter.marks
    return rec


def rows_that_fit(a: dict, b: dict, capacity: float) -> int:
    """The most rows whose peak is within ``capacity`` bytes, from the
    counts of one cell at r and r + 1 rows (`count_cell` with
    ``keep_trace``; r >= 2, since one row elides some ops): the live bytes
    after each op, arguments included, are affine in the rows, so every
    point is solved on its own (without a trace, the peaks are).  Returns
    r - 1 where r rows do not fit."""
    r = a["rows"]
    if a.get("trace") and len(a["trace"]) == len(b["trace"]):
        points = list(zip(a["trace"], b["trace"]))
    else:   # no trace, or the ops changed with the rows
        points = [(a["peak_bytes"], b["peak_bytes"])]
    points.append((a["argument_bytes"], b["argument_bytes"]))
    best = 1 << 62
    for v1, v2 in points:
        if v1 > capacity:
            return r - 1
        if v2 > v1:
            best = min(best, r + math.floor((capacity - v1) / (v2 - v1)))
    return best


# ---------------------------------------------------------------------------
# The xLSTM family's polynomial in the length
# ---------------------------------------------------------------------------

def uses_poly(cfg: ModelConfig, shape_name: str) -> bool:
    """Whether a cell is counted through `solve_poly` on one card: a train
    or prefill cell of a config with an sLSTM block (a Python loop over
    time)."""
    return ("slstm" in cfg.block_pattern
            and SHAPES[shape_name].kind in ("train", "prefill"))


def solve_poly(lengths, values, at: int, exact: bool = True) -> int:
    """c(at) for the c(T) = a + b T + c T^2 through the three points
    (lengths[i], values[i]), by Lagrange's form in exact rationals.  A
    count that is an integer polynomial in T comes out exact (``exact``
    raises where it does not); otherwise the fit is rounded."""
    total = Fraction(0)
    for i, (ti, vi) in enumerate(zip(lengths, values)):
        term = Fraction(vi)
        for j, tj in enumerate(lengths):
            if j != i:
                term *= Fraction(at - tj, ti - tj)
        total += term
    if exact and total.denominator != 1:
        raise ArithmeticError(f"counts {values} at {lengths} are not an "
                              f"integer polynomial at {at}")
    return round(total)


def loop_points(trace, marks, length: int) -> Optional[list]:
    """The live bytes at the points of one count that line up across
    lengths: every op outside the loops over time, and of each loop (a run
    of ``length`` marks at positions 0..T-1, or back) its first two and
    its last two iterations (the first and last may run ops of their own;
    those between are alike).  An inner iteration adds the same bytes to
    what its loop holds, so the loop's most is at one of those four; the
    rest of a loop is left out.  None where the inner iterations are not
    all as long."""
    runs: list = []
    for pos, t in marks:
        run = runs[-1] if runs else None
        if run and abs(t - run[-1][1]) == 1 and (
                len(run) < 2 or t - run[-1][1] == run[-1][1] - run[-2][1]):
            run.append((pos, t))
        else:
            runs.append([(pos, t)])
    points, start = [], 0
    for run in runs:
        if len(run) != length or length < 5:
            continue
        pos = [p for p, _ in run]
        if len({b - a for a, b in zip(pos[1:-1], pos[2:-1])}) != 1:
            return None
        points += trace[start:pos[2]]       # up to the second iteration
        points += trace[pos[-3]:pos[-1]]    # the last two
        start = pos[-1]
    return points + list(trace[start:])


def _count(cfg, shape_name, rows=None, use_kernel=True, microbatches=1,
           keep_trace=False, seq_len=None, mesh=None, rules=None) -> dict:
    """`count_cell` of a meta cell (on ``mesh``, a meta ``DeviceMesh``,
    per device, where one is given, always at the cell's own length);
    on one card, where `uses_poly`, counted at each of `POLY_LENGTHS` and
    solved for the cell's length (``seq_len``, default the shape's): the
    exact counts by `solve_poly`, the live bytes point by point along
    `loop_points` (its ``trace``), so the peak too.  Where the points do
    not line up, the peak is a fit of the peaks (``peak_fitted``)."""
    if mesh is not None or not uses_poly(cfg, shape_name):
        return count_cell(build_cell(cfg, shape_name, rows,
                                     use_kernel=use_kernel, seq_len=seq_len,
                                     microbatches=microbatches, mesh=mesh,
                                     rules=rules), keep_trace)
    lengths = POLY_LENGTHS
    recs = [count_cell(build_cell(cfg, shape_name, rows,
                                  use_kernel=use_kernel, seq_len=t,
                                  microbatches=microbatches),
                       keep_trace=True, loop_length=t)
            for t in lengths]
    at = SHAPES[shape_name].seq_len if seq_len is None else seq_len
    out = {k: solve_poly(lengths, [r[k] for r in recs], at)
           for k in EXACT_COUNTS}
    out["planned_launches"] = recs[-1]["planned_launches"]
    out["rows"] = recs[-1]["rows"]
    out["count_s"] = sum(r["count_s"] for r in recs)
    out["poly_lengths"] = list(lengths)
    out["collectives"] = collectives.empty_result()
    points = [loop_points(r["trace"], r["marks"], t)
              for r, t in zip(recs, lengths)]
    if None not in points and len({len(p) for p in points}) == 1:
        trace = [solve_poly(lengths, vals, at)
                 for vals in zip(*points)]
        out["peak_bytes"] = max(trace)
        if keep_trace:
            out["trace"] = trace
    else:
        out["peak_bytes"] = max(recs[-1]["peak_bytes"], solve_poly(
            lengths, [r["peak_bytes"] for r in recs], at, exact=False))
        out["peak_fitted"] = True
    out["temp_bytes"] = out["peak_bytes"] - out["argument_bytes"]
    return out


def _fit_rows(cfg, shape_name, capacity: float = H100.hbm_bytes
              ) -> tuple[int, Optional[str]]:
    """`rows_that_fit` of a cell's kernel route, from counts at 2 and 3
    rows, and at 1 row where 2 do not fit: (rows, None), or (0, why)."""
    two, three = (_count(cfg, shape_name, rows=r, keep_trace=True)
                  for r in (2, 3))
    fit = rows_that_fit(two, three, capacity)
    if fit >= 2:
        return fit, None
    # the arguments are affine in the rows: without a row, 3 a(2) - 2 a(3)
    fixed = 3 * two["argument_bytes"] - 2 * three["argument_bytes"]
    if fixed > capacity:
        return 0, (f"the arguments without a row ({fixed / 1e9:.4g} GB: "
                   f"parameters and optimizer state) exceed "
                   f"{capacity / 1e9:.4g} GB")
    one = _count(cfg, shape_name, rows=1)
    if one["peak_bytes"] <= capacity:
        return 1, None
    return 0, (f"one row peaks at {one['peak_bytes'] / 1e9:.4g} GB, over "
               f"{capacity / 1e9:.4g} GB")


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

def reference_rules(mesh) -> ShardingRules:
    """The rules the reference's roofline counts a cell with
    (``build_cell``'s default): the batch over the data axes, nothing
    else of production's."""
    return ShardingRules(data_axes=_data_axes(mesh))


def knob_values() -> dict:
    """The four hillclimb knobs as they stand now."""
    from repro_torch.models import moe as moe_mod

    return {"SEQ_SHARD_AXIS": attn_mod.SEQ_SHARD_AXIS,
            "DECODE_GROUPED_GQA": attn_mod.DECODE_GROUPED_GQA,
            "DISPATCH_MODE": moe_mod.DISPATCH_MODE,
            "EP_CONSTRAINT_AXIS": moe_mod.EP_CONSTRAINT_AXIS}


def rules_record(rules: ShardingRules, of: str) -> dict:
    """``rules``'s fields as a record states them, with ``of``: whose
    rules they are ("production": `default_rules_for` and
    `production_knobs`; "reference": `reference_rules`; "given": the
    caller's)."""
    out = {"of": of}
    for f in dataclasses.fields(rules):
        v = getattr(rules, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


@contextlib.contextmanager
def production_knobs(arch: str, shape_kind: str):
    """The reference's production defaults for a cell on a mesh: the
    sequence-sharded scores (`attention.SEQ_SHARD_AXIS`) for
    `SEQ_SHARD_ARCHS` on full-sequence cells, for the block's length."""
    prev = attn_mod.SEQ_SHARD_AXIS
    if arch in SEQ_SHARD_ARCHS and shape_kind in ("train", "prefill"):
        attn_mod.SEQ_SHARD_AXIS = "model"
    try:
        yield
    finally:
        attn_mod.SEQ_SHARD_AXIS = prev


def count_on_mesh(arch: str, shape_name: str, mesh,
                  rules: Optional[ShardingRules] = None,
                  use_kernel: bool = True, rows: Optional[int] = None
                  ) -> dict:
    """`_count` of a cell on ``mesh`` (a meta ``DeviceMesh``) with the
    reference's production rules (`default_rules_for`, unless ``rules``
    are given) and knobs (`production_knobs`): each device's share (rank
    0's shards) and its collectives."""
    cfg = get_config(arch)
    kind = SHAPES[shape_name].kind
    rules = rules or default_rules_for(arch, kind, mesh)
    with production_knobs(arch, kind):
        return _count(cfg, shape_name, rows, use_kernel=use_kernel,
                      mesh=mesh, rules=rules)


def run_mesh_cell(arch: str, shape_name: str, multi_pod: bool,
                  rules: Optional[ShardingRules] = None,
                  verbose: bool = True, use_kernel: bool = True,
                  production: bool = True) -> dict:
    """The dry-run record of one cell on a production mesh, with the
    reference's per-device keys (``flops_per_device``, ...,
    ``peak_bytes_per_device``, ``collectives``), counted on rank 0 of a
    fake group (`launch.mesh`) on either route: the kernels
    (``use_kernel``, the card's) or the plain path.  With ``production``
    (the dry run's) by the reference's production rules and knobs
    (`count_on_mesh`); without it (the roofline's and the hillclimb's)
    by ``rules`` (default `reference_rules`) with the knobs as the caller
    left them.  The record states both (``rules``, ``knobs``) and the
    ``route``."""
    cfg = get_config(arch)
    label = meshes.MESH_LABELS[multi_pod]
    rec = {"arch": arch, "shape": shape_name, "mesh": label}
    skip = shape_skip_reason(cfg, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    t0 = time.perf_counter()
    try:
        mesh = meshes.make_production_mesh(multi_pod, "meta")
        kind = SHAPES[shape_name].kind
        of = "given" if rules is not None else (
            "production" if production else "reference")
        if production:
            rules = rules or default_rules_for(arch, kind, mesh)
            with production_knobs(arch, kind):
                knobs = knob_values()
            got = count_on_mesh(arch, shape_name, mesh, rules, use_kernel)
        else:
            rules = rules or reference_rules(mesh)
            knobs = knob_values()
            got = _count(cfg, shape_name, use_kernel=use_kernel, mesh=mesh,
                         rules=rules)
        rec.update({
            "rules": rules_record(rules, of),
            "knobs": knobs,
            "route": "kernel" if use_kernel else "plain",
            "status": "ok",
            "kind": SHAPES[shape_name].kind,
            "dtype": str(build_dtype(cfg, shape_name)).replace("torch.", ""),
            "flops_per_device": got["flops"],
            "bytes_accessed_per_device": got["bytes"],
            "argument_bytes_per_device": got["argument_bytes"],
            "output_bytes_per_device": got["output_bytes"],
            "temp_bytes_per_device": got["temp_bytes"],
            "peak_bytes_per_device": got["peak_bytes"],
            "kernel_flops": got["kernel_flops"],
            "kernel_bytes": got["kernel_bytes"],
            "collectives": got["collectives"],
            "fits": got["peak_bytes"] <= H100.hbm_bytes,
            "planned_launches": got["planned_launches"],
        })
        rec["count_s"] = time.perf_counter() - t0
        if verbose:
            colls = {k: round(v / 2**20, 1) for k, v in
                     rec["collectives"]["bytes_by_kind"].items()}
            print(f"[{label}] {arch} x {shape_name}: "
                  f"args={rec['argument_bytes_per_device'] / 2**30:.2f}GiB "
                  f"temp={rec['temp_bytes_per_device'] / 2**30:.2f}GiB "
                  f"flops/dev={rec['flops_per_device']:.3g} "
                  f"colls={colls}MiB launches={rec['planned_launches']} "
                  f"(count {rec['count_s']:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["count_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[{label}] {arch} x {shape_name}: FAILED {rec['error']}",
                  flush=True)
    return rec


def run_cell(arch: str, shape_name: str, verbose: bool = True,
             plain: bool = True, mesh="card") -> dict:
    """The dry-run record of one cell: on one card (``mesh="card"``: the
    reference's keys where they have a meaning on one card, and the
    card's own; see the module's docstring), or on a production mesh
    ("16x16", "2x16x16": `run_mesh_cell`, the kernel route, by the
    production rules and knobs).
    ``plain``: on one card, also count the plain route (``plain_*``)."""
    if mesh != "card":
        return run_mesh_cell(arch, shape_name, mesh == "2x16x16",
                             verbose=verbose)
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": "1xH100"}
    skip = shape_skip_reason(cfg, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    t0 = time.perf_counter()
    try:
        got = _count(cfg, shape_name)
        fit, why = _fit_rows(cfg, shape_name)
        rec.update({
            "status": "ok",
            "kind": SHAPES[shape_name].kind,
            "dtype": str(build_dtype(cfg, shape_name)).replace("torch.", ""),
            "flops_per_device": got["flops"],
            "bytes_accessed_per_device": got["bytes"],
            "argument_bytes_per_device": got["argument_bytes"],
            "output_bytes_per_device": got["output_bytes"],
            "temp_bytes_per_device": got["temp_bytes"],
            "peak_bytes_per_device": got["peak_bytes"],
            "kernel_flops": got["kernel_flops"],
            "kernel_bytes": got["kernel_bytes"],
            "collectives": {"total_bytes": 0, "bytes_by_kind": {},
                            "counts": {}},
            "fits": got["peak_bytes"] <= H100.hbm_bytes,
            "rows_that_fit": fit,
            "planned_launches": got["planned_launches"],
        })
        if why:
            rec["rows_that_fit_reason"] = why
        for key in ("poly_lengths", "peak_fitted"):
            if key in got:
                rec[key] = got[key]
        if plain:
            if uses_poly(cfg, shape_name) or not any(
                    got["planned_launches"].values()):
                # no kernel on the path: the plain route is the same run
                ref = got
            else:
                ref = _count(cfg, shape_name, use_kernel=False)
            rec.update({"plain_flops_per_device": ref["flops"],
                        "plain_bytes_accessed_per_device": ref["bytes"],
                        "plain_peak_bytes_per_device": ref["peak_bytes"]})
        rec["count_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[1xH100] {arch} x {shape_name}: "
                  f"args={rec['argument_bytes_per_device'] / 2**30:.2f}GiB "
                  f"temp={rec['temp_bytes_per_device'] / 2**30:.2f}GiB "
                  f"flops={rec['flops_per_device']:.3g} "
                  f"bytes={rec['bytes_accessed_per_device']:.3g} "
                  f"fits={rec['fits']} rows_that_fit={fit} "
                  f"launches={rec['planned_launches']} "
                  f"(count {rec['count_s']:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["count_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[1xH100] {arch} x {shape_name}: FAILED {rec['error']}",
                  flush=True)
    return rec


def summary(records) -> str:
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    return (f"dry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} "
            f"failed")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=tuple(MESH_CHOICES), default="card",
                    help="card: one card's count (the default); single, "
                         "multi, both: per device on the 16x16 and "
                         "2x16x16 meshes")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    t0 = time.perf_counter()
    records = [run_cell(arch, shape,
                        mesh="card" if mp is None
                        else meshes.MESH_LABELS[mp])
               for arch in archs for shape in shapes
               for mp in MESH_CHOICES[args.mesh]]
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n{summary(records)}")
    print(f"counted in {time.perf_counter() - t0:.1f}s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print("wrote", args.out)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
