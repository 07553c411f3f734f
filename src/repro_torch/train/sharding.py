"""Sharding rules: parameter path -> partition spec over the production
mesh, and the DTensor placements of a spec (the port of
``repro/train/sharding.py``).

Mesh axes: ("pod",) "data", "model".  The batch shards over (pod, data);
tensor and expert parallelism over "model".  The rules go by a leaf's
name and its parent's, with shape-aware fallbacks: an attention
projection shards its head axis when the head count divides the model
axis, else its head_dim axis, else the model dim, else it replicates
(qwen3's 8 KV heads and llama4's 40 heads do not divide 16; internvl's
vocab 151655 is odd, so its embedding shards d_model instead).  An
optional FSDP mode also shards the large matrices over the data axes
(ZeRO-3 style).

A spec is a tuple with one entry per tensor dimension, as the reference's
``PartitionSpec``: None (replicated), a mesh axis name, or a tuple of axis
names (FSDP's data axes, the batch's).  The port keeps one tensor per
layer where the reference stacks the layer groups (``_STACKED``) under a
leading axis, so a port leaf's spec is the reference's without that
axis's leading None; a leaf's (parent, name) are the last two parts of
its parameter name, as they are of the reference's path
(``layers.3.attn.wq``: ``attn``, ``wq``; ``groups/b1/attn/wq`` there).

`placements` turns a spec into DTensor placements, one per mesh
dimension: ``Shard(d)`` on each mesh dimension whose axes tensor
dimension d names, ``Replicate()`` on the others.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_names, axis_sizes, mesh_groups

# the reference's stacked subtrees: a leaf under one of them carries a
# leading layer axis there, and a tensor per layer here
_STACKED = ("groups", "enc", "dec")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    fsdp: bool = False
    data_axes: tuple = ("pod", "data")
    tensor_parallel: bool = True      # False: pure FSDP — the "model" axis
                                      # joins data_axes and no weight axis
                                      # is model-sharded
    decode_cache_seq_shard: bool = False  # shard KV caches on the sequence
                                          # axis over "model"


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _pick(shape, prefs, msize):
    """Assign "model" to the first preferred axis whose dim divides msize."""
    out = [None] * len(shape)
    if msize <= 1:                       # tensor parallelism disabled
        return out
    for ax in prefs:
        if ax < len(shape) and _div(shape[ax], msize):
            out[ax] = "model"
            return out
    return out


def _with_fsdp(spec, shape, axis, dsize, enabled):
    if enabled and spec[axis] is None and _div(shape[axis], dsize):
        spec = list(spec)
        spec[axis] = "data"
    return spec


def _spec_for(parent: str, name: str, shape, rules: ShardingRules,
              msize: int, dsize: int):
    nd = len(shape)
    f = rules.fsdp

    if name == "embed":                       # [V, D]
        return _pick(shape, (0, 1), msize)
    if name == "head":                        # [D, V]
        return _with_fsdp(_pick(shape, (1, 0), msize), shape, 0, dsize, f)
    if name == "proj_vision":
        return [None, None]

    if parent in ("attn", "self_attn", "cross_attn"):
        if name == "wq" or name == "wk" or name == "wv":   # [D, H, dh]
            return _with_fsdp(_pick(shape, (1, 2), msize), shape, 0, dsize, f)
        if name == "wo":                       # [H, dh, D]
            return _with_fsdp(_pick(shape, (0, 1), msize), shape, 2, dsize, f)
        if name in ("bq", "bk", "bv"):         # [H, dh]
            return _pick(shape, (0, 1), msize)
        return [None] * nd                     # q_norm / k_norm

    if parent in ("ffn", "shared"):
        if name in ("gate", "up"):             # [D, F]
            return _with_fsdp(_pick(shape, (1,), msize), shape, 0, dsize, f)
        if name == "down":                     # [F, D]
            return _with_fsdp(_pick(shape, (0,), msize), shape, 1, dsize, f)

    if parent == "moe":
        if name == "router":
            return [None, None]
        if name in ("w_gate", "w_up", "w_down"):   # [E, D, F] / [E, F, D]
            spec = _pick(shape, (0,), msize)       # expert parallel
            return _with_fsdp(spec, shape, 1, dsize, f)

    if parent == "rec":
        if name in ("w_lin", "w_x", "w_a", "w_i"):     # [D, Dr]
            return _with_fsdp(_pick(shape, (1,), msize), shape, 0, dsize, f)
        if name == "conv_w":                   # [W, Dr]
            return _pick(shape, (1,), msize)
        if name == "w_out":                    # [Dr, D]
            return _with_fsdp(_pick(shape, (0,), msize), shape, 1, dsize, f)
        if name in ("conv_b", "lam"):          # [Dr]
            return _pick(shape, (0,), msize)

    if parent == "mlstm":
        if name in ("w_up", "w_gate", "conv_w"):       # [D, Di] / [W, Di]
            return _with_fsdp(_pick(shape, (1,), msize), shape, 0, dsize, f)
        if name in ("wq", "wk", "wv", "w_if"):         # [Di, H, x]
            return _pick(shape, (0, 2), msize)
        if name == "b_if":
            return [None] * nd
        if name in ("conv_b", "skip", "out_norm"):     # [Di]
            return _pick(shape, (0,), msize)
        if name == "w_down":                   # [Di, D]
            return _with_fsdp(_pick(shape, (0,), msize), shape, 1, dsize, f)

    if parent == "slstm":
        if name == "w_gates":                  # [D, H, 4, dh]
            return _pick(shape, (1, 3), msize)
        if name == "r_gates":                  # [H, 4, dh, dh]
            return _pick(shape, (0, 3), msize)
        if name == "b_gates":                  # [H, 4, dh]
            return _pick(shape, (0, 2), msize)
        if name in ("ff_gate", "ff_up"):
            return _with_fsdp(_pick(shape, (1,), msize), shape, 0, dsize, f)
        if name == "ff_down":
            return _with_fsdp(_pick(shape, (0,), msize), shape, 1, dsize, f)
        return [None] * nd                     # conv/out_norm on d_model

    return [None] * nd                         # norms, scalars


def default_rules(mesh) -> ShardingRules:
    """The rules for ``mesh`` when none are given: every axis but "model"
    carries data."""
    return ShardingRules(
        data_axes=tuple(a for a in axis_names(mesh) if a != "model"))


def _sizes(mesh, rules: ShardingRules) -> tuple[int, int]:
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1) if rules.tensor_parallel else 1
    dsize = 1
    for a in rules.data_axes:
        dsize *= sizes.get(a, 1)
    return msize, dsize


def param_spec(name: str, shape, mesh, rules: ShardingRules = None) -> tuple:
    """The spec of the parameter ``name`` (the port's dotted name) of
    ``shape`` (one layer's: no stacked axis)."""
    rules = rules or default_rules(mesh)
    msize, dsize = _sizes(mesh, rules)
    parts = name.split(".")
    parent = parts[-2] if len(parts) >= 2 else ""
    spec = _spec_for(parent, parts[-1], tuple(shape), rules, msize, dsize)
    # FSDP "data" means all data axes
    return tuple(rules.data_axes if s == "data" else s for s in spec)


def param_pspecs(cfg, params, mesh, rules: ShardingRules = None) -> dict:
    """{parameter name: spec} for ``params``: a model, or a dict from the
    model's parameter names to tensors (or shapes).  ``cfg`` is the
    model's config, as the reference takes it."""
    del cfg     # the rules read the names and shapes only
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {name: param_spec(name, getattr(p, "shape", p), mesh, rules)
            for name, p in params.items()}


def batch_pspec(rules: ShardingRules = None) -> tuple:
    rules = rules or ShardingRules()
    return (rules.data_axes,)


def auto_pspec(shape, mesh, rules: ShardingRules = None,
               stacked: bool = False) -> tuple:
    """Heuristic spec for activation-like arrays (caches, batches): shard the
    first divisible axis over the data axes and the next divisible axis over
    "model". Falls back to replication per-axis."""
    rules = rules or default_rules(mesh)
    sizes = axis_sizes(mesh)
    dsize = 1
    for a in rules.data_axes:
        dsize *= sizes.get(a, 1)
    msize = sizes.get("model", 1)
    spec = [None] * len(shape)
    start = 1 if stacked else 0
    # batch-like axis -> data
    for i in range(start, len(shape)):
        if _div(shape[i], dsize):
            spec[i] = rules.data_axes
            start = i + 1
            break
    # model axis: prefer trailing dims (head_dim / kv heads), never the
    # huge sequence axis of a KV cache
    for i in reversed(range(start, len(shape))):
        if spec[i] is None and _div(shape[i], msize) and shape[i] >= msize:
            spec[i] = "model"
            break
    return tuple(spec)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension
    in its order: ``Shard(d)`` where tensor dimension d names that
    dimension's axes (alone or in a tuple: FSDP's ("pod", "data") on one
    tensor dimension is a ``Shard(d)`` on each of the two, or on the one
    that stands for both, `launch.mesh.mesh_groups`), ``Replicate()``
    elsewhere."""
    out = []
    for group, _ in mesh_groups(mesh):
        named = [d for d, entry in enumerate(spec)
                 if set(group) & set((entry,) if isinstance(entry, str)
                                     else entry or ())]
        if len(named) > 1:
            raise ValueError(f"mesh axes {group} name dims {named} of "
                             f"{spec}")
        if named:
            entry = spec[named[0]]
            if not set(group) <= set((entry,) if isinstance(entry, str)
                                     else entry):
                raise ValueError(f"{spec} splits the mesh dimension of "
                                 f"{group}")
        out.append(Shard(named[0]) if named else Replicate())
    return tuple(out)


def local_shape(shape, spec, mesh, coordinate: Optional[tuple] = None
                ) -> tuple:
    """The shape of the shard of a ``shape`` tensor with ``spec`` at mesh
    ``coordinate`` (default: all zeros, the first rank's), each dimension
    split as DTensor splits it: in chunks of ceil(n / size), the last
    ones shorter or empty."""
    sizes = [size for _, size in mesh_groups(mesh)]
    coordinate = coordinate or (0,) * len(sizes)
    out = list(shape)
    for p, size, c in zip(placements(spec, mesh), sizes, coordinate):
        if isinstance(p, Shard):
            n = out[p.dim]
            chunk = -(-n // size)
            out[p.dim] = max(0, min(chunk, n - c * chunk))
    return tuple(out)
