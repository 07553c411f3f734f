"""Where the model's tensors lie on a device mesh: the helpers that the
models and the kernels' dispatch (`kernels.ops`) call on every path.

On one card every tensor is a plain ``torch.Tensor`` and each helper here
returns its argument or does what the plain path does, so the one-card
paths are unchanged and the callers need no branch of their own.  On a
mesh the parameters are DTensors (`train.sharding`) and DTensor's
sharding propagation carries the activations; the helpers here do what
that propagation cannot:

* `constrain`: the reference's ``with_sharding_constraint(x, P(*spec))``,
  a redistribute to the placements the spec names (every mesh axis the
  spec does not name replicates, as jax reads a spec);
* `full_like_layout`, `write_at`, `put_rows`: caches made on the mesh
  (each device allocating its shard only) and written in place (DTensor
  would gather the whole cache for a ``select`` on a sharded dimension
  and write into the copy);
* `sharded_call`: a function (a kernel's wrapper) on each device's local
  shards, as ``local_map`` runs it, with an uneven shard allowed and the
  gradient of a replicated operand a partial sum; on it rest `lookup`
  (a vocabulary-sharded embedding), `project_heads` / `project_out` (the
  attention projections, which DTensor's einsum cannot split by head
  dim), `query_einsum` / `head_einsum` (the plain route's scores and
  probabilities with the queries sequence-sharded, the expanded-KV
  decode's), `nll_mean` (the vocabulary-parallel
  loss), `expert_scatter` /
  `expert_gather` (expert-parallel MoE), `whole_call`, `on_rows` and
  the kernels in `kernels.ops`;
* `residual`, `gathered`, `as_placed`, `grad_as`: the layouts a step
  keeps (the residual stream's, FSDP's gathered weights, a gradient's).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Tensor = torch.Tensor


def is_sharded(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def mesh_names(t: DTensor) -> tuple:
    return tuple(t.device_mesh.mesh_dim_names or ())


def constrain(x: Tensor, spec: Sequence) -> Tensor:
    """``x`` redistributed to ``spec`` (one entry per dimension: None or a
    mesh axis name), every other mesh axis replicated; a plain tensor, or
    a spec naming an axis that ``x``'s mesh lacks, is left as it is."""
    if not isinstance(x, DTensor):
        return x
    names = mesh_names(x)
    if any(a is not None and a not in names for a in spec):
        return x
    target = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        if axis is not None:
            target[names.index(axis)] = Shard(d)
    return x.redistribute(x.device_mesh, target)


def _mapped(placements, dims: dict) -> list:
    """``placements`` of a tensor for another tensor whose dimension
    ``dims[d]`` is its dimension d: a shard of a mapped dimension moves
    there; any other placement (a partial sum too) replicates."""
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in placements]


def full_like_layout(shape, value: float, dtype, like: DTensor,
                     dims: dict) -> DTensor:
    """A DTensor of ``shape`` filled with ``value`` on ``like``'s mesh,
    dimension ``dims[d]`` sharded as ``like``'s dimension d (`_mapped`),
    each device allocating its own shard only."""
    from torch.distributed.tensor import full

    return full(tuple(shape), value, dtype=dtype,
                device_mesh=like.device_mesh,
                placements=_mapped(like.placements, dims))


def _offset(t: DTensor, dim: int) -> int:
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    _, offsets = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return offsets[dim]


def write_at(cache: Tensor, dim: int, index, value) -> None:
    """``cache`` at position ``index`` (an int, or an index tensor) of
    dimension ``dim`` := ``value`` (the cache without that dimension, or a
    number), in place.  On a plain tensor it is ``cache.select(dim,
    index)``'s ``copy_`` (``fill_``), as ``cache[:, index] = value``
    writes; on a DTensor each device writes its own shard where the
    position lies in it, after ``value`` is laid out as the cache's other
    dimensions."""
    if not isinstance(value, Tensor):
        if not isinstance(cache, DTensor):
            cache.select(dim, index).fill_(value)
            return
        local, pos = _local_at(cache, dim, index)
        if pos is not None:
            local.select(dim, pos).fill_(value)
        return
    if not isinstance(cache, DTensor):
        cache.select(dim, index).copy_(value)
        return
    dims = {d: d - (d > dim) for d in range(cache.ndim) if d != dim}
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, cache.device_mesh,
                                   [Replicate()] * cache.device_mesh.ndim,
                                   run_check=False)
    target = _mapped(cache.placements, dims)
    local_value = value.redistribute(cache.device_mesh, target).to_local()
    local, pos = _local_at(cache, dim, index)
    if pos is not None:
        local.select(dim, pos).copy_(local_value)


def _local_at(cache: DTensor, dim: int, index) -> tuple:
    """(this device's shard of ``cache``, ``index``'s position in it along
    ``dim``, or None where it lies in another device's shard)."""
    local = cache.to_local()
    lo = _offset(cache, dim) if any(
        isinstance(p, Shard) and p.dim == dim for p in cache.placements) \
        else 0
    pos = int(index) - lo
    return local, (pos if 0 <= pos < local.shape[dim] else None)


def put_rows(cache: Tensor, dim: int, index: Tensor, value: Tensor) -> None:
    """``cache[:, index] = value`` with ``index`` at dimension ``dim`` (a
    prefill's writes into a ring cache), in place; on a DTensor, as
    ``index_copy_`` on each device's shard: ``value`` laid out as
    ``cache``, whose dimension ``dim`` no mesh axis may split (DTensor has
    no rule for the indexed write on every torch)."""
    if not isinstance(cache, DTensor):
        cache[(slice(None),) * dim + (index,)] = value
        return
    if any(isinstance(p, Shard) and p.dim == dim for p in cache.placements):
        raise ValueError(f"the cache's dimension {dim} is sharded")
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, cache.device_mesh,
                                   [Replicate()] * cache.device_mesh.ndim,
                                   run_check=False)
    local = value.redistribute(cache.device_mesh, cache.placements)
    cache.to_local().index_copy_(dim, index.to(cache.to_local().device),
                                 local.to_local())


def kernel_placements(like: DTensor, keep: Sequence[int],
                      model_dim: Optional[int]) -> list:
    """Placements on ``like``'s mesh for a kernel's operand: a mesh axis
    that shards a dimension in ``keep`` (the batch) keeps it; otherwise
    "model" shards ``model_dim`` (None: replicates) and the others
    replicate."""
    out = []
    for name, p in zip(mesh_names(like), like.placements):
        if isinstance(p, Shard) and p.dim in keep:
            out.append(p)       # the batch, on whatever axis shards it
        elif name == "model" and model_dim is not None:
            out.append(Shard(model_dim))
        else:
            out.append(Replicate())
    return out


def by_rows(t: DTensor) -> list:
    """Placements on ``t``'s mesh that split its rows (dimension 0) over
    every mesh axis, in the mesh's order: each device its own rows, one
    or none where they do not divide."""
    return [Shard(0)] * t.device_mesh.ndim


def model_size(t: DTensor) -> int:
    names = mesh_names(t)
    return t.device_mesh.size(names.index("model")) if "model" in names \
        else 1


def model_split(t: DTensor) -> int:
    """How many ways the model axis may split ``t``'s heads or channels:
    its size, or 1 where it already shards ``t``'s batch (pure data
    parallelism puts the model axis among the data axes)."""
    names = mesh_names(t)
    if "model" not in names:
        return 1
    p = t.placements[names.index("model")]
    return 1 if isinstance(p, Shard) and p.dim == 0 else model_size(t)


def model_rank(t: DTensor) -> int:
    names = mesh_names(t)
    return t.device_mesh.get_local_rank("model") if "model" in names else 0


def sharded_call(fn: Callable, args: Sequence, in_placements: Sequence,
                 out_placements, shape) -> Tensor:
    """``fn`` on each device's local shards of ``args`` (DTensors, plain
    tensors taken as replicated, or None) redistributed to
    ``in_placements``; its result a DTensor of global ``shape`` with
    ``out_placements`` (a shard may be uneven: DTensor's chunks of
    ceil(n / size)).  An operand whole on a mesh axis across which the
    result is split gets its gradient there as a partial sum: each
    device's share."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    local = []
    for a, at in zip(args, in_placements):
        if a is None:
            local.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        at = tuple(at)
        if tuple(a.placements) != at:
            a = a.redistribute(mesh, at)
        grad_at = tuple(Partial() if isinstance(p, Replicate)
                        and not isinstance(o, Replicate) else p
                        for p, o in zip(at, out_placements))
        local.append(a.to_local(grad_placements=grad_at))
    out = fn(*local).contiguous()       # the strides the DTensor states
    shape = tuple(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(out, mesh, tuple(out_placements),
                              run_check=False, shape=shape,
                              stride=tuple(stride))


def gathered(w: Tensor) -> Tensor:
    """A weight as a matrix product uses it: on a DTensor, its shards over
    the data axes (FSDP) gathered, its model-axis shard kept, as FSDP
    gathers a weight before its use (left to DTensor, a product of
    batch-sharded activations with a weight sharded on the contracted
    dimension over the same axes may move the activations instead); a
    plain tensor as it is."""
    if not isinstance(w, DTensor):
        return w
    at = tuple(p if name == "model" else Replicate()
               for name, p in zip(mesh_names(w), w.placements))
    return w if at == tuple(w.placements) else w.redistribute(
        w.device_mesh, at)


def residual(h: Tensor, y: Tensor) -> Tensor:
    """``h + y``, the residual add.  On DTensors ``y`` (a block's output,
    often a partial sum over the model axis) is first laid out as ``h``
    (the residual stream, the batch's layout), so the stream keeps one
    layout from block to block: DTensor's own choice may scatter a partial
    sum on the batch over the model axis and then gather the vocabulary at
    the head."""
    if isinstance(y, DTensor) and isinstance(h, DTensor) \
            and y.placements != h.placements:
        y = y.redistribute(h.device_mesh, h.placements)
    return h + y


class _VocabNLL(torch.autograd.Function):
    """Per token, logsumexp(x) - x[target] of this device's slice of the
    vocabulary (columns ``lo`` onward of the whole), the max, the sum and
    the picked target logit reduced over the model axis (``axis`` of
    ``mesh``; ``at``: the other axes' placements of the tokens).  The
    backward is local: softmax minus the one-hot of the target, on the
    slice."""

    @staticmethod
    def forward(ctx, xl, tl, mesh, axis, at, lo):
        def over_model(v, op):
            if axis is None:            # the vocabulary is whole here
                return v
            where = list(at)
            where[axis] = Partial(op)
            return DTensor.from_local(v, mesh, where, run_check=False
                                      ).redistribute(mesh, at).to_local()

        cols = xl.shape[1]
        top = over_model(xl.amax(dim=-1), "max")
        total = over_model(torch.sum(torch.exp(xl - top[:, None]), dim=-1),
                           "sum")
        lse = torch.log(total) + top
        inside = (tl >= lo) & (tl < lo + cols)
        local_t = torch.clamp(tl - lo, 0, cols - 1)
        picked = torch.gather(xl, 1, local_t[:, None])[:, 0]
        picked = over_model(picked * inside.to(xl.dtype), "sum")
        ctx.save_for_backward(xl, lse, local_t, inside)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        xl, lse, local_t, inside = ctx.saved_tensors
        grad = torch.exp(xl - lse[:, None])
        grad.scatter_add_(1, local_t[:, None],
                          -inside.to(grad.dtype)[:, None])
        grad.mul_(g[:, None])
        return grad, None, None, None, None, None


def nll_mean(logits: Tensor, targets: Tensor) -> Tensor:
    """The mean next-token NLL of DTensor ``logits`` [B, T, V] against
    ``targets`` [B, T], vocabulary-parallel (`_VocabNLL`): each device
    works on its slice of the vocabulary and its tokens, and only the
    per-token max, sum and target logit cross the mesh axis that splits
    the vocabulary (none where it is whole, as under pure data
    parallelism).  (DTensor's ``loss_parallel`` takes a one-axis mesh
    only, and its own reductions would re-lay the [tokens, vocabulary]
    gradient.)  On plain ``logits``: log-softmax, the targets' entries,
    their mean."""
    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        return nll.mean()
    x = logits.to(torch.float32).flatten(0, 1)
    mesh, names = x.device_mesh, mesh_names(x)
    at = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    vocab = [i for i, p in enumerate(x.placements) if p == Shard(1)]
    axis = vocab[0] if vocab else None
    t_at = list(at)
    if axis is not None:
        at[axis] = Shard(1)
    x = x.redistribute(mesh, at)
    t = targets.flatten().long()
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    t = t.redistribute(mesh, t_at)
    nll = _VocabNLL.apply(x.to_local(grad_placements=tuple(at)),
                          t.to_local(), mesh, axis, tuple(t_at),
                          _offset(x, 1))
    nll = DTensor.from_local(nll, mesh, t_at, run_check=False,
                             shape=(x.shape[0],), stride=(1,))
    return torch.sum(nll) / x.shape[0]


def lookup(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]``, the embedding lookup.  On a DTensor table each
    device looks its ids up in its own rows and the model axis sums the
    results (a vocabulary-sharded table), or it goes through
    ``F.embedding``, whose rule keeps the ids' batch shards (the indexing
    op's rule would gather the ids of the whole batch); either way the
    result is replicated on the model axis."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh, names = table.device_mesh, mesh_names(table)
    m = names.index("model") if "model" in names else None
    if m is None or table.placements[m] != Shard(0):
        out = torch.nn.functional.embedding(ids, table)
        return out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                       for p in out.placements])
    lo = _offset(table, 0)
    rows = table.to_local().shape[0]

    def local_lookup(tab, idx):
        inside = (idx >= lo) & (idx < lo + rows)
        got = torch.nn.functional.embedding(
            torch.clamp(idx - lo, 0, max(rows - 1, 0)), tab)
        return got * inside[..., None].to(got.dtype)

    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids_at = [Replicate() if i == m or not isinstance(p, Shard) else p
              for i, p in enumerate(ids.placements)]
    tab_at = [p if i == m else Replicate()
              for i, p in enumerate(table.placements)]
    out_at = [Partial() if i == m else p for i, p in enumerate(ids_at)]
    out = sharded_call(local_lookup, (table, ids), (tab_at, ids_at), out_at,
                       tuple(ids.shape) + (table.shape[1],))
    return out.redistribute(mesh, [Replicate() if i == m else p
                                   for i, p in enumerate(out_at)])


def project_heads(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("btd,dhk->bthk", x, w)`` (a Q/K/V projection) on each
    device's shards: ``x`` keeps its batch shards and replicates on the
    model axis, ``w`` keeps its model-axis shard of the heads or head_dim
    and is gathered on the data axes (FSDP), and the result is sharded as
    both.  DTensor's own einsum flattens (heads, head_dim) and cannot
    split that again where the model axis shards head_dim or an uneven
    head count.  On a plain ``w`` it is the einsum."""
    if not isinstance(w, DTensor):
        return torch.einsum("btd,dhk->bthk", x, w)
    x_at, w_at, out_at = [], [], []
    for name, px, pw in zip(mesh_names(w), _placements_of(x, w),
                            w.placements):
        if name == "model" and not (isinstance(px, Shard) and px.dim == 0):
            keep = isinstance(pw, Shard) and pw.dim in (1, 2)
            x_at.append(Replicate())
            w_at.append(pw if keep else Replicate())
            out_at.append(Shard(pw.dim + 1) if keep else Replicate())
        else:
            keep = isinstance(px, Shard) and px.dim in (0, 1)
            x_at.append(px if keep else Replicate())
            w_at.append(Replicate())
            out_at.append(px if keep else Replicate())
    return sharded_call(lambda xl, wl: torch.einsum("btd,dhk->bthk", xl, wl),
                        (x, w), (x_at, w_at), out_at,
                        tuple(x.shape[:2]) + tuple(w.shape[1:]))


def project_out(o: Tensor, w: Tensor) -> Tensor:
    """``einsum("bthk,hkd->btd", o, w)`` (the output projection) on each
    device's shards: ``o`` is laid out on the model axis as ``w``'s heads
    or head_dim, ``w`` is gathered on the data axes, and the result is a
    partial sum over the model axis where ``w`` is sharded there.  On a
    plain ``w`` it is the einsum."""
    if not isinstance(w, DTensor):
        return torch.einsum("bthk,hkd->btd", o, w)
    o_at, w_at, out_at = [], [], []
    for name, po, pw in zip(mesh_names(w), _placements_of(o, w),
                            w.placements):
        if name == "model" and not (isinstance(po, Shard) and po.dim == 0):
            keep = isinstance(pw, Shard) and pw.dim in (0, 1)
            o_at.append(Shard(pw.dim + 2) if keep else Replicate())
            w_at.append(pw if keep else Replicate())
            out_at.append(Partial() if keep else Replicate())
        else:
            keep = isinstance(po, Shard) and po.dim in (0, 1)
            o_at.append(po if keep else Replicate())
            w_at.append(Replicate())
            out_at.append(po if keep else Replicate())
    return sharded_call(lambda ol, wl: torch.einsum("bthk,hkd->btd", ol, wl),
                        (o, w), (o_at, w_at), out_at,
                        tuple(o.shape[:2]) + (w.shape[2],))


def _einsum_by_hand(equation: str, a: Tensor, b: Tensor, shape) -> Tensor:
    """``einsum(equation, a, b)`` of two DTensors of the attention's
    layout (``a`` and the result [B, T, H, ...], ``b`` [B, S, H, ...];
    ``shape`` the result's) on each device's shards, per mesh axis: where
    it shards ``a``'s queries (dimension 1) they keep their shards and
    ``b`` is whole; where it shards ``a``'s heads (dimension 2) both split
    their heads; where it shards either one's batch both split it (the
    sequence knob's constraint replicates the queries' batch); any other
    axis replicates."""
    a_at, b_at = [], []
    for pa, pb in zip(a.placements, _placements_of(b, a)):
        if pa == Shard(1):
            a_at.append(pa)
            b_at.append(Replicate())
        elif pa == Shard(2):
            a_at.append(pa)
            b_at.append(pa)
        elif Shard(0) in (pa, pb):
            a_at.append(Shard(0))
            b_at.append(Shard(0))
        else:
            a_at.append(Replicate())
            b_at.append(Replicate())
    return sharded_call(lambda al, bl: torch.einsum(equation, al, bl),
                        (a, b), (a_at, b_at), a_at, shape)


def query_einsum(equation: str, a: Tensor, b: Tensor, shape) -> Tensor:
    """``einsum(equation, a, b)`` for the plain attention's two products
    (``"bthd,bshd->bths"``, ``"bths,bshd->bthd"``): where a mesh axis
    shards ``a``'s queries (the sequence-sharding knob) laid out by hand
    (`_einsum_by_hand`), since DTensor's own einsum may re-lay a chunk's
    [T, S] scores and then cannot view them back; otherwise, and on
    plain tensors, the einsum."""
    if not isinstance(a, DTensor) or Shard(1) not in a.placements:
        return torch.einsum(equation, a, b)
    return _einsum_by_hand(equation, a, b, shape)


def head_einsum(equation: str, a: Tensor, b: Tensor, shape) -> Tensor:
    """``einsum(equation, a, b)`` for the expanded-KV decode's two
    products (the query [B, 1, H, D] against the cache's KV heads
    repeated to H): on a DTensor laid out by hand (`_einsum_by_hand`,
    the heads split where the query's are), since DTensor's own einsum
    flattens the batch with the sharded heads, which it cannot do on
    every torch; on plain tensors the einsum."""
    if not isinstance(a, DTensor):
        return torch.einsum(equation, a, b)
    return _einsum_by_hand(equation, a, b, shape)


def _placements_of(x: Tensor, like: DTensor):
    return x.placements if isinstance(x, DTensor) \
        else [Replicate()] * like.device_mesh.ndim


def unshard(x: Tensor, dims: Sequence[int]) -> Tensor:
    """``x`` with every mesh axis that shards one of ``dims`` replicated
    (before a view that splits such a dimension unevenly); a plain tensor
    as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim in dims for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim in dims else p
        for p in x.placements])


def argmax_last(x: Tensor) -> Tensor:
    """``torch.argmax(x, dim=-1)``.  On a DTensor whose last dimension one
    mesh axis shards (vocabulary-sharded logits) it reduces in two steps:
    each device's maximum and its index, then the first best of the
    devices' candidates (DTensor's own rule breaks at a batch of one)."""
    d = x.ndim - 1
    on = [i for i, p in enumerate(getattr(x, "placements", ()))
          if isinstance(p, Shard) and p.dim == d]
    if len(on) != 1:
        return torch.argmax(unshard(x, (d,)), dim=-1)
    mesh, axis = x.device_mesh, on[0]
    lo = _offset(x, d)
    at = [Replicate() if i == axis or not isinstance(p, Shard) else p
          for i, p in enumerate(x.placements)]
    x_at = list(at)
    x_at[axis] = Shard(d)       # the candidates [..., devices] too

    def local_best(xl):
        vals, idx = torch.max(xl, dim=-1, keepdim=True)
        return vals, idx + lo

    from torch.distributed.tensor.experimental import local_map

    vals, idx = local_map(local_best, out_placements=(tuple(x_at),
                                                      tuple(x_at)),
                          in_placements=(tuple(x_at),), device_mesh=mesh,
                          redistribute_inputs=True)(x)
    vals = vals.redistribute(mesh, at)
    idx = idx.redistribute(mesh, at)
    pick = torch.argmax(vals, dim=-1, keepdim=True)
    return torch.gather(idx, -1, pick)[..., 0]


def _row_block(n_rows: int, like: DTensor) -> tuple[int, int]:
    """(first row, rows) of the block of ``n_rows`` rows that this device's
    model-axis position holds, the rows split in equal blocks."""
    m = model_size(like)
    rows = n_rows // m
    return model_rank(like) * rows, rows


def _token_at(x: DTensor) -> tuple:
    """Placements for a [tokens, ...] operand of the expert dispatch: its
    data-axis shards of the tokens kept, replicated elsewhere."""
    return tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                 and name != "model" else Replicate()
                 for name, p in zip(mesh_names(x), x.placements))


def expert_scatter(xf: Tensor, slot: Tensor, keep: Tensor, n_experts: int,
                   cap: int, k: int) -> Tensor:
    """The expert buffer [E, C, d] of an MoE dispatch on DTensors, expert
    parallel: each device adds its own tokens (``xf`` [N, d], each one's k
    entries ``slot``/``keep`` [N*k], rows of the [E*C, d] buffer) into the
    experts its model-axis position holds, so the buffer is sharded on
    its experts over the model axis and a partial sum over the data axes.
    The one-card dispatch adds every entry into one whole buffer
    (`moe.moe_forward`)."""
    if model_size(xf) == 1 or n_experts % model_size(xf):
        raise ValueError(f"{n_experts} experts do not split over the "
                         f"model axis")
    lo, rows = _row_block(n_experts * cap, xf)

    def local_scatter(xl, sl, kl):
        inside = (sl >= lo) & (sl < lo + rows) & kl
        src = xl.repeat_interleave(k, dim=0) * inside[:, None].to(xl.dtype)
        buf = torch.zeros((rows, xl.shape[1]), dtype=xl.dtype,
                          device=xl.device)
        buf = buf.index_add(0, torch.clamp(sl - lo, 0, rows - 1), src)
        return buf.reshape(rows // cap, cap, xl.shape[1])

    at = _token_at(xf)
    out_at = [Shard(0) if name == "model" else
              (Partial() if isinstance(p, Shard) else Replicate())
              for name, p in zip(mesh_names(xf), at)]
    return sharded_call(local_scatter, (xf, slot, keep), (at, at, at),
                        out_at, (n_experts, cap, xf.shape[1]))


class _GradAs(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and g.placements != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as(x: Tensor) -> Tensor:
    """``x``, with its gradient reduced to ``x``'s own layout as it comes
    back (a partial sum over the model axis is summed there at once):
    DTensor's backward of a top-k would otherwise carry the partial sum
    into a scatter whose layout a multi-pod backward cannot view back."""
    return _GradAs.apply(x) if isinstance(x, DTensor) else x


def expert_gather(out: Tensor, slot: Tensor, weight: Tensor,
                  k: int) -> Tensor:
    """The combine of an MoE on DTensors: each token's k expert outputs
    (rows ``slot`` [N*k] of ``out`` [E, C, d] as [E*C, d], its experts
    sharded over the model axis), times ``weight`` [N*k], summed over the
    k: each device gathers the rows it holds, so the result [N, d] is a
    partial sum over the model axis, its tokens sharded as ``slot``."""
    lo, rows = _row_block(out.shape[0] * out.shape[1], out)
    weight = grad_as(weight)

    def local_gather(ol, sl, wl):
        ol = ol.reshape(-1, ol.shape[-1])
        inside = (sl >= lo) & (sl < lo + rows)
        got = ol[torch.clamp(sl - lo, 0, rows - 1)] * (
            wl * inside.to(wl.dtype))[:, None]
        return torch.sum(got.reshape(-1, k, ol.shape[1]), dim=1)

    at = _token_at(slot)
    rows_at = [Shard(0) if name == "model" else Replicate()
               for name in mesh_names(out)]
    out_at = [Partial() if name == "model" else p
              for name, p in zip(mesh_names(slot), at)]
    return sharded_call(local_gather, (out, slot, weight),
                        (rows_at, at, at), out_at,
                        (slot.shape[0] // k, out.shape[2]))


def whole_call(fn: Callable, x: Tensor, shape) -> Tensor:
    """``fn(x)``; on a DTensor ``x``, on the whole of it, replicated, on
    each device, the result (of global ``shape``) replicated: for what
    DTensor has no rule for (``torch.bincount``) or what reads every
    element at once (an MoE's ranks of the tokens in their experts)."""
    if not isinstance(x, DTensor):
        return fn(x)
    at = [Replicate()] * x.device_mesh.ndim
    return sharded_call(fn, (x,), (at,), at, shape)


def bincount(x: Tensor, minlength: int) -> Tensor:
    """``torch.bincount`` (`whole_call`)."""
    return whole_call(lambda xl: torch.bincount(xl, minlength=minlength), x,
                      (minlength,))


def on_rows(fn: Callable, args: Sequence, split: Sequence[bool], shape,
            like: Tensor, dims: dict) -> Tensor:
    """``fn(*args)``.  On a DTensor ``like`` each device runs ``fn`` on its
    own rows (`by_rows`) of every operand that ``split`` marks, the others
    whole, and the result (of global ``shape``) comes back laid out as
    ``like``, its dimension d at ``dims[d]`` (`_mapped`): DTensor cannot
    reshape rows split unevenly over several axes."""
    if not isinstance(like, DTensor):
        return fn(*args)
    at = by_rows(like)
    whole = [Replicate()] * len(at)
    out = sharded_call(fn, args, [at if s else whole for s in split], at,
                       shape)
    return out.redistribute(like.device_mesh, _mapped(like.placements, dims))


def as_placed(g: Tensor, like: Tensor) -> Tensor:
    """``g`` (a gradient) laid out as ``like`` (its parameter): a
    redistribute on a DTensor whose placements differ (a partial sum over
    the data axes is reduced there), ``g`` itself otherwise."""
    if not isinstance(g, DTensor) or g.placements == like.placements:
        return g
    return g.redistribute(like.device_mesh, like.placements)
