"""Collective-communication bytes of a step, counted as it runs (the port's
counterpart of ``repro/roofline/hlo.py``).

The reference parses the collectives out of the SPMD-partitioned HLO
text and sums each one's result-tensor bytes.  Here DTensor's sharding
propagation stands for GSPMD: a step on DTensors issues its collectives
as functional ops (``_c10d_functional.all_gather_into_tensor``,
``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, and
DTensor's ``_dtensor.shard_dim_alltoall``), and `CollectiveCounter`, a
``TorchDispatchMode``, sees each of them with its local tensors and sums
its result bytes per device under the reference's kind names, by the
reference's convention (the gathered tensor of an all-gather, the
scattered shard of a reduce-scatter).  It returns the reference's keys:
``count_by_kind``, ``bytes_by_kind``, ``total_bytes``,
``unknown_dtypes``.

On a fake process group (`launch.mesh.fake_group`) the collectives move
nothing but are issued all the same, so the count is the one a real group
of as many ranks would see; on NCCL or gloo the same mode counts a real
run.  A DTensor op is let through first (the mode answers
``NotImplemented``), so the mode sees what DTensor lowers it to.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _get_current_dispatch_mode_stack)

# tensor subclasses that lower an op before a mode should see it
SUBCLASSES = (DTensor, AsyncCollectiveTensor)


def is_propagation(types) -> bool:
    """Whether an op is DTensor's sharding propagation, run on fake
    tensors of the whole (global) shapes to learn its results' layout (or
    the meta kernel a fake tensor runs inside it): no device runs it."""
    return (any(issubclass(t, FakeTensor) for t in types)
            or any(isinstance(m, FakeTensorMode)
                   for m in _get_current_dispatch_mode_stack()))

# the ops of the functional collectives' namespaces, by name, and the
# reference's kind of each (a DTensor step issues no permute; a broadcast,
# no kind of the reference's, keeps its own name)
_KIND_OF_NAME = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    # c10d's own in-place ops (a caller's ``dist.all_reduce`` and so on)
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_NAMESPACES = {"_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "_dtensor", "c10d"}
# the c10d in-place ops write into their first argument: its tensors are
# the results
_IN_PLACE_NAMESPACES = {"c10d"}


def kind_of(func) -> str | None:
    """The reference's kind of a collective op, None for any other op."""
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    return _KIND_OF_NAME.get(func._schema.name.split("::")[-1])


def is_collective(func) -> bool:
    return getattr(func, "namespace", None) in _NAMESPACES


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def result_bytes(func, args, out, unknown: set) -> int:
    """Bytes of a collective's result tensors on this device."""
    results = _tensors(args[0] if func.namespace in _IN_PLACE_NAMESPACES
                       else out, [])
    total = 0
    for t in results:
        try:
            width = t.element_size()
        except RuntimeError:          # a dtype without a byte width
            unknown.add(str(t.dtype).removeprefix("torch."))
            width = 4
        total += t.numel() * width
    return total


def empty_result() -> dict:
    return {"count_by_kind": {}, "bytes_by_kind": {}, "total_bytes": 0.0,
            "unknown_dtypes": []}


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued while it is active (see the module's
    docstring); `result` gives the reference's dict."""

    def __init__(self):
        super().__init__()
        self.count: Counter = Counter()
        self.bytes: Counter = Counter()
        self.unknown: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, SUBCLASSES) for t in types):
            return NotImplemented
        if is_propagation(types):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        kind = kind_of(func)
        if kind is not None:
            self.count[kind] += 1
            self.bytes[kind] += result_bytes(func, args, out, self.unknown)
        return out

    def result(self) -> dict:
        return {
            "count_by_kind": {k: self.count[k] for k in self.count
                              if self.count[k]},
            "bytes_by_kind": {k: float(self.bytes[k]) for k in self.bytes
                              if self.bytes[k]},
            "total_bytes": float(sum(self.bytes.values())),
            "unknown_dtypes": sorted(self.unknown),
        }
