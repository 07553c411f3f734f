"""The production meshes as ``DeviceMesh``es (the port of
``repro/launch/mesh.py``).

Single pod: (16, 16) as ("data", "model"), 256 devices.  Multi-pod:
(2, 16, 16) as ("pod", "data", "model"), 512 devices, built as the same
devices in a (32, 16) mesh whose first dimension stands for the pod and
data axes together (`make_production_mesh`).  A mesh lives on the
default process group, whatever its backend:

* counting (`launch.dryrun`, `roofline.analysis`): a fake group of 256 or
  512 ranks (`fake_group`, torch's ``"fake"`` backend), in which this
  process plays rank 0.  Its collectives return at once and move nothing,
  so a step on it runs each device's share of the work on rank 0's local
  shards, and its collectives can be counted (`roofline.collectives`);
* running: NCCL over the cards, or gloo over CPU processes in the tests,
  the group the caller brought up.

Everything is made by a call, nothing at import, as in the reference.
`MeshShape` stands for a mesh where only its axis names and sizes are
read (the sharding rules), with no group at all.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))
MESH_LABELS = {False: "16x16", True: "2x16x16"}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or a group."""
    axis_names: tuple
    shape: tuple


def mesh_groups(mesh) -> list:
    """Per dimension of ``mesh`` (a ``DeviceMesh`` or a `MeshShape`), the
    axes it stands for and its size: one axis each, but on the multi-pod
    mesh (`make_production_mesh`), whose first dimension is the pod and
    data axes together."""
    groups = getattr(mesh, "_axis_groups", None)
    if groups is not None:
        return list(zip(groups, mesh.shape))
    names = (mesh.mesh_dim_names if isinstance(mesh, DeviceMesh)
             else mesh.axis_names)
    return [((name,), size) for name, size in zip(names, mesh.shape)]


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a `MeshShape`."""
    sizes = getattr(mesh, "_axis_sizes", None)
    if sizes is not None:
        return dict(sizes)
    return {group[0]: size for group, size in mesh_groups(mesh)}


def axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def production_shape(multi_pod: bool = False) -> MeshShape:
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return MeshShape(axes, shape)


def _is_fake_group() -> bool:
    return dist.get_backend() == "fake"


def fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0: a fake group of another size is replaced, a real
    group raises (its meshes are the caller's)."""
    if dist.is_initialized():
        if not _is_fake_group():
            raise RuntimeError(
                f"a {dist.get_backend()} process group is up; counting "
                f"needs a fake group of {world_size} ranks")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    # the fake backend registers itself when this module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


class _MetaDevices:
    """The device module DTensor's cost model asks of a mesh's device type
    (``device_count``, for the devices a host holds): a meta mesh counts
    as one device a host, as a one-card host's CUDA mesh does."""

    @staticmethod
    def device_count() -> int:
        return 1


def _register_meta() -> None:
    if not hasattr(torch, "meta"):
        torch._register_device_module("meta", _MetaDevices)


def make_mesh(shape, axes, device_type: str = "cpu") -> DeviceMesh:
    """A 2-D ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group: the group that is up, which must have as many ranks, or else a
    fake group of that many (`fake_group`).  ``device_type`` "meta" makes a
    mesh whose DTensors hold meta shards (for counting: DTensor then
    lowers as on the card, where a CPU mesh would gather in place of an
    all-to-all)."""
    if len(shape) != 2:
        raise ValueError(f"a mesh here has two dimensions, not {shape}")
    if device_type == "meta":
        _register_meta()
    n = math.prod(shape)
    if not dist.is_initialized() or _is_fake_group():
        fake_group(n)
    elif dist.get_world_size() != n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
    # both axes flattened too: DTensor then reduces a partial sum over the
    # two with one collective over all the devices, as XLA does, where it
    # would otherwise issue one after the other, each of the whole tensor
    mesh[tuple(axes)]._flatten()
    return mesh


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """Single pod: (16, 16) = ("data", "model"), 256 devices.  Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512 devices, as a (32, 16)
    mesh of the same devices in the same order whose first dimension
    stands for ("pod", "data") together (`mesh_groups`; the axis names
    and sizes stay the three).  Every rule of the reference puts the pod
    and data axes on one tensor dimension together, so the placements are
    the same; DTensor plans a redistribute over two mesh dimensions,
    where over three it searches a graph (the multi-pod xLSTM count: ~1
    min a length against more than 15 on the CPU)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    if not multi_pod:
        return make_mesh(shape, axes, device_type)
    mesh = make_mesh((shape[0] * shape[1], shape[2]), ("pod_data", "model"),
                     device_type)
    mesh._axis_groups = (("pod", "data"), ("model",))
    mesh._axis_sizes = dict(zip(axes, shape))
    return mesh


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the global batch."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str = "cpu") -> DeviceMesh:
    """A small ("data", "model") mesh over the group that is up (gloo in
    the CPU tests, NCCL on four cards) for the sharding tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)
