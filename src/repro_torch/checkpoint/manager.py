"""Checkpoint manager (the port of ``repro/checkpoint/manager.py``), with
the reference's on-disk contract:

  * **atomic commit**: writes land in ``step_N.tmp``, which is renamed to
    ``step_N`` only after every leaf's ``.npy`` and the manifest are
    written, so a preempted save is never mistaken for a checkpoint;
  * **async**: the leaves are copied to the host at once, and written by a
    background thread; `wait` joins it (before the next save or a restore);
  * **keep-N retention** and latest-step discovery for restarts.

A tree is a tensor, a dict, a tuple or NamedTuple (a `TrainState`, an
``AdamWState``), an ``nn.Module`` (its parameters by name) or None, nested.
Leaves are named by their path (``model.layers.0.attn.wq``,
``opt.m.embed``, ``step``).  bfloat16 leaves, which numpy lacks, are stored
as their int16 bit patterns and named so in the manifest.

On a device mesh a DTensor leaf is stored as its full logical array, as
the reference stores a sharded leaf (`save` gathers it, rank 0 writes,
and every rank meets the others in `wait`), so any mesh can read it
back: `restore` re-shards each leaf onto ``mesh`` by ``placements``, or
onto the mesh and placements of ``like``'s leaf where that is a DTensor,
whatever mesh saved it (the reference's ``restore`` with
``shardings``).  A tree of plain tensors is saved as on one card, by
whichever process calls `save`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten(tree: Any, path: tuple = ()) -> list:
    """(path, leaf) pairs in a fixed order; a Module's leaves are its
    parameters."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, torch.nn.Module):
        return [(path + (name,), p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [leaf for key, sub in tree.items()
                for leaf in _flatten(sub, path + (str(key),))]
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", None) or range(len(tree))
        return [leaf for key, sub in zip(keys, tree)
                for leaf in _flatten(sub, path + (str(key),))]
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__} at "
                    f"{'.'.join(path) or 'the root'}")


def _place(value: torch.Tensor, like: torch.Tensor, device, path: tuple,
           mesh, placements) -> torch.Tensor:
    """A restored leaf (the full array on the host) where ``like``'s leaf
    is: split onto ``mesh`` by ``placements`` (a dict by leaf name or a
    callable of (name, leaf); replicated where it has none), else onto
    the mesh and placements of a DTensor ``like``, else on ``device`` or
    ``like``'s device; in ``like``'s dtype."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    if mesh is None and isinstance(like, DTensor):
        mesh, at = like.device_mesh, like.placements
    elif mesh is not None:
        name = _leaf_name(path)
        at = (placements(name, like) if callable(placements)
              else (placements or {}).get(name))
        at = at or [Replicate()] * mesh.ndim
    if mesh is None:
        return value.to(device or like.device, like.dtype)
    local = like.to_local() if isinstance(like, DTensor) else like
    dev = device or (mesh.device_type if local.device.type == "meta"
                     else local.device)
    return distribute_tensor(value.to(dev, like.dtype), mesh, list(at),
                             src_data_rank=None)


def _unflatten(like: Any, values, device, mesh=None, placements=None,
               path: tuple = ()) -> Any:
    """``like`` rebuilt with the next of ``values`` (an iterator) for each
    leaf (`_place`); a Module's parameters take theirs in place."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return _place(next(values), like, device, path, mesh, placements)
    if isinstance(like, torch.nn.Module):
        for name, p in list(like.named_parameters()):
            value = _place(next(values), p, device, path + (name,), mesh,
                           placements)
            if value.__class__ is torch.Tensor and p.__class__ in (
                    torch.Tensor, torch.nn.Parameter):
                p.data = value
            else:   # a DTensor: a new parameter in the owner module
                owner, _, leaf = name.rpartition(".")
                mod = like.get_submodule(owner) if owner else like
                mod._parameters[leaf] = torch.nn.Parameter(
                    value, requires_grad=p.requires_grad)
        return like
    if isinstance(like, dict):
        return {k: _unflatten(v, values, device, mesh, placements,
                              path + (str(k),)) for k, v in like.items()}
    keys = getattr(like, "_fields", None) or range(len(like))
    out = [_unflatten(v, values, device, mesh, placements, path + (str(k),))
           for k, v in zip(keys, like)]
    return type(like)(*out) if hasattr(like, "_fields") else tuple(out)


def _leaf_name(path: tuple) -> str:
    return _SAFE.sub("_", ".".join(path)) or "leaf"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: training goes on updating the tensors in
    place while the writer thread runs); a DTensor's full array."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._peers = False      # a save of a mesh's tree to meet

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        from torch.distributed.tensor import DTensor

        self.wait()
        flat = _flatten(tree)
        # a tree with DTensor leaves is the mesh's: every rank gathers
        # them, rank 0 writes, and the ranks meet in `wait`; any other tree
        # is this process's own, written by it alone
        shared = dist.is_initialized() and any(
            isinstance(t, DTensor) for _, t in flat)
        leaves = [(_leaf_name(path), str(t.dtype).removeprefix("torch."),
                   _to_host(t)) for path, t in flat]
        if shared and dist.get_rank() != 0:
            self._peers = True
            if blocking:
                self.wait()
            return

        def work():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            seen: dict[str, int] = {}
            for name, dtype, arr in leaves:
                if name in seen:           # disambiguate collisions
                    seen[name] += 1
                    name = f"{name}__{seen[name]}"
                else:
                    seen[name] = 0
                np.save(os.path.join(tmp, name + ".npy"), arr,
                        allow_pickle=False)
                manifest["leaves"].append(
                    {"file": name + ".npy", "shape": list(arr.shape),
                     "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic commit
            self._gc()

        self._peers = shared
        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer thread (and, after a save of a tree with DTensor
        leaves, meet the other ranks: then every rank sees the
        checkpoint)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._peers:
            self._peers = False
            dist.barrier()

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, mesh=None, placements=None) -> Any:
        """Restore into the structure of ``like`` (the latest step unless
        ``step`` is given): each tensor leaf in the dtype of ``like``'s, on
        ``device`` or, for None, on the device of ``like``'s leaf; a Module
        in ``like`` takes the parameters in place and is returned.  With
        ``mesh`` each leaf is re-sharded onto it by ``placements`` (a dict
        by leaf name, ``model.layers.0.attn.wq`` and so on, or a callable
        of (name, like's leaf); a leaf without any is replicated); without
        it, a DTensor leaf of ``like`` gives its own mesh and placements."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = _flatten(like)
        if len(flat_like) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, expected "
                f"{len(flat_like)} — incompatible tree")
        arrays = []
        for rec in manifest["leaves"]:
            t = torch.from_numpy(np.load(os.path.join(d, rec["file"]),
                                         allow_pickle=False))
            if rec["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            arrays.append(t)
        return _unflatten(like, iter(arrays), device, mesh, placements)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
