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
as their int16 bit patterns and named so in the manifest.  `restore` takes
``device`` where the reference takes shardings: one card has nothing to
re-shard.
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


def _unflatten(like: Any, values: list, device) -> Any:
    """``like`` rebuilt with the next of ``values`` (an iterator) for each
    leaf; a Module's parameters take theirs in place."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(values).to(device or like.device, like.dtype)
    if isinstance(like, torch.nn.Module):
        for p in like.parameters():
            p.data = next(values).to(device or p.device, p.dtype)
        return like
    if isinstance(like, dict):
        return {k: _unflatten(v, values, device) for k, v in like.items()}
    out = [_unflatten(v, values, device) for v in like]
    return type(like)(*out) if hasattr(like, "_fields") else tuple(out)


def _leaf_name(path: tuple) -> str:
    return _SAFE.sub("_", ".".join(path)) or "leaf"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: training goes on updating the tensors in
    place while the writer thread runs)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        leaves = [(_leaf_name(path), str(t.dtype).removeprefix("torch."),
                   _to_host(t)) for path, t in _flatten(tree)]

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

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure of ``like`` (the latest step unless
        ``step`` is given): each tensor leaf in the dtype of ``like``'s, on
        ``device`` or, for None, on the device of ``like``'s leaf; a Module
        in ``like`` takes the parameters in place and is returned."""
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
        return _unflatten(like, iter(arrays), device)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
