"""Carry weights, gradients, optimizer moments and caches between the
reference's layout and the port's.

The reference keeps parameters as a nested dict whose ``groups`` leaves
carry a leading ``[n_groups]`` axis (stepped by ``lax.scan``), beside
unstacked ``lead`` and ``tail`` blocks; the port keeps one `Block` per
layer.  The encoder-decoder's ``enc`` and ``dec`` leaves carry a leading
layer axis each, where the port keeps the ``ModuleList``s ``enc`` and
``dec``.  Both name the tensors inside a block alike (``norm1``,
``attn/wq``, ``rec/w_x``, ``moe/shared/gate``, ``mlstm/w_if``,
``cross_attn/wk``, ...), so a block's subtree maps onto its module
attribute by attribute.  Everything here works on numpy arrays; the tests
hand the reference's trees over with ``jax.device_get``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from repro_torch.device import resolve
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

_ENCDEC_STACKS = ("enc", "dec")


def _layer_slots(cfg: ModelConfig):
    """(section, key, group) of every layer, in the model's order: section
    "lead"/"tail" with key str(i), or "groups" with key f"b{j}" and the
    group index."""
    lead, pattern, n_groups, tail = transformer._block_plan(cfg)
    slots = [("lead", str(i), None) for i in range(len(lead))]
    slots += [("groups", f"b{j}", g) for g in range(n_groups)
              for j in range(len(pattern))]
    slots += [("tail", str(i), None) for i in range(len(tail))]
    return slots


def _assign(module: nn.Module, tree: dict, prefix: str, done: set) -> None:
    for key, val in tree.items():
        if val is None:
            if getattr(module, key, None) is not None:
                raise ValueError(f"{prefix}{key}: the reference has no "
                                 f"parameter, the port has one")
        elif isinstance(val, dict):
            _assign(getattr(module, key), val, f"{prefix}{key}/", done)
        else:
            param = getattr(module, key)
            arr = np.asarray(val)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{prefix}{key}: shape {arr.shape} vs the "
                                 f"port's {tuple(param.shape)}")
            with torch.no_grad():
                param.copy_(torch.from_numpy(np.array(arr, copy=True)))
            done.add(id(param))


def params_from_reference(cfg: ModelConfig, tree: dict,
                          device=None) -> nn.Module:
    """The port's model (a `transformer.Model`, or an `encdec.EncDec` for
    an encoder-decoder config) holding the reference parameter tree
    ``tree`` (nested dicts of numpy arrays).  Raises if a tensor's shape
    differs or a parameter of the port is left unset."""
    meta = torch.device("meta")
    if cfg.enc_layers > 0:
        model = encdec.EncDec(cfg, device=meta).to_empty(
            device=resolve(device))
        done: set = set()
        _assign(model, {k: v for k, v in tree.items()
                        if k not in _ENCDEC_STACKS}, "", done)
        for name in _ENCDEC_STACKS:
            for i, blk in enumerate(getattr(model, name)):
                _assign(blk, _index_tree(tree[name], i), f"{name}/{i}/",
                        done)
        return _check_all_set(model, done)
    model = transformer.Model(cfg, device=meta)
    model = model.to_empty(device=resolve(device))
    done = set()
    top = {k: v for k, v in tree.items()
           if k not in ("lead", "groups", "tail")}
    _assign(model, top, "", done)
    for blk, (section, key, g) in zip(model.layers, _layer_slots(cfg)):
        sub = tree[section][key]
        if g is not None:
            sub = _index_tree(sub, g)
        _assign(blk, sub, f"{section}/{key}/", done)
    return _check_all_set(model, done)


def _check_all_set(model: nn.Module, done: set) -> nn.Module:
    unset = [name for name, p in model.named_parameters()
             if id(p) not in done]
    if unset:
        raise ValueError(f"parameters not in the reference tree: {unset}")
    return model


def _index_tree(tree, g: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index_tree(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def cache_to_reference_layout(cfg: ModelConfig, cache: dict) -> dict:
    """The port's cache ({layer index: {name: tensor}}) in the reference's
    nested layout, as numpy arrays: ``lead``/``tail`` by str(i), ``groups``
    by f"b{j}" with a leading [n_groups] axis.  An encoder-decoder's cache
    has the reference's layout already (``self``/``cross``, [L, ...])."""
    if cfg.enc_layers > 0:
        return {part: {name: t.detach().cpu().numpy()
                       for name, t in kv.items()}
                for part, kv in cache.items()}
    out: dict = {}
    stacked: dict = {}
    for i, (section, key, g) in enumerate(_layer_slots(cfg)):
        arrays = {name: t.detach().cpu().numpy()
                  for name, t in cache[i].items()}
        if g is None:
            out.setdefault(section, {})[key] = arrays
        else:
            stacked.setdefault(key, []).append(arrays)
    if stacked:
        out["groups"] = {key: {name: np.stack([c[name] for c in per_group])
                               for name in per_group[0]}
                         for key, per_group in stacked.items()}
    return out


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_to_reference(cfg: ModelConfig, named) -> dict:
    """The port's parameters (a model, or any dict from parameter name to
    tensor with the model's names: its gradients, its AdamW moments) in the
    reference's nested layout, as numpy arrays (bfloat16 as float32):
    ``lead``/``tail`` blocks by str(i), ``groups`` by f"b{j}" with a
    leading [n_groups] axis; an encoder-decoder's ``enc``/``dec`` blocks
    with a leading layer axis.  The inverse of `params_from_reference`."""
    if isinstance(named, nn.Module):
        named = dict(named.named_parameters())
    slots = None if cfg.enc_layers > 0 else _layer_slots(cfg)
    out: dict = {}
    stacked: dict = {}      # (path to the stacked leaf) -> {index: array}
    for name, t in named.items():
        t = t.detach()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        parts = name.split(".")
        if slots is None and parts[0] in _ENCDEC_STACKS:
            stacked.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = arr
        elif parts[0] != "layers":
            _put(out, parts, arr)
        else:
            section, key, g = slots[int(parts[1])]
            if g is None:
                _put(out, [section, key] + parts[2:], arr)
            else:
                stacked.setdefault(("groups", key, *parts[2:]), {})[g] = arr
    for path, per_index in stacked.items():
        _put(out, list(path), np.stack([per_index[i]
                                        for i in sorted(per_index)]))
    return out
