"""Carry values across from the reference: sweeps and running state.

The system has no weights; what crosses is the sweep and the state.  These
functions take numpy arrays and plain python values only (for example the
reference's ``SweepParams`` or ``RawSimOutput.final_state`` passed through
``np.asarray``), so a test can start both packages from the same mid-run
state.  Leaves without the leading sweep axis (a reference ``simulate``
output) gain a K=1 axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import iteration
from repro_torch.core import mltcp as core
from repro_torch.core.cc.types import FlowCCState
from repro_torch.netsim import engine

_INT32 = {"inc_stage", "n_boundaries", "phase_idx", "iter_idx", "tick",
          "ring_ptr", "seed"}
_BOOL = {"ring_loss", "ring_cnp", "in_comm", "job_active"}


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"expected a mapping or a NamedTuple, got {type(obj)}")


def _tensor(name: str, a, device) -> torch.Tensor:
    dtype = (torch.int32 if name in _INT32 else
             torch.bool if name in _BOOL else torch.float32)
    return torch.as_tensor(np.array(a), device=device).to(dtype).contiguous()


def sweep_from_numpy(d, device=None) -> engine.SweepParams:
    """A SweepParams from the reference's field names -> numpy values (or
    None), with or without the leading K axis."""
    dev = device_mod.resolve(device)
    d = _fields(d)
    for name, v in d.items():
        if name in engine.FAULT_FIELDS and v is not None:
            raise engine._unknown_field_error(name)
        if name not in engine.SweepParams._fields + engine.FAULT_FIELDS:
            raise engine._unknown_field_error(name)
    batched = np.asarray(d["slope"]).ndim == 1
    out = {}
    for name in engine.SweepParams._fields:
        v = d.get(name)
        if v is None:
            out[name] = None
            continue
        t = _tensor(name, v, dev)
        out[name] = t if batched else t.unsqueeze(0)
    return engine.SweepParams(**out)


def _batch(fields: dict, batched: bool, device) -> dict:
    out = {}
    for name, v in fields.items():
        t = _tensor(name, v, device)
        out[name] = t if batched else t.unsqueeze(0)
    return out


def proto_state_from_numpy(d, device=None) -> core.MLTCPState:
    """An MLTCPState from {"cc": {...}, "det": {...}} (or the reference's
    NamedTuples of numpy arrays); per-flow leaves [K, N] or [N]."""
    dev = device_mod.resolve(device)
    d = _fields(d)
    cc, det = _fields(d["cc"]), _fields(d["det"])
    batched = np.asarray(cc["cwnd"]).ndim == 2
    return core.MLTCPState(
        cc=FlowCCState(**_batch(cc, batched, dev)),
        det=iteration.IterDetectState(**_batch(det, batched, dev)))


def engine_state_from_numpy(d, device=None) -> engine.EngineState:
    """An EngineState from the reference's state fields (``final_state``
    through ``np.asarray``): the threefry key as uint32 pairs, the ring
    buffers and pointer, every accumulator.  Fault and telemetry state
    must be absent or None."""
    dev = device_mod.resolve(device)
    d = dict(_fields(d))
    if d.pop("telemetry", None) is not None:
        raise engine._not_ported("telemetry state", "item 10")
    batched = np.asarray(d["tick"]).ndim == 1
    key = np.asarray(d.pop("key"), np.uint32)
    proto = proto_state_from_numpy(d.pop("proto"), device=dev)
    rest = _batch(d, batched, dev)
    return engine.EngineState(proto=proto,
                              key=key if batched else key[None], **rest)
