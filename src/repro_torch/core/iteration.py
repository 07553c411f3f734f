"""Algorithm 1 — distributed iteration-boundary detection (paper §3.5).

Each flow tracks, purely from its own ack arrivals:

  bytes_sent        successfully delivered bytes in the current iteration
  bytes_ratio       min(1, bytes_sent / total_bytes)
  prev_ack_tstamp   timestamp of the previous ack
  iter_gap          EWMA estimate of the inter-iteration communication gap
  max_gap           max ack gap observed within the current iteration

On every ack: if the gap since the previous ack exceeds ``g * iter_gap`` the
flow declares a new training iteration, folds ``max_gap`` into the EWMA
estimate ``iter_gap`` (factor γ) and resets its byte counters.

Pure functions over ``[K, N]`` tensors; ``g``/``gamma``/``init_comm_gap``
are python floats or ``[K]`` per-point tensors.  Defaults follow
Algorithm 1: g = 0.75, γ = 0.5, MTU = 1500.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch.core.cc.types import col

Tensor = torch.Tensor


def ack_bytes(num_acks: Tensor, mtu) -> Tensor:
    """``num_acks * mtu`` — the bytes acked this tick — as a materialized
    product.

    The reference wraps this product in an optimization barrier so XLA
    cannot contract it into the following add.  Eager torch runs every op
    as its own kernel and never contracts across ops, so no barrier is
    needed: the product is rounded once, here, on every path (the core
    update, the job aggregation and the fused kernel's ``ack_bytes``
    operand).
    """
    return num_acks * mtu


def byte_ratio(numer: Tensor, total_bytes: Tensor) -> Tensor:
    """Algorithm 1 line 20: ``min(1, bytes_sent / total_bytes)``.

    Written as reciprocal-then-multiply, as in the reference, so that the
    kernel and every plain path round identically.
    """
    return torch.clamp_max(numer * (1.0 / torch.clamp_min(total_bytes, 1.0)),
                           1.0)


class IterDetectParams(NamedTuple):
    """Parameters of Algorithm 1 (per flow, broadcastable)."""

    total_bytes: Tensor         # [K, N] total bytes per training iteration
    init_comm_gap: object       # INIT_COMM_GAP (s): float or [K]
    g: object = 0.75            # noise tolerance for gap detection
    gamma: object = 0.5         # EWMA factor for iter_gap
    mtu: float = 1500.0         # bytes per ack'd packet


class IterDetectState(NamedTuple):
    """Mutable per-flow state of Algorithm 1 (``[K, N]`` tensors)."""

    bytes_sent: Tensor
    bytes_ratio: Tensor
    prev_ack_tstamp: Tensor
    iter_gap: Tensor
    max_gap: Tensor
    n_boundaries: Tensor        # int32: boundaries detected (for metrics)


def init_state(n_flows: int, params: IterDetectParams, k: int = 1,
               device=None) -> IterDetectState:
    dev = device_mod.resolve(device)
    z = torch.zeros((k, n_flows), dtype=torch.float32, device=dev)
    gap = torch.as_tensor(params.init_comm_gap, dtype=torch.float32,
                          device=dev)
    gap = col(gap) if gap.ndim == 1 else gap
    gap = torch.broadcast_to(gap, (k, n_flows)).clone()
    return IterDetectState(
        bytes_sent=z,
        bytes_ratio=z.clone(),
        prev_ack_tstamp=z.clone(),
        iter_gap=gap,
        max_gap=gap.clone(),
        n_boundaries=torch.zeros((k, n_flows), dtype=torch.int32, device=dev),
    )


def boundary_mask(prev_ack_tstamp: Tensor, iter_gap: Tensor, g,
                  num_acks: Tensor, now: Tensor) -> Tensor:
    """Algorithm 1 line 16: does this ack open a new training iteration?

    The single source of truth for the boundary predicate — used by
    ``update_mltcp_params`` and by the fused-kernel wrapper for the
    ``n_boundaries`` counter.  ``now`` is [K]; ``g`` a float or [K].
    """
    has_ack = num_acks > 0
    curr_gap = col(now) - prev_ack_tstamp
    return has_ack & (curr_gap > col(g) * iter_gap)


def update_mltcp_params(state: IterDetectState, params: IterDetectParams,
                        num_acks: Tensor, now: Tensor,
                        job_bytes_sent: Tensor | None = None
                        ) -> IterDetectState:
    """One invocation of UPDATE_MLTCP_PARAMS (Algorithm 1, lines 11-27).

    ``num_acks`` [K, N] is the number of acks received at time ``now`` [K]
    (0 => no ack; the state is left untouched for those flows).
    ``job_bytes_sent``: optional job-aggregated bytes (the paper aggregates
    statistics across all sockets of a job — §4.1); when given it replaces
    the per-flow counter in the bytes_ratio computation.
    """
    has_ack = num_acks > 0
    now_c = col(now)
    gamma = col(params.gamma)

    bytes_sent = state.bytes_sent + ack_bytes(num_acks, params.mtu)  # line 12
    curr_gap = now_c - state.prev_ack_tstamp                         # line 14
    max_gap = torch.maximum(state.max_gap, curr_gap)                 # line 15

    boundary = boundary_mask(state.prev_ack_tstamp, state.iter_gap,
                             params.g, num_acks, now)                # line 16
    # line 19: iter_gap EWMA folds in this iteration's max observed gap
    iter_gap_upd = (1.0 - gamma) * state.iter_gap + gamma * max_gap

    numer = job_bytes_sent if job_bytes_sent is not None else bytes_sent
    ratio_mid = byte_ratio(numer, params.total_bytes)

    init_gap = torch.as_tensor(params.init_comm_gap, dtype=torch.float32,
                               device=max_gap.device)
    init_gap = col(init_gap) if init_gap.ndim == 1 else init_gap
    return IterDetectState(
        # lines 21-22 (reset) vs line 12 (accumulate)
        bytes_sent=torch.where(boundary, 0.0,
                               torch.where(has_ack, bytes_sent,
                                           state.bytes_sent)),
        bytes_ratio=torch.where(boundary, 0.0,
                                torch.where(has_ack, ratio_mid,
                                            state.bytes_ratio)),
        prev_ack_tstamp=torch.where(has_ack, now_c,
                                    state.prev_ack_tstamp),          # line 26
        iter_gap=torch.where(boundary, iter_gap_upd, state.iter_gap),
        max_gap=torch.where(boundary, init_gap,
                            torch.where(has_ack, max_gap, state.max_gap)),
        n_boundaries=state.n_boundaries + boundary.to(torch.int32),
    )


def run_on_trace(ack_times, ack_counts, params: IterDetectParams,
                 device=None) -> IterDetectState:
    """Run Algorithm 1 over a recorded (time, num_acks) trace for one flow.

    Returns the final K=1, N=1 state; the tests use it to check boundary
    detection on synthetic traffic with known iteration structure.
    """
    dev = device_mod.resolve(device)
    times = torch.as_tensor(ack_times, dtype=torch.float32, device=dev)
    counts = torch.as_tensor(ack_counts, dtype=torch.float32, device=dev)
    params = params._replace(total_bytes=torch.as_tensor(
        params.total_bytes, dtype=torch.float32, device=dev).reshape(1, 1))
    st = init_state(1, params, k=1, device=dev)
    for t, n in zip(times.reshape(-1, 1), counts.reshape(-1, 1, 1)):
        st = update_mltcp_params(st, params, n, t)
    return st
