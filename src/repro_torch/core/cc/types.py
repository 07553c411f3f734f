"""Shared types for the congestion-control layer.

One per-flow state struct carries the fields of all three algorithms
(Reno / CUBIC / DCQCN); a simulation runs exactly one of them, so unused
fields cost a few floats per flow and keep every update branch-free.
Per-flow tensors are ``[K, N]``: a leading sweep axis of K simulations
over N flows.  Per-point scalars (``Feedback.now``) are ``[K]``.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from repro_torch import device as device_mod

Tensor = torch.Tensor


class Algo(enum.IntEnum):
    RENO = 0
    CUBIC = 1
    DCQCN = 2


class Variant(enum.IntEnum):
    """Where MLTCP's F scales the algorithm (paper §3.3 has two mechanisms)."""

    OFF = 0   # default congestion control (baseline)
    WI = 1    # scale the window/rate increase step        (Eqs. 5, 9, 13)
    MD = 2    # scale the multiplicative decrease step     (Eqs. 7, 11, 15)
    BOTH = 3  # both (paper: either alone suffices; kept for ablations)


class CCParams(NamedTuple):
    """Static parameters (python floats, folded into every op as f32)."""

    algo: int = int(Algo.RENO)
    variant: int = int(Variant.WI)
    mss: float = 1500.0                # bytes per packet (paper: MTU 1500)
    rtt: float = 100e-6                # base round-trip time (s)
    tick_dt: float = 20e-6             # simulator tick (s); used for timers
    min_cwnd: float = 1.0              # packets
    init_cwnd: float = 10.0            # packets
    init_ssthresh: float = 1e9
    # --- CUBIC ---
    cubic_c: float = 0.4               # standard CUBIC C (units: pkts/s^3)
    cubic_beta: float = 0.7            # standard CUBIC multiplicative decrease
    cubic_scale: float = 1e10          # paper §4.1 scales bic_scale by 1e10
    # --- Reno ---
    reno_beta: float = 0.5             # Eq. 6
    # --- DCQCN ---
    line_rate: float = 50e9 / 8        # bytes/s (50 Gbps NICs in the paper)
    rate_ai: float = 5e9 / 8           # R_AI bytes/s per additive-increase step
    rate_min: float = 1e6              # bytes/s floor
    dcqcn_g: float = 1.0 / 16.0        # alpha EWMA gain
    alpha_timer: float = 55e-6         # alpha-decay timer T_alpha (s)
    inc_timer: float = 55e-6           # rate-increase timer (s)
    fast_recovery_stages: int = 5      # stages before additive increase
    cnp_interval: float = 50e-6        # min time between honored CNPs (s)


class FlowCCState(NamedTuple):
    """Per-flow congestion-control state (``[K, N]`` tensors)."""

    cwnd: Tensor           # packets (window-based algos)
    ssthresh: Tensor       # packets
    cooldown: Tensor       # seconds until loss events are honored again
    # CUBIC
    w_max: Tensor          # packets at last decrease
    epoch_start: Tensor    # time of last decrease (s)
    # DCQCN
    rate_cur: Tensor       # bytes/s
    rate_target: Tensor    # bytes/s
    alpha: Tensor
    t_last_cnp: Tensor
    t_last_inc: Tensor
    t_last_alpha: Tensor
    inc_stage: Tensor      # int32


class Feedback(NamedTuple):
    """Per-tick feedback, already delayed by one RTT by the caller."""

    num_acks: Tensor       # [K, N] delivered bytes / MSS during the tick
    loss: Tensor           # [K, N] bool: loss event signal (drop-based algos)
    cnp: Tensor            # [K, N] bool: ECN/CNP congestion signal (DCQCN)
    now: Tensor            # [K] time (s)


def col(x):
    """A ``[K]`` per-point tensor as a ``[K, 1]`` column that broadcasts
    over flows; python floats pass through unchanged."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def init_flow_state(n: int, params: CCParams, k: int = 1,
                    device=None) -> FlowCCState:
    dev = device_mod.resolve(device)

    def full(v):
        return torch.full((k, n), v, dtype=torch.float32, device=dev)

    return FlowCCState(
        cwnd=full(params.init_cwnd),
        ssthresh=full(params.init_ssthresh),
        cooldown=full(0.0),
        w_max=full(params.init_cwnd),
        epoch_start=full(0.0),
        rate_cur=full(params.line_rate),
        rate_target=full(params.line_rate),
        alpha=full(1.0),
        t_last_cnp=full(0.0),
        t_last_inc=full(0.0),
        t_last_alpha=full(0.0),
        inc_stage=torch.zeros((k, n), dtype=torch.int32, device=dev),
    )


def send_rate(params: CCParams, state: FlowCCState) -> Tensor:
    """Instantaneous send rate in bytes/s implied by the CC state."""
    if params.algo == Algo.DCQCN:
        return state.rate_cur
    # mss/rtt folds to one python-float constant, as in the reference
    return state.cwnd * (params.mss / params.rtt)
