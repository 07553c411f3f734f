"""TCP Reno +/- MLTCP (paper §3.4, Eqs. 4-7).

Additive increase (per ack batch):
    default:  cwnd += num_acks / cwnd                       (Eq. 4)
    MLTCP-WI: cwnd += F(bytes_ratio) * num_acks / cwnd      (Eq. 5)

Multiplicative decrease (per loss event, at most once per RTT):
    default:  cwnd  = 0.5 * cwnd                            (Eq. 6)
    MLTCP-MD: cwnd  = F(bytes_ratio) * 0.5 * cwnd           (Eq. 7)

Slow start is untouched (§3.4).
"""
from __future__ import annotations

import torch

from repro_torch.core.cc.types import CCParams, Feedback, FlowCCState, Variant

Tensor = torch.Tensor


def update(params: CCParams, state: FlowCCState, fb: Feedback,
           f_wi: Tensor, f_md: Tensor) -> FlowCCState:
    """One tick of Reno. ``f_wi``/``f_md`` are F(bytes_ratio) per flow, with
    the non-selected variant already forced to 1.0 by the caller."""
    cwnd = state.cwnd

    # ---- increase path (on acks) ----
    in_ss = cwnd < state.ssthresh
    grow_ss = fb.num_acks                                   # slow start
    grow_ca = f_wi * fb.num_acks / torch.clamp_min(cwnd, 1e-6)  # Eq. 5
    cwnd_inc = cwnd + torch.where(in_ss, grow_ss, grow_ca)

    # ---- decrease path (on loss events, once per RTT via cooldown) ----
    can_cut = state.cooldown <= 0.0
    do_cut = fb.loss & can_cut
    # Eq. 7, with F*beta clipped at 1 (a decrease never increases cwnd).
    cwnd_cut = torch.clamp_min(
        torch.clamp_max(f_md * params.reno_beta, 1.0) * cwnd, params.min_cwnd)

    new_cwnd = torch.where(do_cut, cwnd_cut, cwnd_inc)
    new_ssthresh = torch.where(do_cut, torch.clamp_min(cwnd_cut, 2.0),
                               state.ssthresh)
    new_cooldown = torch.where(
        do_cut, params.rtt,
        torch.clamp_min(state.cooldown - params.tick_dt, 0.0))

    return state._replace(cwnd=new_cwnd, ssthresh=new_ssthresh,
                          cooldown=new_cooldown)


def split_f(params: CCParams, f_vals: Tensor) -> tuple[Tensor, Tensor]:
    """Route F(bytes_ratio) to the WI and/or MD hook per the variant."""
    one = torch.ones_like(f_vals)
    if params.variant == Variant.OFF:
        return one, one
    if params.variant == Variant.WI:
        return f_vals, one
    if params.variant == Variant.MD:
        return one, f_vals
    return f_vals, f_vals  # BOTH
