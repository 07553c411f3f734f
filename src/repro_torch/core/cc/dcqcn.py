"""DCQCN +/- MLTCP ("MLQCN", paper §3.4, Eqs. 12-15).

Rate increase (additive-increase stage):
    default:  target_rate += R_AI                            (Eq. 12)
    MLQCN-WI: target_rate += F(bytes_ratio) * R_AI           (Eq. 13)

Rate decrease (on CNP):
    default:  curr_rate = (1 - alpha/2) * curr_rate          (Eq. 14)
    MLQCN-MD: curr_rate = F(bytes_ratio)*(1 - alpha/2)*curr_rate  (Eq. 15)

alpha follows the DCQCN EWMA; recovery is the staged scheme of the
reference (`fast_recovery_stages` bisection stages, then additive
increase); rates clip to [rate_min, line_rate].  ``inc_stage`` is int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.cc.types import CCParams, Feedback, FlowCCState, col

Tensor = torch.Tensor


def update(params: CCParams, state: FlowCCState, fb: Feedback,
           f_wi: Tensor, f_md: Tensor) -> FlowCCState:
    now = col(fb.now)
    # NICs honor at most one CNP per cnp_interval per flow (rate limiter).
    cnp = fb.cnp & ((now - state.t_last_cnp) >= params.cnp_interval)

    # ---------- multiplicative decrease on CNP (Eq. 15) ----------
    alpha_on_cnp = (1.0 - params.dcqcn_g) * state.alpha + params.dcqcn_g
    # a decrease step must not increase the rate: clip F*(1-a/2) at 1.
    md_mult = torch.clamp_max(f_md * (1.0 - state.alpha / 2.0), 1.0)
    rate_cut = torch.clamp(md_mult * state.rate_cur,
                           params.rate_min, params.line_rate)

    # ---------- alpha decay when quiet ----------
    alpha_timer_fired = (now - state.t_last_alpha) >= params.alpha_timer
    alpha_decayed = torch.where(alpha_timer_fired,
                                (1.0 - params.dcqcn_g) * state.alpha,
                                state.alpha)

    # ---------- staged rate increase ----------
    inc_timer_fired = (now - state.t_last_inc) >= params.inc_timer
    stage = state.inc_stage + inc_timer_fired.to(torch.int32)
    in_ai = stage > params.fast_recovery_stages
    # Eq. 13: additive increase on target rate, scaled by F in the AI stage.
    tgt_inc = torch.where(inc_timer_fired & in_ai,
                          state.rate_target + f_wi * params.rate_ai,
                          state.rate_target)
    tgt_inc = torch.clamp_max(tgt_inc, params.line_rate)
    # the bisection step toward target is scaled by F too (DESIGN.md §2 of
    # the reference); F=1 recovers the default algorithm exactly.
    step = torch.clamp_max(f_wi, 2.0) * 0.5 * (tgt_inc - state.rate_cur)
    rate_inc = torch.where(inc_timer_fired, state.rate_cur + step,
                           state.rate_cur)

    # ---------- merge: CNP path wins ----------
    new_rate = torch.where(cnp, rate_cut, rate_inc)
    new_target = torch.where(cnp, state.rate_cur, tgt_inc)
    new_alpha = torch.where(cnp, alpha_on_cnp, alpha_decayed)
    new_stage = torch.where(cnp, torch.zeros_like(stage), stage)
    new_t_inc = torch.where(cnp | inc_timer_fired, now, state.t_last_inc)
    new_t_alpha = torch.where(cnp | alpha_timer_fired, now, state.t_last_alpha)

    return state._replace(
        rate_cur=torch.clamp(new_rate, params.rate_min, params.line_rate),
        rate_target=torch.clamp(new_target, params.rate_min, params.line_rate),
        alpha=torch.clamp(new_alpha, 0.0, 1.0),
        inc_stage=new_stage,
        t_last_cnp=torch.where(cnp, now, state.t_last_cnp),
        t_last_inc=new_t_inc,
        t_last_alpha=new_t_alpha,
    )
