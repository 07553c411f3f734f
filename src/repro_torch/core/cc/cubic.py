"""TCP CUBIC +/- MLTCP (paper §3.4, Eqs. 8-11).

Window growth:
    default:  cwnd = CUBIC(t)                                (Eq. 8)
    MLTCP-WI: cwnd = CUBIC(F(bytes_ratio) * t)               (Eq. 9)

where t is the time since the last multiplicative-decrease event and
CUBIC(t) = C*(t - K)^3 + w_max with K = cbrt(w_max * (1 - beta) / C).

Multiplicative decrease:
    default:  cwnd = beta * cwnd                             (Eq. 10)
    MLTCP-MD: cwnd = F(bytes_ratio) * beta * cwnd            (Eq. 11)

``cubic_scale`` multiplies C, as the paper scales ``bic_scale``.
"""
from __future__ import annotations

import torch

from repro_torch.core.cc.types import CCParams, Feedback, FlowCCState, col

Tensor = torch.Tensor

# Initial guess for the cube root: a third of the float's bit pattern plus
# this bias lands within a few percent of the root for every normal float.
CBRT_MAGIC = 0x2A51067F
CBRT_NEWTON_STEPS = 4
THIRD = 1.0 / 3.0
# subnormals are scaled up by 2^24 first (exact) and the root back by 2^-8
FLT_MIN = 1.1754943508222875e-38
SUBNORMAL_UP = 16777216.0
SUBNORMAL_DOWN = 0.00390625


def cbrt(x: Tensor) -> Tensor:
    """Cube root of a float32 tensor, from IEEE-rounded ops only.

    torch has no ``cbrt``.  This is the one cube root of the port: a
    bit-pattern guess refined by four Newton steps ``y += (a/y² - y)/3``,
    each a separate correctly-rounded op, so the CUDA kernel
    (`kernels/csrc/mltcp_step.cu`, ``cbrt_ref``) repeats it bit for bit.
    Within 1 ulp of the exact root on every finite float (XLA's
    ``jnp.cbrt`` on the CPU is within 15); 0 and inf return themselves and
    the sign carries through.
    """
    a = torch.abs(x)
    small = a < FLT_MIN
    a = torch.where(small, a * SUBNORMAL_UP, a)
    y = (a.view(torch.int32) // 3 + CBRT_MAGIC).view(torch.float32)
    for _ in range(CBRT_NEWTON_STEPS):
        y = y + (a / (y * y) - y) * THIRD
    y = torch.where(small, y * SUBNORMAL_DOWN, y)
    y = torch.where((a == 0.0) | torch.isinf(a), a, y)
    return torch.copysign(y, x)


def _cubic_target(params: CCParams, w_max: Tensor, t: Tensor) -> Tensor:
    c = params.cubic_c * params.cubic_scale
    # (1-beta)/c folds to one python-float constant, as in the reference
    k = cbrt(w_max * ((1.0 - params.cubic_beta) / c))
    d = t - k
    return c * (d * d * d) + w_max


def update(params: CCParams, state: FlowCCState, fb: Feedback,
           f_wi: Tensor, f_md: Tensor) -> FlowCCState:
    cwnd = state.cwnd
    now = col(fb.now)

    # ---- growth toward the cubic target (on acks) ----
    t = torch.clamp_min(now - state.epoch_start, 0.0)
    target = _cubic_target(params, state.w_max, f_wi * t)       # Eq. 9
    # per-ack growth, vectorized over the tick's ack batch; clipped to at
    # most ~50% growth per tick for stability.
    grow = (fb.num_acks * torch.clamp_min(target - cwnd, 0.0)
            / torch.clamp_min(cwnd, 1e-6))
    in_ss = cwnd < state.ssthresh
    cwnd_inc = cwnd + torch.where(in_ss, fb.num_acks,
                                  torch.minimum(grow, 0.5 * cwnd + 1.0))

    # ---- multiplicative decrease (once per RTT) ----
    can_cut = state.cooldown <= 0.0
    do_cut = fb.loss & can_cut
    # Eq. 11, with F*beta clipped at 1 (a decrease never increases cwnd).
    cwnd_cut = torch.clamp_min(
        torch.clamp_max(f_md * params.cubic_beta, 1.0) * cwnd, params.min_cwnd)

    new_cwnd = torch.where(do_cut, cwnd_cut, cwnd_inc)
    return state._replace(
        cwnd=new_cwnd,
        w_max=torch.where(do_cut, cwnd, state.w_max),
        epoch_start=torch.where(do_cut, now, state.epoch_start),
        ssthresh=torch.where(do_cut, torch.clamp_min(cwnd_cut, 2.0),
                             state.ssthresh),
        cooldown=torch.where(
            do_cut, params.rtt,
            torch.clamp_min(state.cooldown - params.tick_dt, 0.0)),
    )
