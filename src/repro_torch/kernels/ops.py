"""The fused CC-tick kernel as a drop-in for `repro_torch.core.cc_tick`.

`mltcp_cc_tick` computes the job-aggregated numerator and the
``n_boundaries`` counter outside the kernel, as the reference wrapper does,
and hands the protocol scalars (``dyn``) and the Static-baseline factors
to the kernel as operands.  Only the structural options the kernel does
not implement (a favoritism policy other than ``largest_data_sent``, an F
family other than ``linear``, both only without Static factors) run
`core.cc_tick` instead — loudly, via ``FALLBACK_COUNT`` and one warning per
reason.  Every other case launches the kernel on CUDA tensors and uses its
plain version on CPU tensors (`mltcp_step.mltcp_tick`); nothing catches a
build or launch failure.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core import iteration
from repro_torch.core import mltcp as core
from repro_torch.kernels import mltcp_step as ms

Tensor = torch.Tensor

# Incremented once per call routed through core.cc_tick instead of the
# fused kernel; the engine's main path must leave it at 0.
FALLBACK_COUNT = 0
_FALLBACK_WARNED: set = set()


def reset_fallback_warnings() -> None:
    """Re-arm the once-per-reason fallback warning."""
    _FALLBACK_WARNED.clear()


def fallback_reason(cfg: core.MLTCPConfig,
                    static_factors: Optional[Tensor]) -> Optional[str]:
    """Why this config cannot run the kernel (None: it can).  With Static
    factors the favoritism policy and F family are moot, as in the
    reference dispatch."""
    if static_factors is None:
        if cfg.favoritism != "largest_data_sent":
            return f"favoritism={cfg.favoritism!r}"
        if cfg.f_spec != "linear":
            return f"f_spec={cfg.f_spec!r}"
    return None


def mltcp_cc_tick(cfg: core.MLTCPConfig, state: core.MLTCPState,
                  fb: core.Feedback, total_bytes: Tensor,
                  flow_to_job=None, n_jobs: int = 0,
                  static_factors: Optional[Tensor] = None,
                  comm_elapsed: Optional[Tensor] = None,
                  est_finish: Optional[Tensor] = None,
                  dyn: Optional[core.DynamicParams] = None
                  ) -> tuple[core.MLTCPState, Tensor]:
    """`core.cc_tick` backed by the fused kernel (same arguments)."""
    global FALLBACK_COUNT
    reason = fallback_reason(cfg, static_factors)
    if reason is not None:
        FALLBACK_COUNT += 1
        if reason not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(reason)
            warnings.warn(
                f"mltcp_cc_tick: option {reason} is outside the fused "
                f"kernel's specialization; running core.cc_tick instead",
                stacklevel=2)
        return core.cc_tick(cfg, state, fb, total_bytes,
                            flow_to_job=flow_to_job, n_jobs=n_jobs,
                            static_factors=static_factors,
                            comm_elapsed=comm_elapsed,
                            est_finish=est_finish, dyn=dyn)

    d, c = state.det, state.cc
    k, n = c.cwnd.shape
    if dyn is None:
        dyn = core.DynamicParams.from_config(cfg, k=k, device=c.cwnd.device)
    # per-flow operands must be [K, N]: a table leaking through unreduced
    # would otherwise be read as flow state
    for op_name, op in (("total_bytes", total_bytes),
                        ("static_factors", static_factors)):
        if op is not None and tuple(op.shape) != (k, n):
            raise ValueError(
                f"mltcp_cc_tick: operand {op_name!r} has shape "
                f"{tuple(op.shape)}, expected [K, N] = {(k, n)}")

    # job-aggregated numerator (paper §4.1: stats aggregated per job), in
    # the order-fixed per-job fold (core.segment)
    ackb = iteration.ack_bytes(fb.num_acks, cfg.cc.mss)
    groups = core.job_groups(flow_to_job, n_jobs, c.cwnd)
    aggregate = cfg.aggregate_by_job and groups is not None
    arrays = {
        "bytes_sent": d.bytes_sent, "prev_ack_tstamp": d.prev_ack_tstamp,
        "iter_gap": d.iter_gap, "max_gap": d.max_gap,
        "cwnd": c.cwnd, "ssthresh": c.ssthresh, "cooldown": c.cooldown,
        "w_max": c.w_max, "epoch_start": c.epoch_start,
        "rate_cur": c.rate_cur, "rate_target": c.rate_target,
        "alpha": c.alpha, "t_last_cnp": c.t_last_cnp,
        "t_last_inc": c.t_last_inc, "t_last_alpha": c.t_last_alpha,
        "stage": c.inc_stage, "prev_ratio": d.bytes_ratio,
        "num_acks": fb.num_acks, "ack_bytes": ackb,
        "loss": fb.loss, "cnp": fb.cnp, "total_bytes": total_bytes,
    }
    if aggregate:
        arrays["job_numer"] = groups.spread(groups.sum(d.bytes_sent + ackb))
    out = ms.mltcp_tick(ms.static_params(cfg.cc, aggregate), dyn.stacked(),
                        arrays, fb.now, static_factors)

    # boundary counter (metrics only), outside the kernel, through the same
    # predicate helper the plain path uses
    boundary = iteration.boundary_mask(d.prev_ack_tstamp, d.iter_gap, dyn.g,
                                       fb.num_acks, fb.now)
    det = iteration.IterDetectState(
        bytes_sent=out["bytes_sent"], bytes_ratio=out["ratio"],
        prev_ack_tstamp=out["prev_ack_tstamp"], iter_gap=out["iter_gap"],
        max_gap=out["max_gap"],
        n_boundaries=d.n_boundaries + boundary.to(torch.int32))
    ccs = core.FlowCCState(
        cwnd=out["cwnd"], ssthresh=out["ssthresh"], cooldown=out["cooldown"],
        w_max=out["w_max"], epoch_start=out["epoch_start"],
        rate_cur=out["rate_cur"], rate_target=out["rate_target"],
        alpha=out["alpha"], t_last_cnp=out["t_last_cnp"],
        t_last_inc=out["t_last_inc"], t_last_alpha=out["t_last_alpha"],
        inc_stage=out["stage"])
    return core.MLTCPState(cc=ccs, det=det), out["rate"]
