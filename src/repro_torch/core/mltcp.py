"""MLTCP — the composable protocol module (paper §3).

Ties together Algorithm 1 (iteration-boundary detection / bytes_ratio), the
job-favoritism policy (§3.2), the aggressiveness function F (§3.3) and one
of the base congestion-control algorithms (§3.4).

`cc_tick` is the one update the engine's protocol step computes, and the
plain path the fused kernel (`repro_torch.kernels`) is held against.

Baselines through the same entry point:
  * ``variant=OFF``            — default Reno/CUBIC/DCQCN.
  * ``static_factors=tensor``  — the Static scheme of [67]: a constant
    per-flow unfairness factor replaces F(bytes_ratio).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.core import aggressiveness, favoritism as favoritism_mod
from repro_torch.core import iteration
from repro_torch.core.cc import cubic, dcqcn, reno
from repro_torch.core.cc.types import (  # re-exported for convenience
    Algo,
    CCParams,
    Feedback,
    FlowCCState,
    Variant,
    col,
    init_flow_state,
    send_rate,
)
from repro_torch.core.segment import JobGroups

Tensor = torch.Tensor

__all__ = [
    "Algo", "Variant", "CCParams", "FlowCCState", "Feedback",
    "MLTCPConfig", "MLTCPState", "DynamicParams", "init_state", "cc_tick",
    "f_values", "init_flow_state", "send_rate", "job_groups",
]


class DynamicParams(NamedTuple):
    """The protocol scalars a sweep varies, as ``[K]`` float32 tensors.

    ``MLTCPConfig`` holds what shapes the computation (algorithm, variant,
    favoritism policy, F family); ``DynamicParams`` carries the values, one
    per sweep point.  Field order is the fused kernel's ``dyn`` row layout.
    """

    slope: Tensor
    intercept: Tensor
    g: Tensor
    gamma: Tensor
    init_comm_gap: Tensor

    @staticmethod
    def from_config(cfg: "MLTCPConfig", k: int = 1,
                    device=None) -> "DynamicParams":
        dev = device_mod.resolve(device)

        def f32(v):
            return torch.full((k,), v, dtype=torch.float32, device=dev)

        return DynamicParams(slope=f32(cfg.slope),
                             intercept=f32(cfg.intercept), g=f32(cfg.g),
                             gamma=f32(cfg.gamma),
                             init_comm_gap=f32(cfg.init_comm_gap))

    def stacked(self) -> Tensor:
        """The [K, 5] row-per-point layout the fused kernel reads."""
        return torch.stack(tuple(self), dim=-1)


@dataclasses.dataclass(frozen=True)
class MLTCPConfig:
    """Static protocol configuration for one simulation/deployment."""

    cc: CCParams = CCParams()
    f_spec: str = "linear"              # "linear" | "F1".."F6" | callable
    slope: float = 1.75                 # S (paper §4.1 defaults for Reno-WI)
    intercept: float = 0.25             # I
    favoritism: str = "largest_data_sent"
    aggregate_by_job: bool = True       # paper §4.1: aggregate sockets per job
    # Algorithm 1 parameters
    init_comm_gap: float = 1e-3         # INIT_COMM_GAP (s)
    g: float = 0.75
    gamma: float = 0.5

    def f(self) -> aggressiveness.AggressivenessFn:
        return aggressiveness.make_fn(self.f_spec, self.slope, self.intercept)


class MLTCPState(NamedTuple):
    cc: FlowCCState
    det: iteration.IterDetectState


def init_state(n_flows: int, cfg: MLTCPConfig,
               dyn: Optional[DynamicParams] = None, k: int = 1,
               device=None) -> MLTCPState:
    """Fresh ``[K, N]`` protocol state; ``dyn`` overrides the config's
    scalars (the iter_gap estimate seeds from INIT_COMM_GAP)."""
    dev = device_mod.resolve(device)
    init_gap = cfg.init_comm_gap if dyn is None else dyn.init_comm_gap
    det_params = iteration.IterDetectParams(
        total_bytes=torch.ones((k, n_flows), device=dev),
        init_comm_gap=init_gap, g=cfg.g, gamma=cfg.gamma, mtu=cfg.cc.mss)
    return MLTCPState(cc=init_flow_state(n_flows, cfg.cc, k=k, device=dev),
                      det=iteration.init_state(n_flows, det_params, k=k,
                                               device=dev))


_CC_UPDATES = {
    int(Algo.RENO): reno.update,
    int(Algo.CUBIC): cubic.update,
    int(Algo.DCQCN): dcqcn.update,
}


def job_groups(flow_to_job, n_jobs: int, like: Tensor) -> Optional[JobGroups]:
    """``flow_to_job`` as a `JobGroups` (built on ``like``'s device when
    given as an index array); None when there is nothing to aggregate."""
    if flow_to_job is None or n_jobs <= 0:
        return None
    if isinstance(flow_to_job, JobGroups):
        return flow_to_job
    return JobGroups.build(flow_to_job, n_jobs, like.device)


def _favoritism_score(cfg: MLTCPConfig, det: iteration.IterDetectState,
                      comm_elapsed: Optional[Tensor],
                      est_finish: Optional[Tensor]) -> Tensor:
    obs = favoritism_mod.FlowObservables(
        bytes_ratio=det.bytes_ratio,
        iter_start_ago=(comm_elapsed if comm_elapsed is not None
                        else torch.zeros_like(det.bytes_ratio)),
        est_finish_in=(est_finish if est_finish is not None
                       else 1.0 - det.bytes_ratio),
    )
    return favoritism_mod.get_policy(cfg.favoritism)(obs)


def f_values(cfg: MLTCPConfig, det: iteration.IterDetectState,
             comm_elapsed: Optional[Tensor], est_finish: Optional[Tensor],
             dyn: DynamicParams,
             static_factors: Optional[Tensor] = None) -> Tensor:
    """Per-flow aggressiveness factors F for the current detection state."""
    if cfg.cc.variant == int(Variant.OFF):
        adaptive = torch.ones_like(det.bytes_ratio)
    else:
        score = _favoritism_score(cfg, det, comm_elapsed, est_finish)
        fn = aggressiveness.make_fn(cfg.f_spec, col(dyn.slope),
                                    col(dyn.intercept))
        adaptive = fn(score)
    if static_factors is not None:
        # Static [67]: a non-negative factor replaces F for that flow; a
        # negative entry is the "adaptive" sentinel — that flow keeps F.
        return torch.where(static_factors >= 0.0, static_factors, adaptive)
    return adaptive


def cc_tick(cfg: MLTCPConfig,
            state: MLTCPState,
            fb: Feedback,
            total_bytes: Tensor,
            flow_to_job=None,
            n_jobs: int = 0,
            static_factors: Optional[Tensor] = None,
            comm_elapsed: Optional[Tensor] = None,
            est_finish: Optional[Tensor] = None,
            dyn: Optional[DynamicParams] = None) -> tuple[MLTCPState, Tensor]:
    """One protocol tick for all flows of all K sweep points.

    Args:
      fb: RTT-delayed feedback (acks / loss / CNP signals) for this tick.
      total_bytes: [K, N] bytes per training iteration (Algorithm 1 input).
      flow_to_job / n_jobs: socket→job map ([N] indices or a `JobGroups`)
        for per-job statistics aggregation.
      static_factors: [K, N] Static [67] factors (negative = keep F).
      dyn: per-point protocol scalars; default: the config's floats.
    Returns:
      (new_state, send_rate_bytes_per_s)
    """
    k = state.cc.cwnd.shape[0]
    if dyn is None:
        dyn = DynamicParams.from_config(cfg, k=k, device=state.cc.cwnd.device)
    det_params = iteration.IterDetectParams(
        total_bytes=total_bytes, init_comm_gap=dyn.init_comm_gap,
        g=dyn.g, gamma=dyn.gamma, mtu=cfg.cc.mss)

    # --- Algorithm 1: update bytes_sent / bytes_ratio / boundary detection ---
    job_bytes = None
    groups = job_groups(flow_to_job, n_jobs, state.cc.cwnd)
    if cfg.aggregate_by_job and groups is not None:
        per_flow_bytes = state.det.bytes_sent + iteration.ack_bytes(
            fb.num_acks, cfg.cc.mss)
        job_bytes = groups.spread(groups.sum(per_flow_bytes))
    det = iteration.update_mltcp_params(state.det, det_params, fb.num_acks,
                                        fb.now, job_bytes_sent=job_bytes)

    # --- favoritism score -> F values (or Static constants) ---
    f_vals = f_values(cfg, det, comm_elapsed, est_finish, dyn,
                      static_factors=static_factors)
    f_wi, f_md = reno.split_f(cfg.cc, f_vals)

    # --- base congestion-control update with MLTCP scaling ---
    cc_state = _CC_UPDATES[int(cfg.cc.algo)](cfg.cc, state.cc, fb, f_wi, f_md)

    return MLTCPState(cc=cc_state, det=det), send_rate(cfg.cc, cc_state)
