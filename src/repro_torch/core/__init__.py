"""MLTCP core — the paper's primary contribution, in PyTorch.

The bandwidth-aggressiveness function family (§3.3), the job-favoritism
policies (§3.2), the iteration-boundary detector (Algorithm 1) and the
congestion-control variants (Reno / CUBIC / DCQCN with WI/MD, §3.4).
State tensors are ``[K, N]``: K sweep points by N flows.
"""

from repro_torch.core.aggressiveness import linear, make_fn, paper_functions
from repro_torch.core.iteration import (
    IterDetectParams,
    IterDetectState,
    boundary_mask,
    run_on_trace,
    update_mltcp_params,
)
from repro_torch.core.mltcp import (
    Algo,
    CCParams,
    DynamicParams,
    Feedback,
    FlowCCState,
    MLTCPConfig,
    MLTCPState,
    Variant,
    cc_tick,
    f_values,
    init_flow_state,
    init_state,
    send_rate,
)
from repro_torch.core.segment import JobGroups, fold_sum

__all__ = [
    "linear", "make_fn", "paper_functions",
    "IterDetectParams", "IterDetectState", "boundary_mask", "run_on_trace",
    "update_mltcp_params",
    "Algo", "CCParams", "DynamicParams", "Feedback", "FlowCCState",
    "MLTCPConfig", "MLTCPState", "JobGroups", "fold_sum",
    "Variant", "cc_tick", "f_values", "init_flow_state", "init_state",
    "send_rate",
]
