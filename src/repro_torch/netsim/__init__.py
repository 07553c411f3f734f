"""netsim — discrete-time fluid network simulator, in PyTorch.

Links with FIFO queues and RED/ECN, per-flow multi-hop routing,
RTT-delayed feedback and periodic DNN-job traffic, stepped tick by tick
with the fused CC-tick kernel.  Sweeps batch K simulations over a leading
tensor axis (`simulate_sweep`).
"""

from repro_torch.netsim.topology import Topology, dumbbell, triangle, two_tier
from repro_torch.netsim.engine import (
    CassiniSchedule,
    JobSpec,
    SimConfig,
    SweepParams,
    SweepPoint,
    grid_sweep,
    make_sweep,
    simulate,
    simulate_sweep,
    sweep_len,
    sweep_slice,
)
from repro_torch.netsim.metrics import (
    SimResult,
    interleave_score,
    iteration_times,
    mean_pairwise_interleave,
    postprocess,
    postprocess_sweep,
    speedup_stats,
    sweep_speedup_stats,
)

__all__ = [
    "Topology", "dumbbell", "triangle", "two_tier",
    "CassiniSchedule", "JobSpec", "SimConfig", "SweepParams", "SweepPoint",
    "grid_sweep", "make_sweep", "simulate", "simulate_sweep", "sweep_len",
    "sweep_slice",
    "SimResult", "interleave_score", "iteration_times",
    "mean_pairwise_interleave", "postprocess", "postprocess_sweep",
    "speedup_stats", "sweep_speedup_stats",
]
