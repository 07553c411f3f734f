"""netsim — discrete-time fluid network simulator, in PyTorch.

Links with FIFO queues and RED/ECN, per-flow multi-hop routing,
RTT-delayed feedback and periodic DNN-job traffic, stepped tick by tick
with the fused CC-tick kernel.  Sweeps batch K simulations over a leading
tensor axis (`simulate_sweep`).  The experiment layer (`Axis`/`Plan`/
`run_plan`) declares whole evaluation matrices over static and dynamic
axes and runs them as one batched sweep per compile group; job-count
grids pad and mask into one group, and `run_plan(..., cache_dir=)` makes
runs resumable.  `TelemetrySpec` arms probes and streaming detectors
(time to interleave, iteration-time sketch); `FaultSpec` and the event
builders (`job_departs`, `link_flap`, `blackhole`, ...) inject faults whose
schedules ride the sweep.
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
    sweep_of,
    sweep_slice,
)
from repro_torch.netsim.experiment import (
    Axis,
    GroupError,
    GroupProfile,
    Plan,
    PlanProfile,
    PlanResult,
    prune_cache,
    restrict_workload,
    run_plan,
)
from repro_torch.netsim.faults import (
    FaultEvent,
    FaultSchedule,
    FaultSpec,
    blackhole,
    identity_schedule,
    job_arrives,
    job_departs,
    link_flap,
    straggle_burst,
)
from repro_torch.netsim.faults import schedule as fault_schedule
from repro_torch.netsim.metrics import (
    SimResult,
    convergence_iteration,
    interleave_score,
    iter_time_quantile,
    iteration_times,
    mean_pairwise_interleave,
    postprocess,
    postprocess_sweep,
    probe_timeline,
    speedup_stats,
    sweep_speedup_stats,
    time_to_interleave,
)
from repro_torch.netsim.telemetry import (
    TelemetryResult,
    TelemetrySpec,
    register_probe,
)

__all__ = [
    "Topology", "dumbbell", "triangle", "two_tier",
    "CassiniSchedule", "JobSpec", "SimConfig", "SweepParams", "SweepPoint",
    "grid_sweep", "make_sweep", "simulate", "simulate_sweep", "sweep_len",
    "sweep_of", "sweep_slice",
    "Axis", "Plan", "PlanResult", "GroupError", "GroupProfile",
    "PlanProfile", "prune_cache", "restrict_workload", "run_plan",
    "FaultSpec", "FaultEvent", "FaultSchedule", "fault_schedule",
    "identity_schedule", "job_arrives", "job_departs", "link_flap",
    "blackhole", "straggle_burst",
    "SimResult", "interleave_score", "iteration_times",
    "mean_pairwise_interleave", "postprocess", "postprocess_sweep",
    "speedup_stats", "sweep_speedup_stats",
    "TelemetrySpec", "TelemetryResult", "register_probe",
    "probe_timeline", "time_to_interleave", "convergence_iteration",
    "iter_time_quantile",
]
