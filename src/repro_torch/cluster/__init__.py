"""cluster — shared-cluster simulation of the framework's own training jobs.

Bridges the two halves of the system: the trainer side computes each
(architecture x parallelization) job's per-iteration communication profile
(the `total_bytes` MLTCP needs and the compute gaps between bursts), and
the simulator runs those jobs as competing traffic under MLTCP or the
baselines (the port of ``repro/cluster``).
"""

from repro_torch.cluster.profiles import profile_from_arch
from repro_torch.cluster.runner import ClusterReport, simulate_shared_cluster

__all__ = ["ClusterReport", "profile_from_arch", "simulate_shared_cluster"]
