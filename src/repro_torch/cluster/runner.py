"""Shared-cluster simulation driver: N framework jobs on one data-center
fabric (the port of ``repro/cluster/runner.py``), through the port's
`netsim.run_plan`: on the card each scheme is one run of the chunk
kernel."""
from __future__ import annotations

import dataclasses

from repro_torch import netsim, workload
from repro_torch.cluster.profiles import profile_from_arch
from repro_torch.configs import get_config
from repro_torch.core import Algo, CCParams, MLTCPConfig, Variant
from repro_torch.roofline.hw import H100, HwSpec


@dataclasses.dataclass
class ClusterReport:
    jobs: list[str]
    baseline_avg: list[float]
    mltcp_avg: list[float]
    avg_speedup: float
    p99_speedup: float
    interleave_before: float
    interleave_after: float


def shared_cluster_plan(arch_ids: list[str], *, algo: str = "dcqcn",
                        sim_time: float = 4.0, seed: int = 0,
                        sockets_per_job: int = 2, work_scale: float = 0.05,
                        hw: HwSpec = H100) -> netsim.Plan:
    """The plan `simulate_shared_cluster` runs: the architectures' training
    jobs on one dumbbell, a scheme axis of default against MLTCP (WI)
    congestion control."""
    profiles = [profile_from_arch(get_config(a), hw=hw).scaled(work_scale)
                for a in arch_ids]
    topo = netsim.dumbbell(len(arch_ids), sockets_per_job=sockets_per_job)
    jobs = workload.jobspec_from_profiles(profiles)
    dt = 2e-5
    algo_id = {"reno": Algo.RENO, "cubic": Algo.CUBIC,
               "dcqcn": Algo.DCQCN}[algo]
    slope, intercept = (1.067, 0.267) if algo == "dcqcn" else (1.75, 0.25)
    red = (dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2)
           if algo == "dcqcn" else {})

    def build(pt):
        variant = Variant.WI if pt["scheme"] == "mltcp" else Variant.OFF
        proto = MLTCPConfig(
            cc=CCParams(algo=int(algo_id), variant=int(variant),
                        tick_dt=dt, rtt=100e-6),
            slope=slope, intercept=intercept)
        return netsim.SimConfig(topo=topo, jobs=jobs, protocol=proto,
                                sim_time=sim_time, dt=dt, seed=seed, **red)

    return netsim.Plan(name="shared-cluster",
                       axes=(netsim.Axis("scheme", ("default", "mltcp")),),
                       build=build)


def simulate_shared_cluster(arch_ids: list[str], *, algo: str = "dcqcn",
                            sim_time: float = 4.0, seed: int = 0,
                            sockets_per_job: int = 2,
                            work_scale: float = 0.05, hw: HwSpec = H100,
                            device=None) -> ClusterReport:
    """Run the architectures' training jobs as competing traffic on one
    dumbbell, default against MLTCP (WI) congestion control.  ``work_scale``
    shrinks every phase program uniformly (ratio-preserving); ``hw`` is
    the accelerator the jobs' compute gaps are reckoned on; ``device``
    where the simulator runs (None: the CUDA card)."""
    result = netsim.run_plan(shared_cluster_plan(
        arch_ids, algo=algo, sim_time=sim_time, seed=seed,
        sockets_per_job=sockets_per_job, work_scale=work_scale, hw=hw),
        device=device)
    (base,), (ml,) = (result.select(scheme="default"),
                      result.select(scheme="mltcp"))
    sp = netsim.speedup_stats(base, ml)
    return ClusterReport(
        jobs=arch_ids,
        baseline_avg=[base.avg_iter(j) for j in range(len(arch_ids))],
        mltcp_avg=[ml.avg_iter(j) for j in range(len(arch_ids))],
        avg_speedup=sp["avg_speedup"],
        p99_speedup=sp["p99_speedup"],
        interleave_before=netsim.mean_pairwise_interleave(base),
        interleave_after=netsim.mean_pairwise_interleave(ml),
    )
