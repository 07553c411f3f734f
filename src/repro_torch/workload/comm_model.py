"""Communication/compute models of DNN training jobs.

A job is, on the wire, a periodic phase program: per training iteration,
one or more (compute_s, comm_bytes) sub-phases.  Data-parallel jobs are
on/off (one gradient all-reduce per iteration); hybrid DP/PP/TP jobs have
multiple peaks.  PAPER_MODELS are the models of the paper's Table 1, as the
reference defines them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim.engine import JobSpec

GBPS = 1e9 / 8.0


@dataclasses.dataclass(frozen=True)
class CommProfile:
    """One job's per-iteration traffic description."""

    name: str
    compute_s: tuple[float, ...]      # per sub-phase compute durations
    comm_bytes: tuple[float, ...]     # per sub-phase network bytes (per NIC)
    parallelism: str = "data"

    @property
    def total_bytes(self) -> float:
        return float(sum(self.comm_bytes))

    @property
    def total_compute(self) -> float:
        return float(sum(self.compute_s))

    def iso_iter_time(self, link_bytes_per_s: float = 50 * GBPS) -> float:
        """Isolation iteration time: compute + exposed comm at line rate."""
        return self.total_compute + self.total_bytes / link_bytes_per_s

    def scaled(self, factor: float) -> "CommProfile":
        """Uniformly scale the whole program (sweep workloads)."""
        return dataclasses.replace(
            self,
            compute_s=tuple(c * factor for c in self.compute_s),
            comm_bytes=tuple(b * factor for b in self.comm_bytes),
        )

    def compute_scaled(self, factor: float) -> "CommProfile":
        """Scale only the compute phases (comm bytes fixed)."""
        return dataclasses.replace(
            self, compute_s=tuple(c * factor for c in self.compute_s))


def dp_allreduce_bytes(param_count: float, n_workers: int,
                       bytes_per_param: float = 4.0) -> float:
    """Ring all-reduce bytes each worker sends per iteration:
    2 * (k-1)/k * model_bytes."""
    k = max(n_workers, 2)
    return 2.0 * (k - 1) / k * param_count * bytes_per_param


def _dp(name: str, params_m: float, compute_ms: float,
        n_workers: int = 2) -> CommProfile:
    return CommProfile(
        name=name,
        compute_s=(compute_ms * 1e-3,),
        comm_bytes=(dp_allreduce_bytes(params_m * 1e6, n_workers),),
        parallelism="data",
    )


# Table 1 models: parameter counts from the cited papers; per-iteration
# compute phases as the reference sets them.
PAPER_MODELS: dict[str, CommProfile] = {
    "vgg16": _dp("vgg16", 138.0, 220.0),
    "wideresnet101": _dp("wideresnet101", 126.9, 180.0),
    "roberta": _dp("roberta", 355.0, 260.0),
    "camembert": _dp("camembert", 110.0, 90.0),
    "gpt1": _dp("gpt1", 117.0, 100.0),
    # GPT-2 (124M): the convergence benchmarks' workhorse
    "gpt2": _dp("gpt2", 124.0, 100.0),
    # GPT-3 hybrid DP/PP/MP slice: three activation bursts between compute
    # chunks, then the gradient all-reduce
    "gpt3_hybrid": CommProfile(
        name="gpt3_hybrid",
        compute_s=(40e-3, 25e-3, 25e-3, 20e-3),
        comm_bytes=(30e6, 30e6, 30e6, 420e6),
        parallelism="hybrid",
    ),
}


def profile_for(name: str) -> CommProfile:
    try:
        return PAPER_MODELS[name]
    except KeyError as e:
        raise ValueError(f"unknown paper model {name!r}; "
                         f"choose from {sorted(PAPER_MODELS)}") from e


def jobspec_from_profiles(profiles: list[CommProfile],
                          start_offset=None, straggle_prob=None,
                          link_bytes_per_s: float = 50 * GBPS) -> JobSpec:
    """Pack heterogeneous phase programs into the engine's JobSpec arrays."""
    j = len(profiles)
    p = max(len(pr.compute_s) for pr in profiles)
    compute = np.zeros((j, p))
    comm = np.zeros((j, p))
    n_phases = np.zeros((j,), np.int32)
    iso = np.zeros((j,))
    for i, pr in enumerate(profiles):
        k = len(pr.compute_s)
        compute[i, :k] = pr.compute_s
        comm[i, :k] = pr.comm_bytes
        n_phases[i] = k
        iso[i] = pr.iso_iter_time(link_bytes_per_s)
    return JobSpec(
        compute=compute,
        comm_bytes=comm,
        n_phases=n_phases,
        start_offset=(np.zeros((j,)) if start_offset is None
                      else np.asarray(start_offset, np.float64)),
        straggle_prob=(np.zeros((j,)) if straggle_prob is None
                       else np.asarray(straggle_prob, np.float64)),
        iso_iter_time=iso,
    )
