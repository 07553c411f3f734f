"""Experiment topologies (paper Figure 6 and Figure 2).

A Topology is a static description: link capacities plus an ordered hop list
per flow.  Flows are created per job: ``sockets_per_job`` parallel flows share
each job's path — statistics are aggregated per job by the protocol layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GBPS = 1e9 / 8.0  # bytes/s


def _arr_key(a):
    if a is None:
        return None
    a = np.asarray(a)
    return (a.shape, a.dtype.str, a.tobytes())


class HashableConfig:
    """Mixin: hash/eq over dataclass fields with numpy-array support, so
    configs can key caches."""

    def _key(self):
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out.append(_arr_key(v) if isinstance(v, np.ndarray) else v)
        return tuple(out)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()


@dataclasses.dataclass(frozen=True, eq=False)
class Topology(HashableConfig):
    """Static routing description.

    cap:   [M] link capacities (bytes/s).
    hops:  [N, H] ordered link ids per flow, padded with -1.
    flow_to_job: [N] job id per flow.
    names: link names for reporting.
    """

    cap: np.ndarray
    hops: np.ndarray
    flow_to_job: np.ndarray
    names: tuple[str, ...]

    @property
    def n_links(self) -> int:
        return int(self.cap.shape[0])

    @property
    def n_flows(self) -> int:
        return int(self.hops.shape[0])

    @property
    def n_jobs(self) -> int:
        return int(self.flow_to_job.max()) + 1 if self.n_flows else 0

    @property
    def max_hops(self) -> int:
        return int(self.hops.shape[1])

    def routing_matrix(self) -> np.ndarray:
        """[M, N] 0/1 incidence (link l carries flow n)."""
        m = np.zeros((self.n_links, self.n_flows), dtype=np.float32)
        for n in range(self.n_flows):
            for l in self.hops[n]:
                if l >= 0:
                    m[l, n] = 1.0
        return m


def _build(cap, names, job_paths, sockets_per_job) -> Topology:
    """job_paths: list (per job) of ordered link-id lists."""
    max_h = max(len(p) for p in job_paths)
    hops, f2j = [], []
    for j, path in enumerate(job_paths):
        for _ in range(sockets_per_job):
            hops.append(list(path) + [-1] * (max_h - len(path)))
            f2j.append(j)
    return Topology(cap=np.asarray(cap, np.float64),
                    hops=np.asarray(hops, np.int32),
                    flow_to_job=np.asarray(f2j, np.int32),
                    names=tuple(names))


def dumbbell(n_jobs: int, sockets_per_job: int = 1,
             cap_gbps: float = 50.0) -> Topology:
    """Figure 6(a): every job's flows share one bottleneck link."""
    return _build([cap_gbps * GBPS], ["bottleneck"],
                  [[0]] * n_jobs, sockets_per_job)


def triangle(sockets_per_job: int = 1, cap_gbps: float = 50.0) -> Topology:
    """Figure 2: circular dependency.

    Job1 -> [l1, l3],  Job2 -> [l2, l1],  Job3 -> [l3, l2]: each job meets
    a different competitor on each of its two links.
    """
    cap = [cap_gbps * GBPS] * 3
    return _build(cap, ["l1", "l2", "l3"],
                  [[0, 2], [1, 0], [2, 1]], sockets_per_job)


def two_tier(job_leaf_pairs: list[tuple[int, int]], n_leaves: int = 4,
             sockets_per_job: int = 1, leaf_up_gbps: float = 50.0,
             core_gbps: float = 200.0) -> Topology:
    """Figure 6(b): two-tier leaf/spine; job j sends leaf a -> leaf b over
    [up_a, core, down_b]."""
    cap = ([leaf_up_gbps * GBPS] * n_leaves + [leaf_up_gbps * GBPS] * n_leaves
           + [core_gbps * GBPS])
    names = ([f"up{l}" for l in range(n_leaves)]
             + [f"down{l}" for l in range(n_leaves)] + ["core"])
    paths = []
    for (a, b) in job_leaf_pairs:
        assert 0 <= a < n_leaves and 0 <= b < n_leaves and a != b
        paths.append([a, 2 * n_leaves, n_leaves + b])
    return _build(cap, names, paths, sockets_per_job)
