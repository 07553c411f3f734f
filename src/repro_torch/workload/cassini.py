"""Cassini baseline [66] — centralized time-shift scheduling.

Cassini (NSDI'24) interleaves jobs by (1) solving for per-job time shifts on
an *affinity graph* (jobs x shared links) so that comm phases dovetail, and
(2) running an end-host agent that re-aligns any job drifting from its
intended schedule (by delaying its next comm phase to the assigned slot).

Faithful properties reproduced here (paper §2.2, §4.5-4.7):
  * works when the affinity graph is a tree and jobs are compatible;
  * requires a loop-free affinity graph (Theorem 1 of [66]) — on the
    circular-dependency triangle (Figure 2) it has no consistent solution,
    so `cassini_schedule` falls back to zero shifts there (and the agent's
    re-alignment then *hurts*, as the paper observes);
  * the agent's skip/delay behavior under stragglers is what degrades its
    tail iteration times for straggle probability > 10%.
"""
from __future__ import annotations

import numpy as np

from repro_torch.netsim.engine import CassiniSchedule
from repro_torch.netsim.topology import Topology
from repro_torch.workload.comm_model import CommProfile, GBPS
from repro_torch.workload.compat import best_offsets


def _affinity_graph(topo: Topology) -> tuple[list[tuple[int, int]], bool]:
    """Edges (job_a, job_b) for each shared link; plus has_cycle flag."""
    share: dict[int, set[int]] = {}
    for n in range(topo.n_flows):
        j = int(topo.flow_to_job[n])
        for l in topo.hops[n]:
            if l >= 0:
                share.setdefault(int(l), set()).add(j)
    edges = set()
    for jobs in share.values():
        jobs = sorted(jobs)
        for i in range(len(jobs)):
            for k in range(i + 1, len(jobs)):
                edges.add((jobs[i], jobs[k]))
    edges = sorted(edges)
    # cycle detection via union-find
    parent = list(range(topo.n_jobs))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    has_cycle = False
    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra == rb:
            has_cycle = True
        else:
            parent[ra] = rb
    return edges, has_cycle


def cassini_schedule(topo: Topology, profiles: list[CommProfile],
                     link_rate: float = 50 * GBPS,
                     eps_frac: float = 0.1,
                     period_slack: float = 1.06) -> tuple[CassiniSchedule, bool]:
    """Compute the centralized schedule. Returns (schedule, feasible).

    ``period_slack`` pads the isolation iteration time the way Cassini's
    "expected optimal iteration time" absorbs protocol overheads (ramp-up,
    queueing): without it, small per-iteration drift forces a full-slot
    re-alignment every cycle. ``eps_frac`` is the agent's tolerance as a
    fraction of the period (straggler sleeps of 5-10% exceed it — the
    paper's >10%-straggle failure mode).

    feasible=False on cyclic affinity graphs (Figure 2): shifts fall back to
    zero and the agent still enforces them — reproducing Cassini's failure
    mode on circular dependencies.
    """
    periods = np.asarray([p.iso_iter_time(link_rate) for p in profiles]) \
        * period_slack
    eps = float(eps_frac * periods.min())
    _, has_cycle = _affinity_graph(topo)
    if has_cycle:
        return CassiniSchedule(offset=np.zeros_like(periods),
                               period=periods, eps=eps), False
    offsets = best_offsets(profiles, link_rate)
    return CassiniSchedule(offset=offsets, period=periods, eps=eps), True
