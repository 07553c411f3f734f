"""Table 2 snapshots — job combinations competing for bandwidth (§4.4).

Each snapshot places two jobs on the hierarchical (two-tier) topology of
Figure 6(b); the paper generated them from Cassini's snapshot trace with
varying models, parallelization strategies, worker counts, and resulting
compatibility scores.
"""
from __future__ import annotations

import dataclasses

from repro_torch.netsim.topology import Topology, two_tier
from repro_torch.workload.comm_model import CommProfile, profile_for


@dataclasses.dataclass(frozen=True)
class Snapshot:
    name: str
    profiles: tuple[CommProfile, ...]
    topo: Topology
    compat_paper: float   # the compatibility score Table 2 reports


def table2_snapshots(sockets_per_job: int = 2) -> list[Snapshot]:
    def topo2():
        # two jobs crossing leaf0 -> leaf1 and leaf2 -> leaf1: they share
        # the down-link of leaf 1 (the contended 50 Gbps hop).
        return two_tier([(0, 1), (2, 1)], n_leaves=4,
                        sockets_per_job=sockets_per_job)

    return [
        Snapshot("wrn101_vs_vgg16",
                 (profile_for("wideresnet101"), profile_for("vgg16")),
                 topo2(), 0.88),
        Snapshot("camembert_vs_roberta",
                 (profile_for("camembert"), profile_for("roberta")),
                 topo2(), 0.9),
        Snapshot("gpt1_vs_gpt1",
                 (profile_for("gpt1"), profile_for("gpt1")),
                 topo2(), 1.0),
        Snapshot("gpt2_vs_gpt3hybrid",
                 (profile_for("gpt2"), profile_for("gpt3_hybrid")),
                 topo2(), 1.0),
    ]
