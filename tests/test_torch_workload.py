"""The port's baseline workload machinery against the JAX reference's.

`workload.compat` (compatibility scores, joint offsets), `workload.cassini`
(the centralized time-shift schedule, its affinity-graph cycle test) and
`workload.snapshots` (Table 2) are numpy in both packages, fed the same
profiles and topologies: every result must equal the reference's
exactly.
"""
import dataclasses

import numpy as np
import pytest

from _torch_reference import load_reference

from repro_torch import netsim as tnet
from repro_torch import workload as twl

REF = load_reference()
rnet = REF["repro.netsim"]
rwl = REF["repro.workload"]

PAIRS = [("gpt2", "gpt2"), ("wideresnet101", "vgg16"),
         ("camembert", "roberta"), ("gpt2", "gpt3_hybrid"),
         ("gpt1", "vgg16")]


def _profiles(wl, names, scale=1.0):
    return [wl.profile_for(n).scaled(scale) for n in names]


@pytest.mark.parametrize("a,b", PAIRS)
def test_compatibility_score_equals_the_reference(a, b):
    ta, tb = _profiles(twl, (a, b))
    ra, rb = _profiles(rwl, (a, b))
    got = twl.compatibility_score(ta, tb, n_offsets=16)
    assert got == rwl.compatibility_score(ra, rb, n_offsets=16)
    assert 0.0 <= got <= 1.0


@pytest.mark.parametrize("names", [("gpt2", "gpt2"),
                                   ("gpt2", "gpt2", "gpt3_hybrid"),
                                   ("gpt1", "gpt2", "roberta", "vgg16")],
                         ids=["2-jobs", "3-jobs", "4-jobs-greedy"])
def test_best_offsets_equal_the_reference(names):
    got = twl.best_offsets(_profiles(twl, names, 0.25), n_offsets=8)
    want = rwl.best_offsets(_profiles(rwl, names, 0.25), n_offsets=8)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0


def _schedules(topo_of, names):
    out = []
    for net, wl in ((tnet, twl), (rnet, rwl)):
        out.append(wl.cassini_schedule(topo_of(net),
                                       _profiles(wl, names, 0.25)))
    return out


@pytest.mark.parametrize("case", ["dumbbell", "two_tier", "triangle"])
def test_cassini_schedule_equals_the_reference(case):
    topo_of, names, feasible = {
        "dumbbell": (lambda net: net.dumbbell(2, sockets_per_job=2),
                     ("gpt2", "gpt2"), True),
        "two_tier": (lambda net: net.two_tier([(0, 1), (2, 1)],
                                              sockets_per_job=2),
                     ("gpt2", "gpt3_hybrid"), True),
        # the circular dependency (Figure 2): no loop-free solution, so
        # zero shifts
        "triangle": (lambda net: net.triangle(sockets_per_job=2),
                     ("gpt2", "gpt2", "gpt2"), False),
    }[case]
    (got, got_ok), (want, want_ok) = _schedules(topo_of, names)
    assert got_ok == want_ok == feasible
    assert isinstance(got, tnet.CassiniSchedule)
    np.testing.assert_array_equal(got.offset, want.offset)
    np.testing.assert_array_equal(got.period, want.period)
    assert got.eps == want.eps
    if not feasible:
        assert not got.offset.any()


def test_table2_snapshots_equal_the_reference():
    got, want = twl.table2_snapshots(), rwl.table2_snapshots()
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert g.compat_paper == w.compat_paper
        assert [dataclasses.asdict(p) for p in g.profiles] == \
            [dataclasses.asdict(p) for p in w.profiles]
        assert isinstance(g.topo, tnet.Topology)
        for f in dataclasses.fields(g.topo):
            np.testing.assert_array_equal(np.asarray(getattr(g.topo, f.name)),
                                          np.asarray(getattr(w.topo, f.name)))
    assert len(twl.table2_snapshots(sockets_per_job=1)[0].topo.hops) == 2
