"""Host spans along a plan's path (`repro_torch.netsim.counters`) and the
benchmark's readers of them (`perfbench/harness/program_spans.py`,
`perfbench/layer_metrics/`), in a file that imports neither JAX nor the
JAX reference package.  The plans run on the CPU (a few hundred ticks);
the ``cuda`` test holds the spans against the card's profiler records:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_spans.py
"""
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import core, netsim
from repro_torch.netsim import counters, engine

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import program_spans, registry  # noqa: E402
from harness import trace as trace_mod  # noqa: E402

DT = 2e-5
N_CHUNKS = 4
SIM_TIME = 0.004        # 200 ticks, 4 chunks of 50

# each span's parent (`counters`' tree)
PARENT = {"plan": None, "params": "plan", "group": "plan", "load": "group",
          "setup": "group", "loop": "group", "chunk_inputs": "loop",
          "draws": "chunk_inputs", "run_chunk": "loop", "drain": "group",
          "fetch": "group", "postprocess": "plan"}
READERS = ("draws.us_per_tick", "run_loop.host_us_per_chunk",
           "group_edge.idle_ms_per_group")


def _cfg(pt, sim_time=SIM_TIME, n_chunks=N_CHUNKS):
    return netsim.SimConfig(
        topo=netsim.dumbbell(2, sockets_per_job=2),
        jobs=netsim.JobSpec.simple([0.0025] * 2, [5e6] * 2),
        protocol=core.MLTCPConfig(
            cc=core.CCParams(algo=0, variant=int(core.Variant[pt["variant"]]),
                             tick_dt=DT, rtt=100e-6),
            slope=1.75, intercept=0.25),
        sim_time=sim_time, dt=DT, seed=pt["seed"], n_chunks=n_chunks)


def plan(sim_time=SIM_TIME, n_chunks=N_CHUNKS):
    """Two groups (OFF, WI) of two seeds each."""
    return netsim.Plan(
        name="spans", build=lambda pt: _cfg(pt, sim_time, n_chunks),
        axes=(netsim.Axis("variant", ("OFF", "WI")),
              netsim.Axis("seed", (1, 2))))


@pytest.fixture
def traced():
    """``traced(fn)``: fn() under a CPU profiler session, on a cleared
    log; returns (its result, the spans)."""
    def run(fn):
        counters.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        return out, counters.spans()
    yield run
    counters.clear_spans()


def _plan_run():
    return netsim.run_plan(plan(), device="cpu")


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def test_no_session_records_nothing():
    counters.clear_spans()
    assert counters.recording() is None
    pr = _plan_run()
    assert counters.spans() == [] and counters.spans_dropped() == 0
    # the time split is recorded all the same
    assert all(g.postprocess_s > 0 for g in pr.profile.groups)
    assert pr.profile.summary()["postprocess_s"] == round(
        sum(g.postprocess_s for g in pr.profile.groups), 3)


def test_plan_yields_the_span_tree(traced):
    pr, spans = traced(_plan_run)
    assert pr.n_compile_groups == 2
    per_group = dict(group=1, load=1, setup=1, loop=1, drain=1, fetch=1,
                     params=1, chunk_inputs=N_CHUNKS, draws=N_CHUNKS,
                     run_chunk=N_CHUNKS)
    want = Counter({k: 2 * v for k, v in per_group.items()})
    want.update(plan=1, postprocess=4)
    assert Counter(s.name for s in spans) == want
    tpc = 200 // N_CHUNKS
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        assert parent == PARENT[s.name], s
    counts = {s.name: s.count for s in spans}
    assert counts == dict(plan=4, params=2, group=2, load=0, setup=0,
                          loop=200, chunk_inputs=tpc, draws=tpc,
                          run_chunk=tpc, drain=0, fetch=0, postprocess=1)


def test_children_lie_inside_their_parents_in_one_plan(traced):
    _, first = traced(_plan_run)
    for s in first:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = first[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
    assert len({s.plan for s in first}) == 1 and first[0].plan > 0
    # siblings follow each other: loop after setup, drain after loop, ...
    groups = [i for i, s in enumerate(first) if s.name == "group"]
    for g in groups:
        kids = [s for s in first if s.parent == g]
        assert [s.name for s in kids] == ["load", "setup", "loop", "drain",
                                          "fetch"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    # the next plan takes the next serial
    _, second = traced(_plan_run)
    assert {s.plan for s in second} == {first[0].plan + 1}


def test_postprocess_s_is_the_sum_of_its_spans(traced):
    pr, spans = traced(_plan_run)
    groups = [s for s in spans if s.name == "group"]
    bounds = [g.end_ns for g in groups] + [spans[0].end_ns]
    for prof, start, end in zip(pr.profile.groups, bounds, bounds[1:]):
        mine = [s for s in spans if s.name == "postprocess"
                and start <= s.start_ns < end]
        assert len(mine) == 2
        assert prof.postprocess_s == sum(s.end_ns - s.start_ns
                                         for s in mine) * 1e-9


@pytest.mark.parametrize("cap", [1, 10])
def test_a_full_log_drops_and_counts(traced, monkeypatch, cap):
    monkeypatch.setattr(counters, "_LOG", counters.SpanLog(cap=cap))
    _, spans = traced(_plan_run)
    total = 1 + 2 * (7 + 3 * N_CHUNKS) + 4
    assert len(spans) == cap
    assert counters.spans_dropped() == total - cap
    assert all(s.end_ns >= s.start_ns for s in spans)
    counters.clear_spans()
    assert counters.spans() == [] and counters.spans_dropped() == 0


@pytest.mark.parametrize("per_tick", [False, True])
def test_a_run_outside_a_plan(traced, per_tick):
    """simulate_sweep and run_ticks alone: set-up, loop and the chunk
    spans, outside any plan (serial 0)."""
    cfg = _cfg(dict(variant="WI", seed=3))
    sweep = engine.make_sweep(cfg, device="cpu", seed=[3, 4])
    if per_tick:
        _, spans = traced(lambda: engine.run_ticks(cfg, sweep,
                                                   per_tick=True))
    else:
        _, spans = traced(lambda: engine.simulate_sweep(cfg, sweep, "cpu"))
    assert Counter(s.name for s in spans) == Counter(
        setup=1, loop=1, chunk_inputs=N_CHUNKS, draws=N_CHUNKS,
        run_chunk=N_CHUNKS)
    assert {s.plan for s in spans} == {0}
    assert spans[0].name == "setup" and spans[0].parent == -1


def test_an_exception_closes_the_spans_it_left_open():
    log = counters.SpanLog()
    outer = log.begin("group", 3)
    log.begin("setup")          # never ended: its block raised
    log.end(outer)
    group, setup = (counters.Span(*s) for s in log.items)
    assert setup.end_ns == group.end_ns and setup.parent == outer
    assert log.open == [] and group.count == 3


# ---------------------------------------------------------------------------
# the benchmark's readers, on a synthetic traced window (ns)
# ---------------------------------------------------------------------------

MS = 1_000_000
SPANS = [  # name, start, end, parent, count
    ("plan", 0, 10 * MS, -1, 4),
    ("group", 1 * MS, 9 * MS, 0, 2),
    ("loop", 2 * MS, 8 * MS, 1, 200),
    ("chunk_inputs", 2 * MS, 2.5 * MS, 2, 100),
    ("draws", 2.1 * MS, 2.4 * MS, 3, 100),
    ("run_chunk", 2.5 * MS, 2.6 * MS, 2, 100),
    ("chunk_inputs", 3 * MS, 3.6 * MS, 2, 100),
    ("draws", 3.1 * MS, 3.5 * MS, 6, 100),
    ("run_chunk", 3.6 * MS, 3.8 * MS, 2, 100),
    ("postprocess", 9 * MS, 9.5 * MS, 0, 1),
]
# idle 0-2.6 ms (under group), 2.75-3.05 (in the loop, between chunks),
# 3.6-3.8 (run_chunk), 8.5-10 (postprocess)
EVENTS = [("netsim_chunk_kernel", 2.6 * MS, 2.75 * MS),
          ("netsim_chunk_kernel", 3.05 * MS, 3.6 * MS),
          ("netsim_chunk_kernel", 3.8 * MS, 8.5 * MS)]
WANT = {"draws.us_per_tick": 0.7 * MS / 200 / 1e3,
        "run_loop.host_us_per_chunk": 1.4 * MS / 2 / 1e3,
        "group_edge.idle_ms_per_group": (2.6 + 1.5) * MS / 1 / MS}


def _view():
    return trace_mod.View(plans=[], spans=None,
                          events=[(n, int(a), int(b)) for n, a, b in EVENTS],
                          window=(0, 10 * MS), launches=[], peaks={})


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(counters, "spans", lambda: [
        counters.Span(n, int(a), int(b), p, 1, c) for n, a, b, p, c in SPANS])


def _reader(name):
    return registry.load_module(BENCH / "layer_metrics" / f"{name}.py",
                                "layer_metric_" + name)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_window(synthetic, name):
    assert _reader(name).read(_view()) == pytest.approx(WANT[name],
                                                        rel=1e-12)


def test_idle_by_span_on_a_synthetic_window(synthetic):
    got = program_spans.idle_by_span(_view())
    assert got == pytest.approx({"group": 2.6e-3, "postprocess": 1.5e-3,
                                 "loop": 0.3e-3, "run_chunk": 0.2e-3},
                                rel=1e-12)
    assert list(got) == ["group", "postprocess", "loop", "run_chunk"]


@pytest.mark.parametrize("name", READERS)
def test_reader_without_a_span_log_reads_none(monkeypatch, name):
    monkeypatch.delattr(counters, "spans")
    assert program_spans.spans(_view()) is None
    assert program_spans.idle_by_span(_view()) is None
    assert _reader(name).read(_view()) is None


# ---------------------------------------------------------------------------
# the card: spans and device records on one clock
# ---------------------------------------------------------------------------

# a traced two-group plan through the chunk kernel, in a process of its own
# whose CUPTI state starts fresh (as the benchmark's traced run)
CLOCK_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import test_torch_spans as t
from repro_torch import netsim
from repro_torch.netsim import counters

p = t.plan(sim_time=0.02, n_chunks=10)
netsim.run_plan(p)
counters.clear_spans()
prof = profile(activities=[ProfilerActivity.CUDA])
with prof:
    netsim.run_plan(p)
torch.zeros(1, device="cuda").add_(1.0)
torch.cuda.synchronize()
events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
print(json.dumps({"spans": counters.spans(), "events": events}))
"""


@pytest.mark.cuda
def test_cuda_spans_and_device_records_share_a_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chunk kernel has no CPU mode")
    env = dict(os.environ, TEARDOWN_CUPTI="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", CLOCK_RUN,
                          str(Path(__file__).parent)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    spans = [counters.Span(*s) for s in got["spans"]]
    kernels = sorted((a, b) for n, a, b in got["events"]
                     if "netsim_chunk_kernel" in n)
    chunks = [s for s in spans if s.name == "run_chunk"]
    assert len(chunks) == len(kernels) == 2 * 10
    violations = sum(k[0] < s.start_ns for k, s in zip(kernels, chunks))
    loops = [i for i, s in enumerate(spans) if s.name == "loop"]
    for g, loop in enumerate(loops):
        drain = next(s for s in spans if s.name == "drain"
                     and s.parent == spans[loop].parent)
        violations += kernels[10 * g + 9][1] > drain.end_ns
    assert violations == 0
