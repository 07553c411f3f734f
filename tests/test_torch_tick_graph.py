"""The graphed per-tick path (`repro_torch.netsim.tick_graph`) on the CPU.

The card captures one chunk of the per-tick path as a CUDA graph and
replays it on static buffers; here the same runner runs that chunk body
eagerly on the same buffers (``capture=False``), chunk after chunk, and
must equal `engine.run_ticks(per_tick=True)` bit for bit on every leaf of
`RawSimOutput`: the state carries across chunks through the static
buffers and the warm-up (one eager tick on a clone) never advances it.
On the ``meta`` device, under a `TorchDispatchMode`, one chunk body must
copy nothing from the host and read nothing back, which is what a capture
needs.  The counting of a replay and the eager route of the callable
configurations are checked with a stand-in for the CUDA graph.  The card's
own checks (graphed against eager) are ``test_torch_cuda.py``'s.
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import core, netsim
from repro_torch.analysis import dispatch_lint
from repro_torch.analysis import plans as suites
from repro_torch.figures import churn, common, kernel_sweep
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import ops
from repro_torch.netsim import counters, engine, telemetry, tick_graph

DT = 2e-5
RED_ECN = dict(red_qmin=50e3, red_qmax=400e3, red_pmax=0.2)
SEEDS = [3, 5]


def _cfg(algo=0, variant=1, n_jobs=2, spj=2, sim_time=0.012, proto_kw=None,
         topo=None, **kw):
    return netsim.SimConfig(
        topo=topo or netsim.dumbbell(n_jobs, sockets_per_job=spj),
        jobs=netsim.JobSpec.simple([0.0025] * n_jobs, [5e6] * n_jobs),
        protocol=core.MLTCPConfig(
            cc=core.CCParams(algo=algo, variant=variant, tick_dt=DT,
                             rtt=100e-6), **(proto_kw or {})),
        sim_time=sim_time, dt=DT, seed=3, n_chunks=8, **kw)


def _churn_case():
    cfg = _cfg(n_jobs=churn.N_JOBS, topo=netsim.dumbbell(
        churn.N_JOBS, sockets_per_job=2, cap_gbps=churn.CAP_GBPS),
        telemetry=churn.telemetry_spec(), faults=churn.SPEC)
    scheds = [netsim.fault_schedule(cfg, churn._events(cfg, label),
                                    spec=churn.SPEC)
              for label in churn.SCHEDULES]
    return cfg, {f: np.stack([s.values[f] for s in scheds])
                 for f in scheds[0].values}


# name -> (config, sweep overrides): Reno WI, DCQCN WI with ECN, Static
# factors beside the adaptive sentinel, the fig 5 telemetry spec armed
# (overlap detector included), the churn gauntlet's faults and detectors
# armed, and a favoritism the CC kernel does not take (core.cc_tick)
CASES = {
    "reno_wi": lambda: (_cfg(), {}),
    "dcqcn_wi_ecn": lambda: (_cfg(algo=2, spj=1, **RED_ECN), {}),
    "reno_wi_static_factors": lambda: (
        _cfg(n_jobs=3), dict(static_job_factors=[[1.3, -1.0, 0.7],
                                                 [-1.0, 0.6, -1.0]])),
    "cubic_wi_fig5_armed": lambda: (
        _cfg(algo=1, telemetry=suites.fig5_spec(0.012)), {}),
    "reno_wi_churn_armed": _churn_case,
    "reno_wi_earliest_iter_start": lambda: (
        _cfg(proto_kw=dict(favoritism="earliest_iter_start")), {}),
}


def _setup(case, device="cpu"):
    cfg, overrides = CASES[case]()
    sweep = netsim.make_sweep(cfg, device=device, seed=SEEDS, **overrides)
    statics = engine._build_statics(cfg, sweep.slope.device)
    st = engine._init_state(cfg, statics, sweep)
    wl = engine._workload_view(cfg, statics, sweep)
    return cfg, sweep, statics, st, wl


def _run(graph, cfg, sweep, statics) -> engine.RawSimOutput:
    """`engine.run_ticks`' per-tick loop through ``graph``."""
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    traces = [graph.step(engine.chunk_inputs(cfg, statics, sweep, graph, tpc))
              for _ in range(cfg.n_ticks // tpc)]
    st = graph.state()
    stacked = [torch.stack(c, dim=1) for c in zip(*traces)]
    return engine.RawSimOutput(
        iter_times=st.iter_times, iter_counts=st.iter_idx,
        **dict(zip(engine.CHUNK_FIELDS, stacked)), final_state=st,
        telemetry=st.telemetry)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        names, values = list(tree), list(tree.values())
    else:
        names, values = tree._fields, list(tree)
    return [x for n, v in zip(names, values)
            for x in _named_leaves(v, f"{prefix}.{n}")]


def _same(x, y) -> bool:
    """Bitwise equality of two tensors (NaNs included)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def _assert_bitwise(got, want):
    a, b = _named_leaves(got), _named_leaves(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), name
        else:
            assert _same(x, y), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_buffer_runner_equals_eager_loop_bitwise(case):
    cfg, sweep, statics, st, wl = _setup(case)
    want = engine.run_ticks(cfg, sweep, per_tick=True)
    initial = [x.clone() for x in tick_graph._leaves(st)]
    graph = tick_graph.TickGraph(cfg, statics, sweep, wl, st)
    assert not graph.capture
    got = _run(graph, cfg, sweep, statics)
    _assert_bitwise(got, want)
    assert cfg.n_ticks // max(1, cfg.n_ticks // cfg.n_chunks) > 2
    assert int(want.iter_counts.sum()) > 0
    # the runner's buffers are its own: the state it started from is as
    # it was, and the chunks' results live in the static buffers
    for x, y in zip(initial, tick_graph._leaves(st)):
        assert _same(x, y)
    for x, y in zip(tick_graph._leaves(graph._state),
                    tick_graph._leaves(got.final_state)):
        assert x is y


def test_warm_up_never_advances_the_runs_state():
    cfg, sweep, statics, st, wl = _setup("reno_wi")
    graph = tick_graph.TickGraph(cfg, statics, sweep, wl, st)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    inputs = engine.chunk_inputs(cfg, statics, sweep, graph, tpc)
    graph._inputs = tick_graph._clone(inputs._replace(key=None))
    before = [x.clone() for x in tick_graph._leaves(graph._state)]
    graph._warm_up()
    for x, y in zip(before, tick_graph._leaves(graph._state)):
        assert _same(x, y)


class _HostCopies(TorchDispatchMode):
    """Records every op that reads a CPU tensor or a value back to the host
    (on meta tensors nothing should be on the CPU)."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        if func is torch.ops.aten._local_scalar_dense.default or any(
                isinstance(x, torch.Tensor) and x.device.type == "cpu"
                for x in leaves):
            self.found.append(str(func))
        return func(*args, **kwargs)


@contextlib.contextmanager
def _host_factories(found: list):
    """`torch.tensor` (always) and `torch.as_tensor` / `torch.from_numpy`
    of host data build a tensor from the host, which a dispatch mode does
    not see: record those calls too."""
    tensor, as_tensor, from_numpy = (torch.tensor, torch.as_tensor,
                                     torch.from_numpy)

    def rec_tensor(*a, **k):
        found.append("torch.tensor")
        return tensor(*a, **k)

    def rec_as_tensor(data, *a, **k):
        if not isinstance(data, torch.Tensor) or data.device.type == "cpu":
            found.append("torch.as_tensor")
        return as_tensor(data, *a, **k)

    def rec_from_numpy(*a, **k):
        found.append("torch.from_numpy")
        return from_numpy(*a, **k)
    torch.tensor, torch.as_tensor = rec_tensor, rec_as_tensor
    torch.from_numpy = rec_from_numpy
    try:
        yield
    finally:
        torch.tensor, torch.as_tensor, torch.from_numpy = (tensor, as_tensor,
                                                           from_numpy)


def _meta(tree):
    return engine.tree_map(
        lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x, tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_body_copies_nothing_from_the_host(case):
    """The body the card captures (a chunk's ticks, the probes, the copy
    back into the static state), on meta tensors: no op reads a CPU tensor
    or a value back, no tensor is built from host data, and the CC kernel
    is launched once a tick (its fallback configuration: none)."""
    cfg, sweep, statics, st, wl = _setup(case)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    inputs = engine.chunk_inputs(cfg, statics, sweep, st, tpc)
    meta = torch.device("meta")
    msweep = _meta(sweep)
    mstatics = engine._build_statics(cfg, meta)
    graph = tick_graph.TickGraph(cfg, mstatics, msweep,
                                 engine._workload_view(cfg, mstatics, msweep),
                                 _meta(st), capture=False)
    minputs = _meta(inputs._replace(key=None))
    planned = ms.PLANNED_LAUNCHES
    mode, found = _HostCopies(), []
    with _host_factories(found), mode:
        probes = graph._body(graph._state, minputs)
    assert mode.found == [] and found == []
    assert [p.device.type for p in probes] == ["meta"] * len(probes)
    fallback = ops.fallback_reason(cfg.protocol, sweep.static_job_factors)
    assert ms.PLANNED_LAUNCHES - planned == (0 if fallback else tpc)


def test_host_copy_detection_sees_a_host_tensor():
    """The dispatch check above sees what it looks for."""
    x = torch.zeros(3, device="meta")
    mode, found = _HostCopies(), []
    with _host_factories(found), mode:
        x + torch.as_tensor(np.ones(3), device="meta")
        x / torch.tensor(2.0, device="meta")
    assert mode.found and found == ["torch.as_tensor", "torch.tensor"]


class _StandInGraph:
    """`torch.cuda.CUDAGraph`'s interface, replaying nothing: it counts."""

    def __init__(self, keep_graph=False):
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _stand_in_capture(graph):
    yield


@pytest.mark.parametrize("case", ["reno_wi", "reno_wi_earliest_iter_start"])
def test_replay_adds_the_counts_the_capture_recorded(case, monkeypatch):
    """A capture takes back what the wrappers counted while it recorded
    them; each replay adds it; the warm-up's tick counts as run."""
    cfg, sweep, statics, st, wl = _setup(case)
    plain = ms.mltcp_tick

    def counted_tick(*a, **k):
        ms.LAUNCH_COUNT += 1             # as the kernel's launch counts
        return plain(*a, **k)
    monkeypatch.setattr(ms, "mltcp_tick", counted_tick)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(ms, "LAUNCH_COUNT", 0)
    monkeypatch.setattr(ops, "FALLBACK_COUNT", 0)
    captures, replays = counters.captures(), counters.replays()
    graph = tick_graph.TickGraph(cfg, statics, sweep, wl, st, capture=True)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    chunks = 3
    for _ in range(chunks):
        graph.step(engine.chunk_inputs(cfg, statics, sweep, graph, tpc))
    fallback = ops.fallback_reason(cfg.protocol, None) is not None
    counted = "FALLBACK_COUNT" if fallback else "LAUNCH_COUNT"
    assert graph.recorded == {"LAUNCH_COUNT": 0 if fallback else tpc,
                              "FALLBACK_COUNT": tpc if fallback else 0}
    runs = {"LAUNCH_COUNT": ms.LAUNCH_COUNT,
            "FALLBACK_COUNT": ops.FALLBACK_COUNT}
    assert runs[counted] == tick_graph.WARM_UP_TICKS + chunks * tpc
    assert sum(runs.values()) == runs[counted]
    assert graph._graph.replays == chunks and graph.nodes is None
    assert counters.captures() - captures == 1
    assert counters.replays() - replays == chunks


def test_a_failed_capture_raises_and_names_the_hook(monkeypatch):
    cfg, sweep, statics, st, wl = _setup("reno_wi")

    @contextlib.contextmanager
    def refusing(graph):
        yield

    def refused(*a, **k):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", refusing)
    graph = tick_graph.TickGraph(cfg, statics, sweep, wl, st, capture=True)
    tpc = max(1, cfg.n_ticks // cfg.n_chunks)
    inputs = engine.chunk_inputs(cfg, statics, sweep, graph, tpc)
    graph._inputs = tick_graph._clone(inputs._replace(key=None))
    monkeypatch.setattr(telemetry, "chunk_capture", refused)
    launches = ms.LAUNCH_COUNT
    with pytest.raises(tick_graph.CaptureError, match="_chunk_probes"):
        graph._capture()
    assert ms.LAUNCH_COUNT == launches and graph._graph is None


def _custom_probe_cfg(monkeypatch):
    monkeypatch.setitem(telemetry.PROBES, "twice_cwnd", telemetry.Probe(
        kind="flow", capture=lambda s: 2.0 * s.cwnd))
    return _cfg(telemetry=netsim.TelemetrySpec(probes=("twice_cwnd",),
                                               stride=5))


def test_callable_configurations_keep_the_eager_loop(monkeypatch):
    """A registered probe or a callable F keeps the eager loop on the card,
    counted once a run and warned once per reason; every other per-tick
    configuration is graphed.  With ``on_card`` said true on the CPU, a
    run takes the card's routes (its graph runs the body eagerly)."""
    monkeypatch.setattr(ops, "on_card", lambda t: True)
    monkeypatch.setattr(ops, "_CHUNK_FALLBACK_WARNED", set())
    monkeypatch.setattr(tick_graph, "_EAGER_WARNED", set())
    probe_cfg = _custom_probe_cfg(monkeypatch)
    f_cfg = _cfg(proto_kw=dict(f_spec=lambda x: 1.0 + 0.5 * x))
    graphed_cfg = _cfg(proto_kw=dict(favoritism="earliest_iter_start"))
    assert "register_probe" in tick_graph.eager_reason(probe_cfg)
    assert "callable" in tick_graph.eager_reason(f_cfg)
    assert tick_graph.eager_reason(graphed_cfg) is None
    for cfg, graphed in ((probe_cfg, False), (f_cfg, False),
                         (graphed_cfg, True)):
        sweep = netsim.make_sweep(cfg, device="cpu", seed=SEEDS)
        eager, captures = counters.eager_runs(), counters.captures()
        made = []
        real = tick_graph.TickGraph

        def recording(*a, **k):
            made.append(real(*a, **k))
            return made[-1]
        monkeypatch.setattr(tick_graph, "TickGraph", recording)
        with pytest.warns(UserWarning) as caught:
            got = engine.run_ticks(cfg, sweep)
        monkeypatch.setattr(tick_graph, "TickGraph", real)
        messages = [str(w.message) for w in caught]
        assert len(made) == int(graphed)
        assert counters.eager_runs() - eager == int(not graphed)
        assert counters.captures() == captures   # no capture on the CPU
        assert sum("eagerly" in m for m in messages) == int(not graphed)
        _assert_bitwise(got, engine.run_ticks(cfg, sweep, eager=True))
    # warned once per reason, counted every run
    eager = tick_graph.EAGER_COUNT
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine.run_ticks(probe_cfg, netsim.make_sweep(probe_cfg,
                                                      device="cpu"))
    assert not any("eagerly" in str(w.message) for w in caught)
    assert tick_graph.EAGER_COUNT - eager == 1


def test_runner_is_none_on_the_cpu():
    cfg, sweep, statics, st, wl = _setup("reno_wi")
    eager = tick_graph.EAGER_COUNT
    assert tick_graph.runner(cfg, statics, sweep, wl, st) is None
    assert tick_graph.EAGER_COUNT == eager


def test_dispatch_lint_names_the_per_tick_route(monkeypatch):
    graphed = _cfg(proto_kw=dict(favoritism="earliest_iter_start"))
    findings, facts = dispatch_lint.lint_dispatch(
        graphed, netsim.make_sweep(graphed, device="cpu"), label="g")
    (f,) = [f for f in findings if f.rule == "dispatch/kernel-fallback"]
    assert facts["expectation"] == "per-tick"
    assert facts["per_tick_route"] == "graphed" and facts["eager_reason"] is None
    assert "graphed" in f.message
    probe = _custom_probe_cfg(monkeypatch)
    findings, facts = dispatch_lint.lint_dispatch(
        probe, netsim.make_sweep(probe, device="cpu"), label="p")
    (f,) = [f for f in findings if f.rule == "dispatch/kernel-fallback"]
    assert facts["per_tick_route"] == "eager"
    assert "register_probe" in facts["eager_reason"]
    assert "eager" in f.message
    clean = _cfg()
    _, facts = dispatch_lint.lint_dispatch(
        clean, netsim.make_sweep(clean, device="cpu"), label="c")
    assert facts["expectation"] == "chunk" and facts["per_tick_route"] is None


def test_kernel_sweep_oracle_runs_the_fused_modes_depth():
    """Both modes of kernel_sweep run the same plan at the suite's own
    simulated time, as benchmarks/kernel_sweep.py does."""
    assert not hasattr(kernel_sweep, "ORACLE_SIM_TIME")
    fused, oracle = (kernel_sweep.make_plan(True),
                     kernel_sweep.make_plan(False))
    assert len(fused.points()) == len(oracle.points()) > 1
    for a, b in zip(fused.points(), oracle.points()):
        ca, cb = fused.build(a), oracle.build(b)
        assert ca.sim_time == cb.sim_time == common.SIM_TIME
        assert ca.n_ticks == cb.n_ticks
