"""One accessor over the port's runtime health counters.

The reference reads two process-global counters: sweep-program traces and
CC-tick fallbacks.  The port traces nothing; its counterpart of one trace
per compile group is one run of `engine.run_ticks` per `simulate_sweep`
call (``engine.RUN_COUNT``).  Its fallbacks are of two kinds, both counted
in `repro_torch.kernels.ops`: a CC tick routed through `core.cc_tick`
(``FALLBACK_COUNT``) and a run on the card sent down the per-tick path
(``CHUNK_FALLBACK_COUNT``).  The chunk kernel counts its own launches
(``netsim_chunk.LAUNCH_COUNT``).

    from repro_torch.netsim import counters

    with counters.watch() as w:
        run_plan(plan)
    assert w.traces == 2 and w.fallbacks == 0

``watch()`` snapshots the counters at entry; the handle's ``.traces`` /
``.fallbacks`` / ``.launches`` are live deltas (they keep counting after
the ``with`` block exits).  Reading never imports the kernels package: a
counter of a module that was never imported reads 0.

Spans.  While a `torch.profiler` session is open in the process (the rule
PyTorch's own operator records follow), the path of a plan records host
spans into one log: each `Span` holds its name, its start and end in
`time.time_ns` nanoseconds (the clock the profiler stamps its device
records in), the index of its parent, the serial of the `run_plan` call it
belongs to, and a work count.  The sites, the parent shown by indentation:

    plan            run_plan, one per call                (count: points)
      params        a group's parameters, stacked and placed  (K)
      group         a group's run, experiment._run_group      (K)
        load        the group's kernel library
        setup       simulate_sweep up to the chunk loop: the sweep on the
                    device, its checks, statics, state, the packed run
        loop        run_ticks' chunk loop                     (group-ticks)
          chunk_inputs   engine.chunk_inputs, per chunk       (group-ticks)
            draws        the draw call alone: the library's C loop on
                         the card, netsim.random on the CPU   (group-ticks)
          run_chunk      the chunk: argument packing and launch, the
                         graph's replay, or the per-tick loop (group-ticks)
        drain       the closing synchronize: the host waiting for the card
        fetch       the copy of the outputs to the host
      postprocess   metrics.postprocess, per point            (1)

Between ``loop`` and ``drain`` the run gathers its outputs (the packed
state's views, the per-tick path's stacked traces), under ``group``.
`run_plan`, and `run_ticks` or `simulate_sweep`, each ask `recording`
once; with no session open a chunk's sites cost one ``is None`` test and
no clock read.  The spans are host records only (no `record_function` or
NVTX range), so they add no device record to the trace.  The log holds
at most `SPAN_CAP` spans; `spans_dropped` counts those beyond it.

    from torch.profiler import profile, ProfilerActivity

    with profile(activities=[ProfilerActivity.CUDA]):
        run_plan(plan)
    for s in counters.spans():
        print(s.name, (s.end_ns - s.start_ns) * 1e-3, "us")
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, NamedTuple, Optional

from torch._C import _autograd
from torch.autograd import profiler as _profiler

__all__ = ["traces", "fallbacks", "launches", "captures", "replays",
           "eager_runs", "reset_fallback_warnings", "watch", "CounterWatch",
           "Span", "SpanLog", "SPAN_CAP", "recording", "span", "plan_span",
           "timed", "spans", "clear_spans", "spans_dropped"]


def traces() -> int:
    """Runs of `engine.run_ticks` this process (one per `simulate_sweep`
    call, so one per compile group of a plan): the port's counterpart of
    the reference's sweep-program traces."""
    from repro_torch.netsim import engine

    return engine.RUN_COUNT


def _counter(module: str, name: str) -> int:
    mod = sys.modules.get(module)
    return getattr(mod, name, 0) if mod is not None else 0


def fallbacks() -> int:
    """CC ticks routed through `core.cc_tick` plus runs on the card sent
    down the per-tick path (``ops.FALLBACK_COUNT`` +
    ``ops.CHUNK_FALLBACK_COUNT``)."""
    return (_counter("repro_torch.kernels.ops", "FALLBACK_COUNT")
            + _counter("repro_torch.kernels.ops", "CHUNK_FALLBACK_COUNT"))


def launches() -> int:
    """Launches of the chunk kernel (``netsim_chunk.LAUNCH_COUNT``)."""
    return _counter("repro_torch.kernels.netsim_chunk", "LAUNCH_COUNT")


def captures() -> int:
    """Per-tick chunks captured as a CUDA graph (one per graphed run)."""
    return _counter("repro_torch.netsim.tick_graph", "CAPTURE_COUNT")


def replays() -> int:
    """Replays of the per-tick path's CUDA graphs (one per chunk)."""
    return _counter("repro_torch.netsim.tick_graph", "REPLAY_COUNT")


def eager_runs() -> int:
    """Per-tick runs on the card kept on the eager loop by a Python
    callable in the tick (`tick_graph.eager_reason`)."""
    return _counter("repro_torch.netsim.tick_graph", "EAGER_COUNT")


def reset_fallback_warnings() -> None:
    """Re-arm ops.py's once-per-reason fallback warnings and the per-tick
    path's eager-loop ones (no-op when the modules were never imported).
    `run_plan` calls this per plan so each plan warns at most once per
    fallback reason."""
    mod = sys.modules.get("repro_torch.kernels.ops")
    if mod is not None:
        mod.reset_fallback_warnings()
    mod = sys.modules.get("repro_torch.netsim.tick_graph")
    if mod is not None:
        mod.reset_warnings()


class CounterWatch:
    """Live deltas of the counters since construction."""

    def __init__(self) -> None:
        self._traces0 = traces()
        self._fallbacks0 = fallbacks()
        self._launches0 = launches()

    @property
    def traces(self) -> int:
        return traces() - self._traces0

    @property
    def fallbacks(self) -> int:
        return fallbacks() - self._fallbacks0

    @property
    def launches(self) -> int:
        return launches() - self._launches0


@contextlib.contextmanager
def watch(*, reset_warnings: bool = False):
    """Context manager yielding a `CounterWatch` over the enclosed work.

    ``reset_warnings=True`` additionally re-arms the once-per-reason
    fallback warnings at entry (the per-plan semantics `run_plan` wants).
    """
    if reset_warnings:
        reset_fallback_warnings()
    yield CounterWatch()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

# spans a log holds: a traced window of the benchmark's cells records
# about 2,500 a plan
SPAN_CAP = 1 << 18


class Span(NamedTuple):
    """One closed span of the log."""

    name: str
    start_ns: int          # time.time_ns()
    end_ns: int
    parent: int            # index in `spans()` of the enclosing span; -1
    plan: int              # serial of its run_plan call; 0 outside one
    count: int             # the work it did (group-ticks, points, ...)


class SpanLog:
    """Spans in the order they began, at most ``cap`` of them; an open
    span holds its slot, so a parent's index is known to its children.
    ``items`` holds `Span`'s fields as a plain tuple, without ``end_ns``
    while the span is open; ``open`` the open spans' indexes, innermost
    last."""

    def __init__(self, cap: int = SPAN_CAP) -> None:
        self.cap = cap
        self.items: list[tuple] = []
        self.open: list[int] = []
        self.dropped = 0
        self.plan = 0
        self.plans = 0

    def begin(self, name: str, count: int = 0) -> int:
        """Open a span under the innermost open one; its index, or -1 when
        the log is full (the span is dropped)."""
        if len(self.items) >= self.cap:
            self.dropped += 1
            return -1
        i = len(self.items)
        self.items.append((name, time.time_ns(),
                           self.open[-1] if self.open else -1, self.plan,
                           count))
        self.open.append(i)
        return i

    def end(self, i: int) -> None:
        """Close span ``i``, and at the same time any span inside it that
        an exception left open."""
        t = time.time_ns()
        if i not in self.open:
            return          # dropped, or the log was cleared since
        at = self.open.index(i)
        for j in self.open[at:]:
            name, start, parent, plan, count = self.items[j]
            self.items[j] = (name, start, t, parent, plan, count)
        del self.open[at:]

    def add(self, name: str, start_ns: int, end_ns: int,
            count: int = 0) -> None:
        """A span timed by the caller, under the innermost open one."""
        if len(self.items) >= self.cap:
            self.dropped += 1
            return
        self.items.append((name, start_ns, end_ns,
                           self.open[-1] if self.open else -1, self.plan,
                           count))


def recording() -> Optional[SpanLog]:
    """The span log while a `torch.profiler` session is open in the
    process, else None."""
    if _profiler._is_profiler_enabled or _autograd._profiler_enabled():
        return _LOG
    return None


@contextlib.contextmanager
def span(log: Optional[SpanLog], name: str, count: int = 0):
    """A span around the block; nothing with no log."""
    if log is None:
        yield
        return
    i = log.begin(name, count)
    try:
        yield
    finally:
        log.end(i)


@contextlib.contextmanager
def plan_span(log: Optional[SpanLog], count: int):
    """The ``plan`` span of one `run_plan` call: it and every span opened
    inside it carry the call's serial."""
    if log is None:
        yield
        return
    log.plans += 1
    outer, log.plan = log.plan, log.plans
    try:
        with span(log, "plan", count):
            yield
    finally:
        log.plan = outer


def timed(log: SpanLog, name: str, fn: Callable, count: int) -> Callable:
    """``fn`` with a span around each call."""
    def call(*args, **kw):
        i = log.begin(name, count)
        try:
            return fn(*args, **kw)
        finally:
            log.end(i)
    return call


_LOG = SpanLog()


def spans() -> list[Span]:
    """The log's spans in the order they began (a span's ``parent``
    indexes this list); a span still open reads ``end_ns`` -1."""
    return [Span(*s) if len(s) == 6 else Span(s[0], s[1], -1, *s[2:])
            for s in _LOG.items]


def clear_spans() -> None:
    """Empty the log and its count of dropped spans (the plans' serials
    run on)."""
    _LOG.items.clear()
    _LOG.open.clear()
    _LOG.dropped = 0


def spans_dropped() -> int:
    """Spans the log left out since it was last cleared, once full."""
    return _LOG.dropped
