"""The per-tick path on the card as a CUDA graph.

This module has no file of its own in the reference: it stands for the
reference's jit of the sweep program (``repro/netsim/engine.py``), whose
per-tick oracle is one compiled ``lax.scan`` with no host work per tick.
The port's per-tick path (`engine.run_chunk_reference`: `engine._tick`
per tick, its CC update through the per-tick kernel ``mltcp_step.cu``)
dispatches ~165 small ops a tick from Python, so on the card it spends
most of its time on the host.  Here one chunk of it, ``ticks_per_chunk``
ticks with the accumulators reset and the chunk's probes read, exactly
what `engine.run_chunk_reference` runs, is captured once a run as a CUDA
graph and replayed once a chunk.

The graph runs on static buffers: the run's `EngineState` (every tensor
leaf; the host's key stays on the host) and one chunk's `TickInputs`.  A
chunk costs one `engine.chunk_inputs`, one copy of each of its leaves into
the static inputs, one replay and a clone of each probe.  The state stays
in the static buffers from chunk to chunk: the graph's last nodes copy the
chunk's final state back into them.  Before the capture, one warm-up tick
runs eagerly on a side stream, on a clone of the state, so that the CC
kernel's library and every op have run once before the capture and the
run's own state advances only once.  The tick was written for this: no
``.item()``, no branch on a tensor value, its random draws shipped a chunk
at a time, and nothing it runs copies from the host (the telemetry's job
pairs and the chunk probes' divisors are built on the device).

Counting: the CC wrapper (``mltcp_step.LAUNCH_COUNT``) and the CC
fallback (``ops.FALLBACK_COUNT``) count on the host as their Python runs.
During the capture that Python runs once but only records the launches,
so the capture takes back what it counted (``recorded``) and each replay
adds it: the counts stay the launches that ran.  The warm-up's tick runs
for real and is counted as such (``WARM_UP_TICKS`` a capture).  Captures
and replays are counted here (``CAPTURE_COUNT``, ``REPLAY_COUNT``).

`eager_reason` keeps a configuration on the eager loop, decided before any
capture, counted once a run in ``EAGER_COUNT`` and warned once per
reason: one that runs a user's Python callable inside the tick (a probe
added with `telemetry.register_probe`, a callable F).  A capture that
fails raises and names the hook at fault; nothing runs around it.  On the
CPU the eager loop is the plain version and nothing here runs.
"""
from __future__ import annotations

import ctypes
import os
import time
import traceback
import warnings
from typing import Optional

import torch

from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import ops as kernel_ops

Tensor = torch.Tensor

# Graphs captured (one per graphed run) and replayed (one per chunk).
CAPTURE_COUNT = 0
REPLAY_COUNT = 0
# Runs on the card that `eager_reason` kept on the eager loop.
EAGER_COUNT = 0
_EAGER_WARNED: set = set()
# Eager ticks each capture's warm-up runs (counted by the CC wrapper).
WARM_UP_TICKS = 1
# The host-side counters a captured chunk bumps, (module, name).
COUNTERS = ((ms, "LAUNCH_COUNT"), (kernel_ops, "FALLBACK_COUNT"))


class CaptureError(RuntimeError):
    """The per-tick chunk could not be captured as a CUDA graph."""


def reset_warnings() -> None:
    """Re-arm the once-per-reason eager-loop warnings."""
    _EAGER_WARNED.clear()


def eager_reason(cfg) -> Optional[str]:
    """Why a configuration keeps the eager per-tick loop on the card (None:
    it is graphed): it runs a user's Python callable inside the tick, a
    probe added with `telemetry.register_probe` or a callable F."""
    reason = kernel_ops.custom_probe_reason(cfg)
    if reason is not None:
        return reason
    f_spec = cfg.protocol.f_spec
    if callable(f_spec):
        return f"f_spec={f_spec!r} is a Python callable"
    return None


def runner(cfg, statics, sweep, wl, st) -> Optional["TickGraph"]:
    """The graphed runner of a per-tick run from state ``st``, or None where
    the eager loop runs it: on the CPU, and for a configuration
    `eager_reason` keeps there, counted and warned once per reason."""
    global EAGER_COUNT
    if not kernel_ops.on_card(st.backlog):
        return None
    reason = eager_reason(cfg)
    if reason is not None:
        EAGER_COUNT += 1
        if reason not in _EAGER_WARNED:
            _EAGER_WARNED.add(reason)
            warnings.warn(f"tick_graph: {reason}; the per-tick path runs "
                          f"eagerly, op by op", stacklevel=3)
        return None
    return TickGraph(cfg, statics, sweep, wl, st)


def _leaves(tree) -> list:
    """The tensors of a tree of NamedTuples, dicts and Nones, in order (the
    host's numpy leaves are not buffers)."""
    if isinstance(tree, Tensor):
        return [tree]
    if tree is None or not isinstance(tree, (tuple, dict)):
        return []
    values = tree.values() if isinstance(tree, dict) else tree
    return [x for v in values for x in _leaves(v)]


def _clone(tree):
    from repro_torch.netsim import engine

    return engine.tree_map(
        lambda x: x.clone() if isinstance(x, Tensor) else None, tree)


def _hook_at_fault(exc: BaseException) -> str:
    """The innermost frame of the port's own code in the first error of
    ``exc``'s chain (a failed capture surfaces again when it ends)."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__cause__ or exc.__context__
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(root)
                  and os.path.abspath(f.filename) != os.path.abspath(
                      __file__)]
        if frames:
            f = frames[-1]
            return (f"{f.name} ({os.path.relpath(f.filename, root)}:"
                    f"{f.lineno})")
    return "no frame of the port"


def graph_nodes(graph) -> Optional[int]:
    """The node count of a kept graph (`torch.cuda.CUDAGraph(keep_graph=
    True)`), from libcuda's ``cuGraphGetNodes``; None where the graph or
    libcuda cannot say."""
    try:
        handle = graph.raw_cuda_graph()
        lib = ctypes.CDLL("libcuda.so.1")
    except (AttributeError, RuntimeError, OSError):
        return None
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(handle), None, ctypes.byref(n))
    return int(n.value) if rc == 0 else None


class TickGraph:
    """A per-tick run whose chunks replay one captured CUDA graph.

    `step` takes a chunk's `TickInputs` (from `engine.chunk_inputs`, which
    reads this runner's ``key`` and ``tick`` as it reads a state's) and
    returns the chunk's probes (`engine.CHUNK_FIELDS` order); `state` is
    the run's `EngineState` after the chunks so far.  With ``capture``
    false (the default on the CPU) every chunk runs the graph's body
    eagerly on the same static buffers: the code the card captures.

    ``capture_s`` (the capture, instantiation excluded), ``instantiate_s``,
    ``nodes`` and ``recorded`` ({counter: count} a replay adds) describe
    the captured graph once `step` has run.
    """

    def __init__(self, cfg, statics, sweep, wl, st,
                 capture: Optional[bool] = None):
        self.cfg, self.statics, self.sweep, self.wl = cfg, statics, sweep, wl
        self.device = st.backlog.device
        self.capture = (self.device.type == "cuda" if capture is None
                        else capture)
        self.key = st.key
        self._state = _clone(st._replace(key=None))
        self._inputs = None
        self._graph = None
        self._probes = None
        self.capture_s = self.instantiate_s = None
        self.nodes = None
        self.recorded: dict = {}

    @property
    def tick(self) -> Tensor:
        return self._state.tick

    def state(self):
        """The run's state (its tensors are the static buffers)."""
        return self._state._replace(key=self.key)

    def _body(self, st, inputs) -> tuple:
        """One chunk from the static state: `engine.run_chunk_reference`,
        then its final state copied back into the static buffers.  Returns
        the probes."""
        from repro_torch.netsim import engine

        after, probes = engine.run_chunk_reference(
            self.cfg, self.statics, self.sweep, self.wl, st, inputs)
        dst, src = _leaves(st), _leaves(after)
        if len(dst) != len(src):
            raise ValueError(f"tick_graph: a chunk changed the state's "
                             f"leaves ({len(dst)} -> {len(src)})")
        if self.device.type != "meta":
            # a leaf the chunk left untouched is the static buffer itself;
            # any other must not alias one, or the copies would race
            own = {x.untyped_storage().data_ptr() for x in dst}
            for d, s in zip(dst, src):
                if s is not d and s.untyped_storage().data_ptr() in own:
                    raise ValueError("tick_graph: a state leaf after the "
                                     "chunk aliases another static buffer")
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)
        return probes

    def _warm_up(self) -> None:
        """``WARM_UP_TICKS`` eager ticks and the probes on a clone of the
        state and the first ticks of the static inputs; on the card on a
        side stream, as a capture wants."""
        from repro_torch.netsim import engine

        first = engine.TickInputs(*(None if x is None
                                    else x[:WARM_UP_TICKS]
                                    for x in self._inputs))

        def run():
            engine.run_chunk_reference(self.cfg, self.statics, self.sweep,
                                       self.wl, _clone(self._state), first)
        if self.device.type != "cuda":
            run()
            return
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            run()
        current.wait_stream(side)

    def _capture(self) -> None:
        global CAPTURE_COUNT
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:           # a torch without kept graphs
            graph = torch.cuda.CUDAGraph()
        before = {c: getattr(*c) for c in COUNTERS}
        t0 = time.time()
        try:
            with torch.cuda.graph(graph):
                self._probes = self._body(self._state, self._inputs)
        except Exception as exc:
            raise CaptureError(
                f"tick_graph: capturing the per-tick chunk failed in "
                f"{_hook_at_fault(exc)}: {exc}") from exc
        finally:
            # the capture recorded the launches it counted; replays count
            self.recorded = {name: getattr(mod, name) - before[(mod, name)]
                             for mod, name in COUNTERS}
            for (mod, name), n in before.items():
                setattr(mod, name, n)
        self.capture_s = time.time() - t0
        self.nodes = graph_nodes(graph)
        t0 = time.time()
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        self.instantiate_s = time.time() - t0
        self._graph = graph
        CAPTURE_COUNT += 1

    def step(self, inputs) -> tuple:
        """One chunk: the inputs into the static buffers, the graph's replay
        (captured at the first chunk), the probes cloned out."""
        global REPLAY_COUNT
        keys, inputs = inputs.key, inputs._replace(key=None)
        if self._inputs is None:
            self._inputs = _clone(inputs)
            self._warm_up()
        else:
            for d, s in zip(_leaves(self._inputs), _leaves(inputs)):
                d.copy_(s)
        if not self.capture:
            probes = self._body(self._state, self._inputs)
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            REPLAY_COUNT += 1
            for mod, name in COUNTERS:
                setattr(mod, name, getattr(mod, name) + self.recorded[name])
            probes = self._probes
        self.key = keys[-1]
        return tuple(p.clone() for p in probes)
