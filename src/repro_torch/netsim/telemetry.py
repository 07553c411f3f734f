"""Telemetry: probes sampled into ring buffers, and streaming detectors.

The engine's chunk-averaged ``trace_*`` channels are too coarse for the
paper's *dynamic* claims: Fig. 5/7a plot per-flow cwnd and throughput
timelines at sub-iteration resolution, and "flows stabilize into an
interleaved state within a few training iterations" needs a
*time-to-interleave* measurement, not a tail average.  So:

* A static `TelemetrySpec` (hashable; part of `SimConfig`, hence of a
  plan's group key) names which **probes** are armed and their decimation
  ``stride``.  Armed probes sample per-tick signals (per-flow cwnd / rate /
  bytes_ratio, per-link queue depth and RED mark rate, per-job phase state
  and F factor, the interleave detector's overlap) into ring buffers of
  the run's state, ``[K, cap, ...]``.
* **Streaming detectors** reduce the run without dense traces: the
  interleave detector keeps the EWMA pairwise comm-overlap and records the
  last tick it exceeded a threshold (time-to-interleave = the first tick
  after which overlap *stays* below) and a tail-stability fraction; the
  iteration-time sketch bins completed iteration times into a per-job log
  histogram for streaming p50/p99; the re-interleave detector segments
  the overlap signal by fault-event window (it needs ``cfg.faults``).
* The engine's chunk-averaged ``trace_*`` channels are the built-in chunk
  probes (`CHUNK_PROBES`), always on.

**Off is free**: every hook in the engine is gated on a python-level
``cfg.telemetry is not None``, so an unarmed config runs the code it ran
before this module existed (tests/test_torch_telemetry.py).

`tick_update` is the plain version, one tick of every point ([K] leading
on every leaf, in place of the reference's ``vmap``).  On the card the
chunk kernel (`kernels/csrc/netsim_chunk.cu`) runs the same arithmetic
for the ten built-in probes and the three detectors, bit for bit; a
probe added with `register_probe` is a Python callable, so a spec that
arms one takes the per-tick path (counted, `kernels.ops`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.segment import fold_sum

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Tick signals — the read-only view probes capture from
# ---------------------------------------------------------------------------

class TickSignals(NamedTuple):
    """Per-tick values the engine exposes to armed probes, each with a
    leading [K].

    All values are *post-update* for this tick except ``rate``, the send
    rate the tick injected at (the pre-update CC rate, what Fig. 5
    plots).  ``f_job`` is computed only when the ``job_f`` probe is armed;
    ``overlap`` is the interleave detector's current EWMA pairwise
    comm-overlap (None when the detector is unarmed); ``fault_idx`` is the
    current event-table row (None without ``cfg.faults``).
    """

    tick: Tensor              # [K] int32
    t: Tensor                 # [K] float32, seconds
    cwnd: Tensor              # [K, N] packets
    rate: Tensor              # [K, N] bytes/s (injection rate this tick)
    bytes_ratio: Tensor       # [K, N] Algorithm 1 progress ratio
    q_len: Tensor             # [K, M] queued bytes per link
    red_prob: Tensor          # [K, M] RED mark/drop probability per link
    in_comm: Tensor           # [K, J] bool
    phase_idx: Tensor         # [K, J] int32
    iter_idx: Tensor          # [K, J] int32
    iter_done: Tensor         # [K, J] bool (an iteration completed)
    iter_time: Tensor         # [K, J] seconds (valid where iter_done)
    f_job: Optional[Tensor] = None       # [K, J] mean aggressiveness F
    job_active: Optional[Tensor] = None  # [K, J] bool (padding and churn)
    overlap: Optional[Tensor] = None     # [K] EWMA pairwise overlap
    fault_idx: Optional[Tensor] = None   # [K] int32 current event row
    fault_ticks: Optional[Tensor] = None  # [K, E] int32 event start ticks


# ---------------------------------------------------------------------------
# Probe registry
# ---------------------------------------------------------------------------

class Probe(NamedTuple):
    """One registered probe: a capture function plus its shape ``kind``.

    kind decides the per-sample shape and how `collect` trims padded
    fabrics: "flow" -> [N] (trimmed to the point's own flows), "link" ->
    [M], "job" -> [J] (trimmed to active jobs), "scalar" -> [].
    """

    kind: str
    capture: Callable[[TickSignals], Tensor]
    doc: str = ""


_KINDS = ("flow", "link", "job", "scalar")

PROBES: dict[str, Probe] = {}


def register_probe(name: str, kind: str,
                   capture: Callable[[TickSignals], Tensor],
                   doc: str = "", overwrite: bool = False) -> None:
    """Add a probe to the registry so `TelemetrySpec(probes=(name, ...))`
    can arm it.  ``capture`` maps a `TickSignals` to this tick's sample,
    [K, *shape]."""
    if kind not in _KINDS:
        raise ValueError(f"probe {name!r}: unknown kind {kind!r} "
                         f"(expected one of {_KINDS})")
    if name in PROBES and not overwrite:
        raise ValueError(f"probe {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    PROBES[name] = Probe(kind=kind, capture=capture, doc=doc)


register_probe("flow_cwnd", "flow", lambda s: s.cwnd,
               "per-flow congestion window (packets)")
register_probe("flow_rate", "flow", lambda s: s.rate,
               "per-flow injection rate (bytes/s)")
register_probe("flow_ratio", "flow", lambda s: s.bytes_ratio,
               "per-flow Algorithm-1 bytes_ratio")
register_probe("link_queue", "link", lambda s: s.q_len,
               "per-link queued bytes")
register_probe("link_mark_rate", "link", lambda s: s.red_prob,
               "per-link RED mark/drop probability")
register_probe("job_incomm", "job", lambda s: s.in_comm.to(torch.float32),
               "per-job comm-phase indicator")
register_probe("job_phase", "job", lambda s: s.phase_idx.to(torch.float32),
               "per-job sub-phase index")
register_probe("job_iter", "job", lambda s: s.iter_idx.to(torch.float32),
               "per-job completed-iteration count")
register_probe("job_f", "job", lambda s: s.f_job,
               "per-job mean aggressiveness factor F")
register_probe("interleave_overlap", "scalar", lambda s: s.overlap,
               "EWMA pairwise comm-overlap (interleave detector signal)")

# The probes the chunk kernel captures itself, in the order of its probe
# offsets (``D_OFF_*`` of csrc/netsim_chunk.cu).  A name re-registered
# with another capture function is no longer built in.
BUILTIN_PROBES = tuple(PROBES)
_BUILTIN = dict(PROBES)


def is_builtin(name: str) -> bool:
    return name in _BUILTIN and PROBES.get(name) is _BUILTIN[name]


def probe_shape(name: str, cfg) -> tuple[int, ...]:
    kind = PROBES[name].kind
    if kind == "flow":
        return (cfg.topo.n_flows,)
    if kind == "link":
        return (cfg.topo.n_links,)
    if kind == "job":
        return (cfg.jobs.n_jobs,)
    return ()


# ---------------------------------------------------------------------------
# The spec — static, hashable, part of a plan's group key
# ---------------------------------------------------------------------------

DETECTORS = ("interleave", "iter_sketch", "reinterleave")

# "reinterleave" is opt-in (it needs cfg.faults), so it is not a default
DEFAULT_DETECTORS = ("interleave", "iter_sketch")

DEFAULT_PROBES = ("flow_cwnd", "flow_rate", "link_queue", "link_mark_rate",
                  "job_incomm", "job_iter")


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Static description of what a run captures.

    probes:    registered probe names sampled every ``stride`` ticks into a
               ring buffer of ``capacity`` slots (None: sized to hold every
               sampled tick — no wrapping).
    detectors: streaming reductions; "interleave" maintains the EWMA
               pairwise comm-overlap (time constant ``overlap_tau``
               seconds) and records time-to-interleave against
               ``overlap_threshold`` (converged only if overlap stays below
               it for the final ``hold_frac`` of the run), "iter_sketch"
               bins completed iteration times into ``sketch_bins``
               log-spaced bins on [sketch_lo, sketch_hi] seconds for
               streaming p50/p99, and "reinterleave" (opt-in; requires
               ``cfg.faults``) segments the same overlap signal by
               fault-event window — per event it records the first/last
               tick the event's table row was current, the iteration count
               at entry and the last tick overlap was bad, yielding
               per-event disruption duration and *time-to-re-interleave*
               in training iterations.
    """

    probes: tuple[str, ...] = DEFAULT_PROBES
    stride: int = 50
    capacity: Optional[int] = None
    detectors: tuple[str, ...] = DEFAULT_DETECTORS
    # an EWMA Jaccard above 0.5 means comm phases are majority-overlapping;
    # tau spans a fraction of an iteration so within-phase brush-ups don't
    # reset the convergence clock
    overlap_threshold: float = 0.5
    overlap_tau: float = 0.05
    hold_frac: float = 0.1
    sketch_bins: int = 64
    sketch_lo: float = 1e-4
    sketch_hi: float = 100.0

    def __post_init__(self):
        object.__setattr__(self, "probes", tuple(self.probes))
        object.__setattr__(self, "detectors", tuple(self.detectors))
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        for d in self.detectors:
            if d not in DETECTORS:
                raise ValueError(f"unknown detector {d!r} "
                                 f"(valid: {', '.join(DETECTORS)})")

    def wants(self, probe: str) -> bool:
        return probe in self.probes

    def needs_interleave(self) -> bool:
        # reinterleave segments the interleave detector's overlap signal,
        # so arming it arms the EWMA machinery too
        return ("interleave" in self.detectors
                or "reinterleave" in self.detectors
                or self.wants("interleave_overlap"))

    def needs_sketch(self) -> bool:
        return "iter_sketch" in self.detectors

    def needs_reinterleave(self) -> bool:
        return "reinterleave" in self.detectors

    def validate(self) -> None:
        """Check every armed probe is registered (the registry may grow
        after a spec is built, so this runs at arm time)."""
        for name in self.probes:
            if name not in PROBES:
                raise ValueError(
                    f"unknown probe {name!r}; registered probes: "
                    f"{', '.join(sorted(PROBES))} (register_probe adds more)")

    def n_slots(self, n_ticks: int) -> int:
        full = -(-n_ticks // self.stride)        # ceil: ticks 0, s, 2s, ...
        return full if self.capacity is None else min(self.capacity, full)


def _f32(x: float) -> float:
    """A python float rounded once to float32 (exactly representable, so
    torch and the kernel see the same value)."""
    return float(np.float32(x))


def ewma_alpha(cfg, spec: TelemetrySpec) -> float:
    """The overlap EWMA's weight per tick, ``float32(-expm1(-dt/tau))``,
    computed once in python as the reference does."""
    return _f32(-math.expm1(-cfg.dt / spec.overlap_tau))


def sketch_constants(spec: TelemetrySpec) -> dict:
    """The sketch's float32 constants: the clamp range, ``log(lo)`` and
    bins per unit of ``log``."""
    log_lo = math.log(spec.sketch_lo)
    inv_w = spec.sketch_bins / (math.log(spec.sketch_hi) - log_lo)
    return dict(lo=_f32(spec.sketch_lo), hi=_f32(spec.sketch_hi),
                log_lo=_f32(log_lo), inv_w=_f32(inv_w))


def sketch_bins(x: Tensor, spec: TelemetrySpec) -> Tensor:
    """The sketch's bin (int32) of each iteration time in ``x``: clamped
    to [sketch_lo, sketch_hi], log, scaled, clamped, truncated."""
    c = sketch_constants(spec)
    x = torch.clamp(x, c["lo"], c["hi"])
    return torch.clamp((torch.log(x) - c["log_lo"]) * c["inv_w"], 0.0,
                       float(spec.sketch_bins - 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# Run state
# ---------------------------------------------------------------------------

class TelemetryState(NamedTuple):
    """Telemetry's part of the engine state; every leaf has a leading [K].

    ``series`` maps armed probe name -> [K, cap, *shape] ring buffer;
    ``sample_tick`` records which tick each slot holds (-1 = unset), so
    `collect` can unwrap a wrapped ring chronologically.  Detector fields
    are None when the detector is unarmed.
    """

    series: dict
    sample_tick: Tensor           # [K, cap] int32
    n_samples: Tensor             # [K] int32 total writes
    # interleave detector
    ewma_both: Optional[Tensor] = None      # [K, P2] per-pair EWMA of a&b
    ewma_either: Optional[Tensor] = None    # [K, P2] per-pair EWMA of a|b
    last_bad_tick: Optional[Tensor] = None  # [K] int32 (-1: never bad)
    iters_at_last_bad: Optional[Tensor] = None  # [K] int32
    tail_bad: Optional[Tensor] = None       # [K] int32 bad ticks in tail
    tail_ticks: Optional[Tensor] = None     # [K] int32 ticks in tail
    # iteration-time sketch
    iter_hist: Optional[Tensor] = None      # [K, J, B] int32
    # re-interleave detector: per-fault-event segmentation of the overlap
    # signal (all [K, E], indexed by the current event row)
    ev_start_tick: Optional[Tensor] = None        # first tick row current
    ev_start_iter: Optional[Tensor] = None        # max iter count at entry
    ev_end_tick: Optional[Tensor] = None          # last tick row current
    ev_last_bad_tick: Optional[Tensor] = None     # last bad tick in window
    ev_iters_at_last_bad: Optional[Tensor] = None


def init_state(cfg, spec: TelemetrySpec, k: int, device) -> TelemetryState:
    """Ring buffers and detector state for K simulations of ``cfg``."""
    spec.validate()
    cap = spec.n_slots(cfg.n_ticks)

    def full(shape, value, dtype):
        return torch.full((k,) + tuple(shape), value, dtype=dtype,
                          device=device)

    series = {name: full((cap,) + probe_shape(name, cfg), 0.0, torch.float32)
              for name in spec.probes}
    j = cfg.jobs.n_jobs
    kw: dict = {}
    if spec.needs_interleave():
        p2 = j * (j - 1) // 2
        kw.update(ewma_both=full((p2,), 0.0, torch.float32),
                  ewma_either=full((p2,), 0.0, torch.float32),
                  last_bad_tick=full((), -1, torch.int32),
                  iters_at_last_bad=full((), 0, torch.int32),
                  tail_bad=full((), 0, torch.int32),
                  tail_ticks=full((), 0, torch.int32))
    if spec.needs_sketch():
        kw.update(iter_hist=full((j, spec.sketch_bins), 0, torch.int32))
    if spec.needs_reinterleave():
        if cfg.faults is None:
            raise ValueError(
                "the 'reinterleave' detector segments statistics by fault "
                "event, so it needs cfg.faults (a netsim.faults.FaultSpec); "
                "arm faults or drop the detector")
        e = cfg.faults.n_events
        kw.update(ev_start_tick=full((e,), -1, torch.int32),
                  ev_start_iter=full((e,), 0, torch.int32),
                  ev_end_tick=full((e,), -1, torch.int32),
                  ev_last_bad_tick=full((e,), -1, torch.int32),
                  ev_iters_at_last_bad=full((e,), 0, torch.int32))
    return TelemetryState(series=series,
                          sample_tick=full((cap,), -1, torch.int32),
                          n_samples=full((), 0, torch.int32), **kw)


def _pairs(j: int, device) -> tuple[Tensor, Tensor]:
    """The job pairs (a < b) in row-major order: the fold order of the
    overlap sum."""
    ia, ib = np.triu_indices(j, 1)
    return (torch.as_tensor(ia, device=device),
            torch.as_tensor(ib, device=device))


def _at(x: Tensor, idx: Tensor) -> Tensor:
    """x[k, idx[k]] for a [K, E] tensor and [K] indices, as [K, 1]."""
    return x.gather(1, idx)


def _ring_write(buf: Tensor, sel: Tensor, val: Tensor) -> Tensor:
    """``buf[k, s] = val[k]`` where ``sel[k, s]`` (an exact select; ``sel``
    marks at most the one slot of this tick's sample)."""
    rest = buf.dim() - 2
    return torch.where(sel.view(tuple(sel.shape) + (1,) * rest),
                       val.to(buf.dtype).unsqueeze(1), buf)


def tick_update(cfg, spec: TelemetrySpec, st: TelemetryState,
                sig: TickSignals) -> TelemetryState:
    """One telemetry step of K points: detectors first (so the
    ``interleave_overlap`` probe sees this tick's value), then decimated
    ring-buffer capture."""
    kw: dict = {}
    k, j = sig.in_comm.shape
    dev = sig.in_comm.device

    if spec.needs_interleave():
        ia, ib = _pairs(j, dev)
        a, b = sig.in_comm[:, ia], sig.in_comm[:, ib]
        if sig.job_active is not None:
            w = (sig.job_active[:, ia] & sig.job_active[:, ib]).to(
                torch.float32)
        else:
            w = torch.ones(a.shape, dtype=torch.float32, device=dev)
        both = w * (a & b).to(torch.float32)
        either = w * (a | b).to(torch.float32)
        alpha = ewma_alpha(cfg, spec)
        ewma_both = st.ewma_both + alpha * (both - st.ewma_both)
        ewma_either = st.ewma_either + alpha * (either - st.ewma_either)
        per_pair = ewma_both / torch.clamp_min(ewma_either, 1e-6)
        if ia.numel():
            # left folds in pair order (the kernel's one-thread fold)
            overlap = fold_sum(per_pair * w, 1) / torch.clamp_min(
                fold_sum(w, 1), 1.0)
        else:
            overlap = torch.zeros((k,), dtype=torch.float32, device=dev)
        bad = overlap > _f32(spec.overlap_threshold)
        active_iters = sig.iter_idx
        if sig.job_active is not None:
            active_iters = torch.where(sig.job_active, sig.iter_idx, 0)
        cur_iters = (active_iters.amax(dim=1) if j else
                     torch.zeros((k,), dtype=torch.int32, device=dev))
        in_tail = sig.tick >= (cfg.n_ticks // 2)
        kw.update(
            ewma_both=ewma_both, ewma_either=ewma_either,
            last_bad_tick=torch.where(bad, sig.tick, st.last_bad_tick),
            iters_at_last_bad=torch.where(bad, cur_iters,
                                          st.iters_at_last_bad),
            tail_bad=st.tail_bad + (bad & in_tail).to(torch.int32),
            tail_ticks=st.tail_ticks + in_tail.to(torch.int32))
        sig = sig._replace(overlap=overlap)

        if spec.needs_reinterleave():
            # segment the same bad/cur_iters signals by the current fault
            # event row
            ei = sig.fault_idx.long().view(k, 1)
            tick = sig.tick.view(k, 1)
            iters = cur_iters.view(k, 1)
            bad1 = bad.view(k, 1)
            first = _at(st.ev_start_tick, ei) < 0
            kw.update(
                ev_start_tick=st.ev_start_tick.scatter(1, ei, torch.where(
                    first, tick, _at(st.ev_start_tick, ei))),
                ev_start_iter=st.ev_start_iter.scatter(1, ei, torch.where(
                    first, iters, _at(st.ev_start_iter, ei))),
                ev_end_tick=st.ev_end_tick.scatter(1, ei, tick),
                ev_last_bad_tick=st.ev_last_bad_tick.scatter(
                    1, ei, torch.where(bad1, tick,
                                       _at(st.ev_last_bad_tick, ei))),
                ev_iters_at_last_bad=st.ev_iters_at_last_bad.scatter(
                    1, ei, torch.where(bad1, iters,
                                       _at(st.ev_iters_at_last_bad, ei))))

    if spec.needs_sketch():
        bins = sketch_bins(sig.iter_time, spec)
        kw["iter_hist"] = st.iter_hist.scatter_add(
            2, bins.long().unsqueeze(-1),
            sig.iter_done.to(torch.int32).unsqueeze(-1))

    cap = st.sample_tick.shape[1]
    take = torch.remainder(sig.tick, spec.stride) == 0
    slot = torch.remainder(
        torch.div(sig.tick, spec.stride, rounding_mode="floor"), cap)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    sel = (slots == slot.unsqueeze(1)) & take.unsqueeze(1)
    series = {name: _ring_write(st.series[name], sel,
                                PROBES[name].capture(sig))
              for name in spec.probes}
    return st._replace(
        series=series,
        sample_tick=_ring_write(st.sample_tick, sel, sig.tick),
        n_samples=st.n_samples + take.to(torch.int32),
        **kw)


# ---------------------------------------------------------------------------
# Built-in chunk probes — the trace_* channels
# ---------------------------------------------------------------------------

def _span(cfg, st, tpc: int) -> Tensor:
    return torch.tensor(tpc * cfg.dt, dtype=torch.float32,
                        device=st.acc_util.device)


# name -> capture(cfg, statics, st, ticks_per_chunk); insertion order is the
# RawSimOutput field order (trace_util .. trace_ratio).  The chunk kernel's
# epilogue computes the same expressions (engine.run_ticks' traces).
CHUNK_PROBES: dict[str, Callable] = {
    "trace_util": lambda cfg, statics, st, tpc:
        st.acc_util / torch.tensor(float(tpc), device=st.acc_util.device),
    "trace_drops": lambda cfg, statics, st, tpc: st.acc_drops,
    "trace_marks": lambda cfg, statics, st, tpc: st.acc_marks,
    "trace_incomm": lambda cfg, statics, st, tpc: st.in_comm,
    "trace_t": lambda cfg, statics, st, tpc:
        st.tick.to(torch.float32) * cfg.dt,
    "trace_jobtput": lambda cfg, statics, st, tpc:
        st.acc_jobbytes / _span(cfg, st, tpc),
    "trace_ratio": lambda cfg, statics, st, tpc:
        statics.groups.sum(st.proto.det.bytes_ratio) / statics.flows_per_job,
}


def chunk_capture(cfg, statics, st, ticks_per_chunk: int) -> tuple:
    """The per-chunk trace outputs, in `RawSimOutput` field order."""
    return tuple(fn(cfg, statics, st, ticks_per_chunk)
                 for fn in CHUNK_PROBES.values())


# ---------------------------------------------------------------------------
# Host-side view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultEventReport:
    """Re-interleave verdict for one fault-event window.

    ``disrupted`` is whether overlap ever exceeded the threshold inside the
    window; ``reconverged`` whether it then stayed below for the window's
    final hold fraction.  ``reinterleave_iters`` counts training iterations
    from the event's start to the last bad tick — the paper-facing
    "re-stabilizes within a few training iterations" number (0.0 when the
    event never disrupted; inf when it never re-converged).
    """

    event: int
    start_tick: int
    start_t: float
    end_tick: int
    start_iter: int
    disrupted: bool
    reconverged: bool
    disruption_s: float
    reinterleave_iters: float


@dataclasses.dataclass
class TelemetryResult:
    """Numpy-side view of one run's telemetry (attached to `SimResult`).

    ``series[name]`` is [S, *shape] in chronological sample order and
    ``t``/``ticks`` are the matching sample times; padded fabrics are
    trimmed to the point's own flows/jobs.  Detector outputs are floats
    (inf = the run never converged; nan = detector unarmed).
    """

    spec: TelemetrySpec
    t: np.ndarray                     # [S] seconds
    ticks: np.ndarray                 # [S] int32
    series: dict                      # name -> [S, ...]
    n_samples: int
    # interleave detector
    time_to_interleave_s: float = float("nan")
    time_to_interleave_iters: float = float("nan")
    interleave_stability: float = float("nan")
    converged: bool = False
    # iteration-time sketch
    iter_hist: Optional[np.ndarray] = None    # [J, B]
    bin_edges: Optional[np.ndarray] = None    # [B + 1] seconds
    # re-interleave detector (one report per *observed* fault event —
    # table rows whose window never arrived inside the run are skipped)
    fault_events: Optional[list] = None       # list[FaultEventReport]
    all_events_reconverged: bool = False
    max_reinterleave_iters: float = float("nan")

    def timeline(self, probe: str) -> tuple[np.ndarray, np.ndarray]:
        """(t, values) for one armed probe's decimated series."""
        if probe not in self.series:
            raise KeyError(f"probe {probe!r} was not armed "
                           f"(armed: {', '.join(self.series)})")
        return self.t, self.series[probe]

    def iter_quantile(self, q: float, job: Optional[int] = None) -> float:
        """Streaming quantile of iteration times from the log-histogram
        sketch (accurate to one bin width — ~20% at the default 64 bins
        over 6 decades).  job=None pools all jobs."""
        if self.iter_hist is None:
            raise ValueError("iter_sketch detector was not armed")
        h = (self.iter_hist.sum(axis=0) if job is None
             else self.iter_hist[job])
        total = int(h.sum())
        if total == 0:
            return float("nan")
        idx = int(np.searchsorted(np.cumsum(h), q * total, side="left"))
        idx = min(idx, h.shape[0] - 1)
        centers = np.sqrt(self.bin_edges[:-1] * self.bin_edges[1:])
        return float(centers[idx])

    @property
    def p50_iter(self) -> float:
        return self.iter_quantile(0.50)

    @property
    def p99_iter(self) -> float:
        return self.iter_quantile(0.99)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else \
        np.asarray(x)


def collect(cfg, state: TelemetryState,
            n_jobs: Optional[int] = None) -> TelemetryResult:
    """One run's final `TelemetryState` (without the K axis) as a
    `TelemetryResult`.

    ``cfg`` is the *point's own* config (unpadded): flow-kind series are
    trimmed to its flow count and job-kind series to ``n_jobs`` (padded
    groups put the point's flows/jobs in a prefix).
    """
    spec = cfg.telemetry
    ticks = _np(state.sample_tick)
    valid = np.nonzero(ticks >= 0)[0]
    order = valid[np.argsort(ticks[valid], kind="stable")]
    n = cfg.jobs.n_jobs if n_jobs is None else n_jobs
    n_flows = cfg.topo.n_flows
    series = {}
    for name in spec.probes:
        buf = _np(state.series[name])[order]
        kind = PROBES[name].kind
        if kind == "flow":
            buf = buf[:, :n_flows]
        elif kind == "job":
            buf = buf[:, :n]
        series[name] = buf

    out = TelemetryResult(
        spec=spec, t=ticks[order].astype(np.float64) * cfg.dt,
        ticks=ticks[order], series=series,
        n_samples=int(_np(state.n_samples)))

    if spec.needs_interleave():
        last_bad = int(_np(state.last_bad_tick))
        hold = int(round(spec.hold_frac * cfg.n_ticks))
        tail_n = int(_np(state.tail_ticks))
        out.interleave_stability = (
            1.0 - int(_np(state.tail_bad)) / tail_n if tail_n
            else float("nan"))
        if last_bad < 0:
            out.converged = True
            out.time_to_interleave_s = 0.0
            out.time_to_interleave_iters = 0.0
        elif last_bad < cfg.n_ticks - hold:
            out.converged = True
            out.time_to_interleave_s = (last_bad + 1) * cfg.dt
            out.time_to_interleave_iters = float(
                _np(state.iters_at_last_bad))
        else:
            out.converged = False
            out.time_to_interleave_s = float("inf")
            out.time_to_interleave_iters = float("inf")

    if spec.needs_sketch():
        out.iter_hist = _np(state.iter_hist)[:n]
        b = spec.sketch_bins
        out.bin_edges = spec.sketch_lo * (
            spec.sketch_hi / spec.sketch_lo) ** (np.arange(b + 1) / b)

    if spec.needs_reinterleave():
        starts = _np(state.ev_start_tick)
        start_iters = _np(state.ev_start_iter)
        ends = _np(state.ev_end_tick)
        last_bads = _np(state.ev_last_bad_tick)
        bad_iters = _np(state.ev_iters_at_last_bad)
        reports = []
        for e in np.nonzero(starts >= 0)[0]:
            s, t_end = int(starts[e]), int(ends[e])
            window = t_end - s + 1
            hold = int(round(spec.hold_frac * window))
            last_bad = int(last_bads[e])
            rep = FaultEventReport(
                event=int(e), start_tick=s, start_t=s * cfg.dt,
                end_tick=t_end, start_iter=int(start_iters[e]),
                disrupted=last_bad >= 0, reconverged=True,
                disruption_s=0.0, reinterleave_iters=0.0)
            if last_bad >= 0:
                if last_bad <= t_end - hold:
                    rep.disruption_s = (last_bad + 1 - s) * cfg.dt
                    rep.reinterleave_iters = float(
                        int(bad_iters[e]) - rep.start_iter)
                else:
                    rep.reconverged = False
                    rep.disruption_s = float("inf")
                    rep.reinterleave_iters = float("inf")
            reports.append(rep)
        out.fault_events = reports
        out.all_events_reconverged = all(r.reconverged for r in reports)
        out.max_reinterleave_iters = (
            max(r.reinterleave_iters for r in reports) if reports else 0.0)
    return out
