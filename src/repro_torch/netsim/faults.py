"""Fault injection: job churn, link flaps, blackholes, straggle bursts.

The paper's robustness claim is dynamic: MLTCP "stabilizes flows of
different jobs into an interleaved state within a few training
iterations, regardless of the number of competing flows or the start time
of each flow" (§1, §5.4).  This module perturbs running simulations, and
the telemetry layer (`netsim.telemetry`, its "reinterleave" detector)
measures the re-convergence.

The configuration split is the engine's:

* A hashable `FaultSpec` on ``SimConfig.faults`` declares the fault
  *structure*: how many schedule rows (``n_events``) and which channels
  are armed (churn / link flaps / blackholes / straggle bursts).  It is
  part of a plan's group key, like ``telemetry``; ``faults=None`` runs the
  unfaulted code, bit for bit.
* The schedule *values* are `SweepParams` leaves (``fault_tick`` [E],
  ``fault_job_active`` [E, J], ``fault_link_scale`` [E, M],
  ``fault_blackhole`` [E, N], ``fault_straggle`` [E, J]), so a grid of
  schedules x seeds x variants shares one run per group.

The event table is a step function over ticks: row ``e`` is in effect
from ``fault_tick[e]`` until the next row's tick (rows sorted ascending;
row 0 is the identity baseline at tick 0).  The engine ranks each tick
against the tick column (``sum(fault_tick <= tick) - 1``) when it builds
a chunk's inputs (`engine.chunk_inputs`) and applies the row at the
engine and link level: activity masking in the job phase machine,
capacity scaling in the link server, first-hop null-routing of
blackholed flows, the straggle boost.

`schedule` compiles a list of declarative `FaultEvent`s (from the builder
helpers below) into the event table on a concrete config's fabric;
`identity_schedule` emits an all-no-op table for a spec, which runs bit
for bit like an unfaulted simulation (every channel's no-op is exact:
``& True``, ``* 1.0``, ``- 0.0``, ``+ 0.0``).  The tables are numpy arrays
built on the host (`make_sweep` puts them on the sweep's device); their
ints and bools equal the reference's exactly and their floats are
products of python floats rounded once to float32, as there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "FIELDS", "FaultSpec", "FaultEvent", "FaultSchedule",
    "schedule", "identity_schedule",
    "job_departs", "job_arrives", "link_flap", "blackhole",
    "straggle_burst",
]

# Every SweepParams leaf the fault layer can occupy, in field order.
FIELDS = ("fault_tick", "fault_job_active", "fault_link_scale",
          "fault_blackhole", "fault_straggle")

# channel name -> the SweepParams leaf its values ride in
_CHANNEL_FIELD = {
    "churn": "fault_job_active",
    "link": "fault_link_scale",
    "blackhole": "fault_blackhole",
    "straggle": "fault_straggle",
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Static fault structure — lives on ``SimConfig.faults``.

    ``n_events`` fixes the event-table row count (a tensor *shape*,
    hence static); the channel flags decide which schedule leaves exist.
    Two configs with equal specs share a compile group even when their
    schedules differ — the schedule is data, not structure.
    """

    n_events: int
    churn: bool = False             # job arrival/departure masks
    link_flaps: bool = False        # per-link capacity multipliers
    blackholes: bool = False        # per-flow first-hop null routes
    straggle_bursts: bool = False   # additive straggle-probability boosts

    def __post_init__(self):
        if self.n_events < 1:
            raise ValueError(f"FaultSpec needs n_events >= 1 "
                             f"(row 0 is the identity baseline); "
                             f"got {self.n_events}")

    def leaves(self) -> tuple[str, ...]:
        """The SweepParams leaves this spec requires (always the tick
        column, plus one table per armed channel)."""
        out = ["fault_tick"]
        if self.churn:
            out.append("fault_job_active")
        if self.link_flaps:
            out.append("fault_link_scale")
        if self.blackholes:
            out.append("fault_blackhole")
        if self.straggle_bursts:
            out.append("fault_straggle")
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One declarative fault edit, before compilation onto a tick grid.

    ``channel`` is "churn" | "link" | "blackhole" | "straggle".  Churn
    edits are *persistent* (a departure holds until the next arrival);
    the windowed channels apply on ``[t, t_end)`` (``t_end=None``: until
    the end of the run).  ``index`` selects jobs / links / flows (empty
    tuple = all of them); ``value`` is the mask/scale/boost applied.
    """

    channel: str
    t: float
    t_end: Optional[float]
    index: tuple
    value: float

    def __post_init__(self):
        if self.channel not in _CHANNEL_FIELD:
            raise ValueError(f"unknown fault channel {self.channel!r} "
                             f"(valid: {', '.join(_CHANNEL_FIELD)})")
        if self.t < 0.0:
            raise ValueError(f"fault event starts at t={self.t} < 0")
        if self.t_end is not None and self.t_end <= self.t:
            raise ValueError(f"fault event window [{self.t}, {self.t_end}) "
                             f"is empty")


def job_departs(t: float, job: int) -> FaultEvent:
    """Job ``job`` leaves the fabric at ``t`` (migration / preemption):
    its compute clock freezes and its flows stop injecting until a
    matching `job_arrives`."""
    return FaultEvent("churn", t, None, (int(job),), 0.0)


def job_arrives(t: float, job: int) -> FaultEvent:
    """Job ``job`` (re)joins the fabric at ``t`` and resumes where its
    phase machine stopped — an interrupted comm phase restarts with a
    fresh quota."""
    return FaultEvent("churn", t, None, (int(job),), 1.0)


def link_flap(t: float, t_end: Optional[float], link: int,
              scale: float) -> FaultEvent:
    """Link ``link`` serves at ``scale`` x nominal capacity on
    ``[t, t_end)`` — 0.5 is a degraded optic, 0.0 a hard down."""
    if scale < 0.0:
        raise ValueError(f"link_flap scale must be >= 0, got {scale}")
    return FaultEvent("link", t, t_end, (int(link),), float(scale))


def blackhole(t: float, t_end: Optional[float],
              flows: Sequence[int]) -> FaultEvent:
    """Flows in ``flows`` are null-routed at their first hop on
    ``[t, t_end)``: injected bytes vanish as drops (loss-signaled after
    the usual feedback delay, retransmitted when the hole closes)."""
    flows = tuple(int(f) for f in flows)
    if not flows:
        raise ValueError("blackhole needs at least one flow index")
    return FaultEvent("blackhole", t, t_end, flows, 1.0)


def straggle_burst(t: float, t_end: Optional[float], prob: float,
                   jobs: Sequence[int] = ()) -> FaultEvent:
    """Additive straggle-probability boost on ``[t, t_end)`` for ``jobs``
    (empty: every job) — a noisy-neighbor / thermal-throttling window."""
    if not 0.0 <= prob <= 1.0:
        raise ValueError(f"straggle_burst prob must be in [0, 1], got {prob}")
    return FaultEvent("straggle", t, t_end, tuple(int(j) for j in jobs),
                      float(prob))


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A compiled schedule: the spec plus its event-table values.

    ``spec`` goes on the config (``dataclasses.replace(cfg, faults=s.spec)``)
    and ``overrides()`` feeds `make_sweep` / a plan's schedule axis — the
    values are plain numpy, so they hash into the point cache key and stack
    onto the batched sweep like any other dynamic leaf.
    """

    spec: FaultSpec
    values: dict                      # leaf name -> np.ndarray event table

    def overrides(self) -> dict:
        return dict(self.values)


def _identity_values(spec: FaultSpec, j: int, m: int, n: int,
                     e: Optional[int] = None) -> dict:
    e = spec.n_events if e is None else e
    values: dict = {"fault_tick": np.zeros((e,), np.int32)}
    if spec.churn:
        values["fault_job_active"] = np.ones((e, j), bool)
    if spec.link_flaps:
        values["fault_link_scale"] = np.ones((e, m), np.float32)
    if spec.blackholes:
        values["fault_blackhole"] = np.zeros((e, n), bool)
    if spec.straggle_bursts:
        values["fault_straggle"] = np.zeros((e, j), np.float32)
    return values


def identity_schedule(cfg, spec: FaultSpec) -> FaultSchedule:
    """The all-no-op schedule for ``spec`` on ``cfg``'s fabric: every row
    fires at tick 0 with identity values, so the simulation runs
    bit-identical to ``faults=None`` (tests/test_torch_faults.py)."""
    return FaultSchedule(spec=spec, values=_identity_values(
        spec, cfg.jobs.n_jobs, cfg.topo.n_links, cfg.topo.n_flows))


def _to_tick(t: float, dt: float) -> int:
    return max(0, int(round(t / dt)))


def schedule(cfg, events: Sequence[FaultEvent], *,
             n_events: Optional[int] = None,
             spec: Optional[FaultSpec] = None) -> FaultSchedule:
    """Compile declarative events into the event table on ``cfg``'s fabric.

    Boundary times (every event start and window end, plus t=0) become the
    table's rows; each row holds the *full* channel state in effect from
    its tick — churn edits forward-fill (persistent), windowed channels
    apply where ``start <= row_tick < end``.  ``n_events`` pads the table
    (repeating the final row) so schedules of different event counts share
    one `FaultSpec` — and therefore one compile group; ``spec`` pins the
    armed channels the same way (channels the events never touch get
    identity columns).
    """
    events = list(events)
    dt, j = cfg.dt, cfg.jobs.n_jobs
    m, n = cfg.topo.n_links, cfg.topo.n_flows
    used = {ev.channel for ev in events}

    for ev in events:
        bound = {"churn": j, "link": m, "blackhole": n, "straggle": j}
        for i in ev.index:
            if not 0 <= i < bound[ev.channel]:
                raise ValueError(
                    f"fault event {ev.channel!r} indexes {i}, but the "
                    f"fabric has {bound[ev.channel]} "
                    f"{'jobs' if ev.channel in ('churn', 'straggle') else ev.channel + 's'}")

    pinned = spec is not None
    if spec is None:
        spec = FaultSpec(
            n_events=1, churn="churn" in used, link_flaps="link" in used,
            blackholes="blackhole" in used,
            straggle_bursts="straggle" in used)   # n_events sized below
    else:
        missing = {c for c in used
                   if not getattr(spec, {"churn": "churn",
                                         "link": "link_flaps",
                                         "blackhole": "blackholes",
                                         "straggle": "straggle_bursts"}[c])}
        if missing:
            raise ValueError(f"schedule uses channel(s) {sorted(missing)} "
                             f"the given FaultSpec does not arm")

    bounds = {0}
    for ev in events:
        bounds.add(_to_tick(ev.t, dt))
        if ev.t_end is not None:
            bounds.add(_to_tick(ev.t_end, dt))
    ticks = sorted(bounds)
    if n_events is None and pinned:
        n_events = spec.n_events      # an explicit spec fixes the row count
    if n_events is not None and len(ticks) > n_events:
        raise ValueError(f"schedule needs {len(ticks)} event rows but "
                         f"n_events={n_events}")
    e_used = len(ticks)
    e_total = (e_used if n_events is None else n_events)
    if spec.n_events != e_total:
        spec = dataclasses.replace(spec, n_events=e_total)

    values = _identity_values(spec, j, m, n, e=e_total)
    tick_col = values["fault_tick"]
    tick_col[:e_used] = ticks
    tick_col[e_used:] = ticks[-1]     # padding rows duplicate the last row

    churn_edits = sorted((ev for ev in events if ev.channel == "churn"),
                         key=lambda ev: _to_tick(ev.t, dt))
    for r, bt in enumerate(ticks):
        for ev in churn_edits:                    # persistent forward-fill
            if _to_tick(ev.t, dt) <= bt:
                values["fault_job_active"][r, list(ev.index)] = bool(ev.value)
        for ev in events:
            if ev.channel == "churn":
                continue
            t0 = _to_tick(ev.t, dt)
            t1 = None if ev.t_end is None else _to_tick(ev.t_end, dt)
            if not (t0 <= bt and (t1 is None or bt < t1)):
                continue
            if ev.channel == "link":              # compose: correlated flaps
                values["fault_link_scale"][r, list(ev.index)] *= ev.value
            elif ev.channel == "blackhole":
                values["fault_blackhole"][r, list(ev.index)] = True
            elif ev.channel == "straggle":
                idx = list(ev.index) if ev.index else slice(None)
                values["fault_straggle"][r, idx] += ev.value
    if spec.straggle_bursts:
        np.clip(values["fault_straggle"], 0.0, 1.0,
                out=values["fault_straggle"])
    for r in range(e_used, e_total):              # padding rows: copy values
        for name in values:
            if name != "fault_tick":
                values[name][r] = values[name][e_used - 1]
    return FaultSchedule(spec=spec, values=values)
