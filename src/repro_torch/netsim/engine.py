"""Fluid network simulation engine, in PyTorch.

One tick steps the whole fabric: job phase machines, flow injection,
store-and-forward link queues with RED/ECN, RTT-delayed ack/loss/CNP
feedback, and the MLTCP-augmented congestion-control update.  A chunked
run loop runs the ticks and records the per-chunk traces the paper's
figures read.  On the card one launch of the chunk kernel
(`kernels.ops.netsim_chunk`, `kernels.netsim_chunk.ChunkRun`) runs a whole
chunk of ticks; the per-tick
loop over `_tick` (`run_chunk_reference`, its CC update through the fused
per-tick kernel behind `kernels.ops.mltcp_cc_tick`) is that kernel's
plain version, the CPU path, and the card's path for the configurations
the chunk kernel does not take (counted in
``kernels.ops.CHUNK_FALLBACK_COUNT``).

Configuration is split as in the reference: `SimConfig` is the static half
(topology, job shapes, algorithm, variant) and `SweepParams` the values a
sweep varies (protocol scalars, RED thresholds, per-job workload values,
Static factors, Cassini schedules, the seed, the ``job_active`` padding
mask).  Every state and sweep tensor carries a leading ``[K]`` axis, in
place of the reference's ``vmap``: one run advances K simulations at once.

Model summary:
  * fluid flows: each tick a flow injects ``min(rate*dt, bytes_left)``;
  * store-and-forward: bytes advance one link per tick; per-link service is
    ``cap*dt`` split proportionally across queued flows (FIFO-fair fluid);
    row M of the [M+1, N] link arrays is the trash row of delivered bytes;
  * RED at enqueue: mark/drop probability ramps between ``red_qmin`` and
    ``red_qmax``; drop mode feeds Reno/CUBIC loss events and retransmits
    the bytes, ECN mode feeds DCQCN CNPs;
  * feedback returns after ``rtt`` via a ring buffer;
  * jobs: a phase program (compute_s, comm_bytes) per iteration, with
    optional stragglers and Cassini-style start-time enforcement.

The tick never reads a tensor back to the host (no ``.item()``, no branch
on a tensor value; the ring pointer stays a tensor).  The random bits do
not depend on the state, so the host draws them a chunk at a time
(`netsim.random`) and ships them in one copy.

Fault injection (``cfg.faults``, `netsim.faults`) and telemetry
(``cfg.telemetry``, `netsim.telemetry`) hook into the tick; every hook is
gated on a python-level ``is not None``, so an unarmed config runs the
code it ran without them.  What a fault row changes depends only on the
tick, so `chunk_inputs` ranks each tick against the schedule's tick column
and ships the current row's churn mask, blackhole mask and flapped
capacity with the chunk's other inputs (the churn mask and the straggle
boost fold into ``started`` and ``straggles`` there).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import favoritism
from repro_torch.core import mltcp as core
from repro_torch.core.cc.types import col
from repro_torch.core.segment import JobGroups, fold_sum
from repro_torch.kernels import netsim_chunk as chunk_kernel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.netsim import counters
from repro_torch.netsim import faults as faults_mod
from repro_torch.netsim import random as rng
from repro_torch.netsim import telemetry as telem
from repro_torch.netsim import tick_graph
from repro_torch.netsim.topology import HashableConfig, Topology

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class JobSpec(HashableConfig):
    """Per-job workload description (numpy, static).

    compute[J, P] seconds and comm_bytes[J, P] bytes define each iteration's
    sub-phase program (P >= 1; unused phases zero-padded with n_phases[J]).
    """

    compute: np.ndarray          # [J, P] seconds
    comm_bytes: np.ndarray       # [J, P] bytes
    n_phases: np.ndarray         # [J] int
    start_offset: np.ndarray     # [J] seconds
    straggle_prob: np.ndarray    # [J] probability per iteration
    iso_iter_time: np.ndarray    # [J] isolation iteration time (s)

    @staticmethod
    def simple(compute_s, comm_bytes, start_offset=None, straggle_prob=None,
               cap_bytes_per_s: float = 50e9 / 8) -> "JobSpec":
        """On/off jobs: one compute phase + one comm phase per iteration."""
        compute_s = np.asarray(compute_s, np.float64)
        comm_bytes_a = np.asarray(comm_bytes, np.float64)
        j = compute_s.shape[0]
        iso = compute_s + comm_bytes_a / cap_bytes_per_s
        return JobSpec(
            compute=compute_s[:, None],
            comm_bytes=comm_bytes_a[:, None],
            n_phases=np.ones((j,), np.int32),
            start_offset=(np.zeros((j,)) if start_offset is None
                          else np.asarray(start_offset, np.float64)),
            straggle_prob=(np.zeros((j,)) if straggle_prob is None
                           else np.asarray(straggle_prob, np.float64)),
            iso_iter_time=iso,
        )

    @property
    def n_jobs(self) -> int:
        return int(self.compute.shape[0])

    @property
    def total_bytes(self) -> np.ndarray:
        """[J] bytes per iteration (Algorithm 1's total_bytes input)."""
        return self.comm_bytes.sum(axis=1)


@dataclasses.dataclass(frozen=True, eq=False)
class CassiniSchedule(HashableConfig):
    """Centralized time-shift baseline [66]: align each job's comm-phase start
    to ``offset + k*period``; a job that deviates by more than ``eps`` is
    delayed to the next slot."""

    offset: np.ndarray           # [J] seconds
    period: np.ndarray           # [J] seconds
    eps: float = 2e-3


@dataclasses.dataclass(frozen=True, eq=False)
class SimConfig(HashableConfig):
    topo: Topology
    jobs: JobSpec
    protocol: core.MLTCPConfig
    sim_time: float = 10.0
    dt: float = 2e-5
    # RED / buffer parameters (per link, bytes)
    red_qmin: float = 150e3
    red_qmax: float = 1.5e6
    red_pmax: float = 0.12
    buffer_bytes: float = 4e6         # taildrop ceiling
    ecn_mode: Optional[bool] = None   # default: True iff DCQCN
    # Static [67] baseline: per-JOB constant aggressiveness factors
    static_job_factors: Optional[np.ndarray] = None
    cassini: Optional[CassiniSchedule] = None
    cubic_epoch_reset_on_comm_start: bool = True
    max_iters_recorded: int = 4096
    n_chunks: int = 400               # trace resolution
    seed: int = 0
    # probes and streaming detectors (netsim.telemetry); None runs none of
    # their code
    telemetry: Optional[telem.TelemetrySpec] = None
    # fault structure (netsim.faults): the schedule's row count and armed
    # channels; its values are SweepParams leaves.  None runs none of the
    # fault code
    faults: Optional[faults_mod.FaultSpec] = None

    @property
    def n_ticks(self) -> int:
        return int(round(self.sim_time / self.dt))

    @property
    def rtt_ticks(self) -> int:
        return max(1, int(round(self.protocol.cc.rtt / self.dt)))

    def is_ecn(self) -> bool:
        if self.ecn_mode is not None:
            return self.ecn_mode
        return self.protocol.cc.algo == int(core.Algo.DCQCN)


# ---------------------------------------------------------------------------
# Sweep axis — the per-point values, each with a leading [K] axis
# ---------------------------------------------------------------------------

class SweepParams(NamedTuple):
    """Per-simulation values, one row per sweep point (leading [K] axis).

    The protocol scalars (Fig. 16's slope/intercept, Algorithm 1's
    g/gamma/INIT_COMM_GAP), the RED thresholds, the seed, the per-job
    workload (phase programs ``compute``/``comm_bytes`` [K, J, P],
    ``straggle_prob``/``iso_iter`` [K, J]), the Static-baseline job factors,
    the padded-jobs mask ``job_active`` [K, J] (masked jobs never start, so
    their flows stay inert) and the Cassini schedule (period <= 0 disables
    it for that job).  The ``fault_*`` leaves are the fault schedule's
    event table (`netsim.faults`; present exactly for the channels
    ``cfg.faults`` arms).  Optional leaves are None when no point needs
    them.
    """

    slope: Tensor
    intercept: Tensor
    g: Tensor
    gamma: Tensor
    init_comm_gap: Tensor
    red_qmin: Tensor
    red_qmax: Tensor
    red_pmax: Tensor
    seed: Tensor                         # int32
    compute: Tensor                      # [K, J, P]
    comm_bytes: Tensor                   # [K, J, P]
    straggle_prob: Tensor                # [K, J]
    iso_iter: Tensor                     # [K, J]
    static_job_factors: Optional[Tensor]  # [K, J]
    job_active: Optional[Tensor] = None   # [K, J] bool
    cassini_offset: Optional[Tensor] = None
    cassini_period: Optional[Tensor] = None
    cassini_eps: Optional[Tensor] = None
    fault_tick: Optional[Tensor] = None        # [K, E] int32 start ticks
    fault_job_active: Optional[Tensor] = None  # [K, E, J] bool churn masks
    fault_link_scale: Optional[Tensor] = None  # [K, E, M] capacity scales
    fault_blackhole: Optional[Tensor] = None   # [K, E, N] bool null routes
    fault_straggle: Optional[Tensor] = None    # [K, E, J] straggle boosts

    def dyn(self) -> core.DynamicParams:
        """The protocol-layer slice, for `core.cc_tick`."""
        return core.DynamicParams(slope=self.slope, intercept=self.intercept,
                                  g=self.g, gamma=self.gamma,
                                  init_comm_gap=self.init_comm_gap)


# the fault schedule's leaves, in field order
FAULT_FIELDS = faults_mod.FIELDS

# per-point (unbatched) rank of each field; the rest are scalars
_POINT_NDIM = {
    "static_job_factors": 1, "job_active": 1,
    "compute": 2, "comm_bytes": 2,
    "straggle_prob": 1, "iso_iter": 1,
    "cassini_offset": 1, "cassini_period": 1,
    "fault_tick": 1, "fault_job_active": 2, "fault_link_scale": 2,
    "fault_blackhole": 2, "fault_straggle": 2,
}
_FIELD_DTYPE = {"seed": torch.int32, "job_active": torch.bool,
                "fault_tick": torch.int32, "fault_job_active": torch.bool,
                "fault_blackhole": torch.bool}


def _point_shape(name: str, cfg: SimConfig) -> tuple[int, ...]:
    if name in FAULT_FIELDS:
        if cfg.faults is None:
            raise ValueError(
                f"sweep field {name!r} needs cfg.faults (a FaultSpec): "
                f"fault schedule values have no meaning on an unfaulted "
                f"config")
        e = cfg.faults.n_events
        return {"fault_tick": (e,),
                "fault_link_scale": (e, cfg.topo.n_links),
                "fault_blackhole": (e, cfg.topo.n_flows)}.get(
                    name, (e, cfg.jobs.n_jobs))
    nd = _POINT_NDIM.get(name, 0)
    if nd == 0:
        return ()
    j, p = cfg.jobs.compute.shape
    return (j,) if nd == 1 else (j, p)


def _unknown_field_error(name: str) -> Exception:
    return ValueError(
        f"unknown sweep field {name!r}: not a SweepParams leaf; valid "
        f"leaves: {', '.join(SweepParams._fields)}")


def _field_tensor(name: str, v, device) -> Tensor:
    dtype = _FIELD_DTYPE.get(name, torch.float32)
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def _point_values(cfg: SimConfig) -> dict:
    """A config's per-point values (numpy / python, unbatched)."""
    p, jobs = cfg.protocol, cfg.jobs
    out = dict(
        slope=p.slope, intercept=p.intercept, g=p.g, gamma=p.gamma,
        init_comm_gap=p.init_comm_gap, red_qmin=cfg.red_qmin,
        red_qmax=cfg.red_qmax, red_pmax=cfg.red_pmax, seed=cfg.seed,
        compute=jobs.compute, comm_bytes=jobs.comm_bytes,
        straggle_prob=jobs.straggle_prob, iso_iter=jobs.iso_iter_time,
        static_job_factors=(None if cfg.static_job_factors is None
                            else np.asarray(cfg.static_job_factors)),
        job_active=None, cassini_offset=None, cassini_period=None,
        cassini_eps=None, **{name: None for name in FAULT_FIELDS})
    if cfg.cassini is not None:
        out.update(cassini_offset=cfg.cassini.offset,
                   cassini_period=cfg.cassini.period,
                   cassini_eps=cfg.cassini.eps)
    if cfg.faults is not None:
        # an armed spec defaults to the identity schedule (exact no-ops);
        # real schedules arrive as make_sweep overrides
        out.update(faults_mod.identity_schedule(cfg, cfg.faults).values)
    return out


def sweep_of(cfg: SimConfig, device=None) -> SweepParams:
    """Lift a config's dynamic values into an unbatched SweepParams (no
    leading [K] axis), on the card unless ``device="cpu"``."""
    dev = device_mod.resolve(device)
    _check_cfg(cfg)
    base = _point_values(cfg)
    return SweepParams(**{
        name: None if base[name] is None
        else _field_tensor(name, base[name], dev)
        for name in SweepParams._fields})


def make_sweep(cfg: SimConfig, device=None, **overrides) -> SweepParams:
    """A [K]-batched SweepParams from a config plus per-field overrides.

    Each override is a scalar (held constant; per-job fields broadcast it
    across the point shape) or a length-K sequence; per-job fields also take
    [J] or [K, J], phase programs [J, P] or [K, J, P].  All length-K
    overrides must agree on K; unswept fields come from the config.
    """
    dev = device_mod.resolve(device)
    _check_cfg(cfg)
    lens = []
    for name, v in overrides.items():
        if name not in SweepParams._fields:
            raise _unknown_field_error(name)
        nd = _POINT_NDIM.get(name, 0)
        a = np.asarray(v.cpu() if isinstance(v, Tensor) else v)
        if a.ndim == nd + 1:
            lens.append(a.shape[0])
        elif a.ndim not in (0, nd):
            raise ValueError(
                f"sweep field {name!r} has shape {a.shape}; expected a "
                f"scalar, the point shape {_point_shape(name, cfg)}, or a "
                f"[K]-leading batch of point shapes")
    k = lens[0] if lens else 1
    if any(l != k for l in lens):
        raise ValueError(f"sweep fields disagree on length: {lens}")
    base = _point_values(cfg)
    out = {}
    for name in SweepParams._fields:
        v = overrides.get(name, base[name])
        if v is None:
            out[name] = None
            continue
        a = _field_tensor(name, v, dev)
        nd = _POINT_NDIM.get(name, 0)
        if a.ndim == 0 and nd > 0:
            a = torch.broadcast_to(a, _point_shape(name, cfg))
        if a.ndim == nd:
            a = torch.broadcast_to(a[None], (k,) + tuple(a.shape))
        out[name] = a.contiguous()
    return SweepParams(**out)


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """Self-describing label for one grid point of a sweep: ``axes`` maps
    axis name -> value, ``params`` the point's K=1 SweepParams, ``n_jobs``
    its active job count on a padded fabric (None: all jobs)."""

    axes: dict
    params: Optional[SweepParams] = None
    n_jobs: Optional[int] = None

    def __getitem__(self, name: str):
        return self.axes[name]

    def get(self, name: str, default=None):
        return self.axes.get(name, default)

    def matches(self, **axis_values) -> bool:
        """True iff every given axis name exists and equals the value."""
        for name, want in axis_values.items():
            if name not in self.axes:
                return False
            have = self.axes[name]
            if isinstance(have, np.ndarray) or isinstance(want, np.ndarray):
                if not np.array_equal(np.asarray(have), np.asarray(want)):
                    return False
            elif have != want:
                return False
        return True

    def label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.axes.items())


def sweep_slice(sweep: SweepParams, i: int) -> SweepParams:
    """The i-th point of a batched SweepParams, as a K=1 sweep."""
    return SweepParams(*[None if v is None else v[i:i + 1] for v in sweep])


def sweep_len(sweep: SweepParams) -> int:
    """K, the number of grid points in a batched SweepParams."""
    return int(sweep.slope.shape[0])


def grid_sweep(cfg: SimConfig, device=None,
               **axes) -> tuple[SweepParams, list[SweepPoint]]:
    """Cartesian-product sweep over the given scalar axes; returns the
    batched SweepParams and one `SweepPoint` per grid point."""
    names = list(axes)
    for n in names:
        if n not in SweepParams._fields:
            raise _unknown_field_error(n)
    grids = np.meshgrid(*[np.asarray(axes[n], np.float64) for n in names],
                        indexing="ij")
    flat = {n: g.reshape(-1) for n, g in zip(names, grids)}
    values = {}
    for n in names:
        nd = _POINT_NDIM.get(n, 0)
        v = flat[n]
        if nd:
            v = np.broadcast_to(v.reshape((-1,) + (1,) * nd),
                                (v.shape[0],) + _point_shape(n, cfg))
        values[n] = v
    sweep = make_sweep(cfg, device=device, **values)
    n_jobs = cfg.jobs.n_jobs
    k = sweep_len(sweep)
    points = [SweepPoint(axes={n: flat[n][i].item() for n in names},
                         params=sweep_slice(sweep, i), n_jobs=n_jobs)
              for i in range(k)] if names else \
        [SweepPoint(axes={}, params=sweep_slice(sweep, 0), n_jobs=n_jobs)]
    return sweep, points


# ---------------------------------------------------------------------------
# Engine state
# ---------------------------------------------------------------------------

class EngineState(NamedTuple):
    proto: core.MLTCPState
    backlog: Tensor       # [K, M+1, N] queued bytes (row M = trash)
    transit: Tensor       # [K, M+1, N] bytes arriving next tick
    ring_del: Tensor      # [K, D, N] delivered bytes (feedback delay line)
    ring_loss: Tensor     # [K, D, N] bool
    ring_cnp: Tensor      # [K, D, N] bool
    ring_ptr: Tensor      # [K] int32
    to_send: Tensor       # [K, N] bytes not yet injected (this sub-phase)
    to_deliver: Tensor    # [K, N] bytes not yet delivered
    comm_start: Tensor    # [K, N] time current comm sub-phase started
    phase_idx: Tensor     # [K, J] int32
    in_comm: Tensor       # [K, J] bool
    t_rem: Tensor         # [K, J] remaining compute seconds
    iter_idx: Tensor      # [K, J] int32
    iter_start: Tensor    # [K, J]
    hold_until: Tensor    # [K, J]
    iter_times: Tensor    # [K, J, MAX_ITERS]
    straggle_extra: Tensor  # [K, J] sampled straggle time, this iteration
    key: np.ndarray       # [K, 2] uint32 threefry key (host: netsim.random)
    tick: Tensor          # [K] int32
    # accumulators for trace chunks
    acc_util: Tensor      # [K, M]
    acc_drops: Tensor     # [K] (packets)
    acc_marks: Tensor     # [K] (packets)
    acc_jobbytes: Tensor  # [K, J] delivered bytes per job
    # probe ring buffers and detector state when cfg.telemetry arms them
    telemetry: Optional[telem.TelemetryState] = None


class TickStatics(NamedTuple):
    """Device-resident structural arrays (routing, fan-out, phase counts)."""

    cap: Tensor           # [M]
    cap_dt: Tensor        # [M] cap * dt, the float32 product the tick uses
    first_hot: Tensor     # [M+1, N] 1.0 at each flow's first link
    last_link: Tensor     # [1, 1, N] long: each flow's last link
    is_final: Tensor      # [M+1, N] bool: next_link == M (delivered)
    prev_link: Tensor     # [M+1, N] long: the link before l on n's path (M: none)
    ring_slots: Tensor    # [1, D, 1] long: the feedback ring's slot ids
    groups: JobGroups     # flow -> job, members per job
    spj_inv: Tensor       # [N] 1/flows-in-job
    flows_per_job: Tensor  # [J] float32 count
    last_phase: Tensor    # [J] int32: n_phases - 1
    start_offset: Tensor  # [J]
    mss: Tensor           # 0-dim float32 divisor (a true division on the card)
    # the interleave detector's job pairs (a < b), when telemetry arms it
    pairs: Optional[tuple[Tensor, Tensor]] = None


def _build_statics(cfg: SimConfig, device) -> TickStatics:
    topo, jobs = cfg.topo, cfg.jobs
    M, N = topo.n_links, topo.n_flows
    first_hot = np.zeros((M + 1, N), np.float32)
    last_link = np.zeros((N,), np.int64)
    nxt = np.full((M + 1, N), M, np.int64)
    prev = np.full((M + 1, N), M, np.int64)
    for n in range(N):
        path = [int(l) for l in topo.hops[n] if l >= 0]
        if not path or len(set(path)) != len(path):
            raise ValueError(f"flow {n} has path {path}: every flow needs a "
                             f"non-empty path without repeated links")
        first_hot[path[0], n] = 1.0
        last_link[n] = path[-1]
        for i, l in enumerate(path):
            if i + 1 < len(path):
                nxt[l, n] = path[i + 1]
                prev[path[i + 1], n] = l
    f2j = topo.flow_to_job.astype(np.int64)
    spj = np.bincount(f2j, minlength=jobs.n_jobs).astype(np.float64)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    cap = dev(topo.cap, torch.float32)
    return TickStatics(
        cap=cap,
        cap_dt=cap * cfg.dt,
        first_hot=dev(first_hot),
        last_link=dev(last_link).view(1, 1, N),
        is_final=dev(nxt == M),
        prev_link=dev(prev),
        ring_slots=torch.arange(cfg.rtt_ticks, device=device).view(1, -1, 1),
        groups=JobGroups.build(f2j, jobs.n_jobs, device),
        spj_inv=dev(1.0 / spj[f2j], torch.float32),
        flows_per_job=dev(spj, torch.float32),
        last_phase=dev(np.asarray(jobs.n_phases) - 1, torch.int32),
        start_offset=dev(jobs.start_offset, torch.float32),
        mss=torch.tensor(cfg.protocol.cc.mss, dtype=torch.float32,
                         device=device),
        pairs=(telem.job_pairs(jobs.n_jobs, device)
               if cfg.telemetry is not None
               and cfg.telemetry.needs_interleave() else None),
    )


class _WorkloadView(NamedTuple):
    """Per-run values derived from the sweep (constant over the ticks)."""

    flow_total: Tensor       # [K, N] Algorithm 1 total_bytes per flow
    flow_period: Tensor      # [K, N] nominal iteration period (normalizer)
    static_factors: Optional[Tensor]  # [K, N]
    dyn: core.DynamicParams
    red_qmin: Tensor         # [K, 1] RED ramp, as columns over the links
    red_qmax: Tensor
    red_span: Tensor         # qmax - qmin
    red_pmax: Tensor
    red_rest: Tensor         # 1 - pmax
    zero_col: Tensor         # [K, 1] zeros: the trash row's entry


def _workload_view(cfg: SimConfig, statics: TickStatics,
                   sweep: SweepParams) -> _WorkloadView:
    g = statics.groups
    total = fold_sum(sweep.comm_bytes, -1)
    # 1/cap.min() folds to a python float, as in the reference
    inv_cap = float(1.0 / np.asarray(cfg.topo.cap, np.float64).min())
    period = fold_sum(sweep.compute, -1) + total * inv_cap
    total_f = g.spread(total)
    flow_total = (total_f if cfg.protocol.aggregate_by_job
                  else total_f * statics.spj_inv)
    factors = (None if sweep.static_job_factors is None
               else g.spread(sweep.static_job_factors).contiguous())
    qmin, qmax, pmax = (col(sweep.red_qmin), col(sweep.red_qmax),
                        col(sweep.red_pmax))
    return _WorkloadView(flow_total=flow_total.contiguous(),
                         flow_period=g.spread(period),
                         static_factors=factors, dyn=sweep.dyn(),
                         red_qmin=qmin, red_qmax=qmax, red_span=qmax - qmin,
                         red_pmax=pmax, red_rest=1.0 - pmax,
                         zero_col=torch.zeros_like(qmin))


def _init_state(cfg: SimConfig, statics: TickStatics,
                sweep: SweepParams) -> EngineState:
    topo, jobs = cfg.topo, cfg.jobs
    M, N, J = topo.n_links, topo.n_flows, jobs.n_jobs
    K = sweep_len(sweep)
    D = cfg.rtt_ticks
    dev = statics.cap.device

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EngineState(
        proto=core.init_state(N, cfg.protocol, dyn=sweep.dyn(), k=K,
                              device=dev),
        backlog=z(K, M + 1, N), transit=z(K, M + 1, N),
        ring_del=z(K, D, N), ring_loss=z(K, D, N, dtype=torch.bool),
        ring_cnp=z(K, D, N, dtype=torch.bool),
        ring_ptr=z(K, dtype=torch.int32),
        to_send=z(K, N), to_deliver=z(K, N), comm_start=z(K, N),
        phase_idx=z(K, J, dtype=torch.int32),
        in_comm=z(K, J, dtype=torch.bool),
        t_rem=sweep.compute[:, :, 0].clone(),  # start in compute of phase 0
        iter_idx=z(K, J, dtype=torch.int32),
        iter_start=statics.start_offset.expand(K, J).clone(),
        hold_until=z(K, J),
        iter_times=torch.full((K, J, cfg.max_iters_recorded), float("nan"),
                              dtype=torch.float32, device=dev),
        straggle_extra=z(K, J),
        key=rng.prng_key(sweep.seed.cpu().numpy()),
        tick=z(K, dtype=torch.int32),
        acc_util=z(K, M), acc_drops=z(K), acc_marks=z(K), acc_jobbytes=z(K, J),
        telemetry=(None if cfg.telemetry is None
                   else telem.init_state(cfg, cfg.telemetry, K, dev)),
    )


# ---------------------------------------------------------------------------
# One tick
# ---------------------------------------------------------------------------

class TickInputs(NamedTuple):
    """What a tick needs that does not depend on the simulation state: its
    time, which jobs have started, its random draws (`netsim.random`) with
    the straggler decisions they imply, and the current fault row.
    `chunk_inputs` computes them for a chunk of ticks at once, each leaf
    with a leading [T]; `at` picks one tick's.  The fault leaves are None
    unless ``cfg.faults`` arms their channel."""

    key: np.ndarray       # [K, 2] the key after this tick (host)
    t: Tensor             # [K] tick * dt
    started: Tensor       # [K, J] bool (padding and churn folded in)
    loss_u: Tensor        # [K, N] loss-event uniforms
    cnp_u: Tensor         # [K, N] CNP uniforms
    straggles: Tensor     # [K, J] bool: a finishing iteration straggles
    strag_amt: Tensor     # [K, J] its extra compute time (s)
    fault_idx: Optional[Tensor] = None  # [K] int32 current event row
    churn: Optional[Tensor] = None      # [K, J] bool: the job is present
    blackhole: Optional[Tensor] = None  # [K, N] bool: null-routed flows
    cap_dt: Optional[Tensor] = None     # [K, M] (cap * link scale) * dt

    def at(self, i: int) -> "TickInputs":
        return TickInputs(*(None if x is None else x[i] for x in self))


def chunk_inputs(cfg: SimConfig, statics: TickStatics, sweep: SweepParams,
                 st: EngineState, n_ticks: int,
                 log: Optional[counters.SpanLog] = None) -> TickInputs:
    """The inputs of the ``n_ticks`` ticks that follow state ``st`` (of
    which only ``key`` and ``tick`` are read, so a packed run,
    `kernels.netsim_chunk.ChunkRun`, stands in for it): the
    draws come from the host in one copy (for the card, the kernel
    library's C version of `netsim.random.chunk_draws`, the same bits,
    straight into pinned memory), the rest is a handful of ops for the
    whole chunk instead of per tick.  ``log`` records the ``draws`` span
    (`counters`)."""
    dev = statics.cap.device
    n, j = cfg.topo.n_flows, cfg.jobs.n_jobs
    draw = chunk_kernel.host_draws if dev.type == "cuda" else rng.chunk_draws
    if log is not None:
        draw = counters.timed(log, "draws", draw, n_ticks)
    if dev.type == "cuda":
        host = torch.empty((n_ticks, st.key.shape[0], 2 * n + 2 * j),
                           dtype=torch.float32, pin_memory=True)
        keys = draw(st.key, n_ticks, n, j, host)
    else:
        d = draw(st.key, n_ticks, n, j)
        keys = d.keys
        host = torch.from_numpy(
            np.concatenate((d.loss, d.cnp, d.strag, d.samt), axis=-1))
    u = host.to(dev, non_blocking=True)
    loss_u, cnp_u, strag_u, samt_u = torch.split(u, [n, n, j, j], dim=-1)
    steps = torch.arange(n_ticks, dtype=torch.int32, device=dev)
    ticks = st.tick + steps.unsqueeze(-1)                        # [T, K]
    t = ticks.to(torch.float32) * cfg.dt
    started = t.unsqueeze(-1) >= statics.start_offset
    if sweep.job_active is not None:
        # padded-jobs axis: masked-off jobs never start
        started = started & sweep.job_active
    strag_p = sweep.straggle_prob
    fault = {}
    spec = cfg.faults
    if spec is not None:
        # the current event row of each tick: a rank over the tick column
        # (rows sorted; row 0 is the identity baseline at tick 0)
        rank = (sweep.fault_tick.unsqueeze(0) <= ticks.unsqueeze(-1)).sum(-1)
        idx = torch.clamp(rank - 1, 0, spec.n_events - 1)        # [T, K]
        points = torch.arange(idx.shape[1], device=dev)

        def row(table):
            return table[points, idx]                            # [T, K, X]

        fault["fault_idx"] = idx.to(torch.int32)
        if spec.churn:
            # a departed job's compute clock freezes and its comm phase is
            # force-exited (`_tick`); the identity row is all True
            fault["churn"] = row(sweep.fault_job_active)
            started = started & fault["churn"]
        if spec.blackholes:
            fault["blackhole"] = row(sweep.fault_blackhole)
        if spec.link_flaps:
            # a flap scales the service capacity only (acc_util keeps the
            # nominal one); the identity row is all 1.0
            fault["cap_dt"] = (statics.cap * row(sweep.fault_link_scale)
                               ) * cfg.dt
        if spec.straggle_bursts:
            # an additive boost, clipped back to a probability
            strag_p = torch.clamp(strag_p + row(sweep.fault_straggle),
                                  0.0, 1.0)
    return TickInputs(
        key=keys, t=t, started=started, loss_u=loss_u, cnp_u=cnp_u,
        straggles=strag_u < strag_p,
        strag_amt=(0.05 + 0.05 * samt_u) * sweep.iso_iter, **fault)


def _red_prob(wl: _WorkloadView, q: Tensor) -> Tensor:
    """Gentle RED: 0 -> pmax on [qmin, qmax], pmax -> 1 on [qmax, 2*qmax]."""
    ramp1 = torch.clamp((q - wl.red_qmin) / wl.red_span, 0.0, 1.0) \
        * wl.red_pmax
    ramp2 = torch.clamp((q - wl.red_qmax) / wl.red_qmax, 0.0, 1.0) \
        * wl.red_rest
    return ramp1 + ramp2


def _tick(cfg: SimConfig, statics: TickStatics, sweep: SweepParams,
          wl: _WorkloadView, st: EngineState,
          inp: TickInputs) -> EngineState:
    dt = cfg.dt
    t = inp.t                                   # [K]
    tc = col(t)
    M = cfg.topo.n_links
    g = statics.groups
    K = t.shape[0]

    # ------------------------------------------------------------------
    # 1. Job phase machine: compute countdown -> comm-phase entry
    # ------------------------------------------------------------------
    running = ~st.in_comm & inp.started
    t_rem = torch.where(running, st.t_rem - dt, st.t_rem)
    compute_done = running & (t_rem <= 0.0)

    if sweep.cassini_period is not None:
        # Cassini agent: comm may only start on its slot grid (+/- eps);
        # period <= 0 disables the agent for that job
        on = sweep.cassini_period > 0.0
        per = torch.clamp_min(sweep.cassini_period, 1e-6)
        off = sweep.cassini_offset
        k_slot = torch.ceil((tc - off) / per)
        next_slot = off + k_slot * per
        near = torch.abs(torch.round((tc - off) / per) * per + off - tc) \
            <= col(sweep.cassini_eps)
        hold = torch.where(compute_done & on & ~near & (st.hold_until <= tc),
                           next_slot, st.hold_until)
        enter_comm = compute_done & (~on | near | (tc >= hold))
        hold_until = hold
    else:
        enter_comm = compute_done
        hold_until = st.hold_until

    in_comm = st.in_comm | enter_comm
    if inp.churn is not None:
        in_comm = in_comm & inp.churn

    # flows of entering jobs pick up their sub-phase quota
    phase_bytes_job = sweep.comm_bytes.gather(
        2, st.phase_idx.long().unsqueeze(-1)).squeeze(-1)        # [K, J]
    enter_f = g.spread(enter_comm)
    quota_f = g.spread(phase_bytes_job) * statics.spj_inv
    to_send = torch.where(enter_f, quota_f, st.to_send)
    to_deliver = torch.where(enter_f, quota_f, st.to_deliver)
    comm_start = torch.where(enter_f, tc, st.comm_start)

    # ------------------------------------------------------------------
    # 2. Injection at current CC rate
    # ------------------------------------------------------------------
    rate = core.send_rate(cfg.protocol.cc, st.proto.cc)          # [K, N]
    active = g.spread(in_comm) & (to_send > 0.0)
    inj = torch.where(active, torch.minimum(rate * dt, to_send), 0.0)
    to_send = to_send - inj
    inj_lost = None
    if inp.blackhole is not None:
        # blackholed flows are null-routed at the first hop: their injected
        # bytes vanish as drops (loss-signaled one RTT later, retransmitted
        # when the hole closes); the identity row is all False
        inj_lost = torch.where(inp.blackhole, inj, 0.0)
        inj = inj - inj_lost

    # ------------------------------------------------------------------
    # 3. Links: enqueue (RED) -> serve -> route departures
    # ------------------------------------------------------------------
    # each flow's injection lands on its first link; every other entry adds
    # an exact 0.0 (row M, the trash row, stays 0 as the tick keeps it)
    incoming = st.transit + statics.first_hot * inj.unsqueeze(1)

    q_len = fold_sum(st.backlog[:, :M], 2)                       # [K, M]
    p_red = _red_prob(wl, q_len)                                 # [K, M]
    p_full = torch.cat([p_red, wl.zero_col], dim=1).unsqueeze(-1)
    # taildrop on buffer overflow (both modes)
    overflow = torch.cat([(q_len >= cfg.buffer_bytes).to(torch.float32),
                          wl.zero_col], dim=1).unsqueeze(-1)

    ecn = cfg.is_ecn()
    if ecn:
        marked = incoming * p_full
        drop_frac = overflow
    else:
        drop_frac = torch.clamp_max(p_full + overflow, 1.0)

    dropped = incoming * drop_frac
    backlog = st.backlog + (incoming - dropped)

    tot = fold_sum(backlog[:, :M], 2)
    cap_dt = statics.cap_dt if inp.cap_dt is None else inp.cap_dt
    serve_ratio = torch.where(
        tot > 0.0,
        torch.clamp_max(cap_dt / torch.clamp_min(tot, 1e-9), 1.0),
        0.0)
    serve_full = torch.cat([serve_ratio, wl.zero_col], dim=1).unsqueeze(-1)
    dep = backlog * serve_full
    # row M: the trash row holds 0 - 0 = 0, as the reference's reset keeps it
    backlog = backlog - dep

    # route departures: a flow's bytes leave the fabric at its last link
    # (every other row of `dep * is_final` is an exact 0.0); the rest move
    # to the next link, whose one predecessor on the path is prev_link
    delivered = dep.gather(1, statics.last_link.expand(K, -1, -1)
                           ).squeeze(1)                          # [K, N]
    fwd = dep * ~statics.is_final
    transit = fwd.gather(1, statics.prev_link.expand(K, -1, -1))

    # per-flow drop / mark signals (row M holds no bytes)
    dropped_f = fold_sum(dropped[:, :M], 1)                      # [K, N]
    if inj_lost is not None:
        dropped_f = dropped_f + inj_lost       # blackholed first-hop bytes
    loss_evt = inp.loss_u < -torch.expm1(-dropped_f / statics.mss)
    if ecn:
        marked_f = fold_sum(marked[:, :M], 1)
        cnp_evt = inp.cnp_u < -torch.expm1(-marked_f / statics.mss)
    else:
        # nothing is marked: u < -expm1(-0) = -0.0 never holds
        cnp_evt = torch.zeros_like(loss_evt)
    # dropped bytes must be retransmitted
    to_send = to_send + dropped_f

    # ------------------------------------------------------------------
    # 4. Feedback delay line (acks/loss/CNP arrive one RTT later)
    # ------------------------------------------------------------------
    # read slot ptr of each point's ring, then write this tick's signals
    # into it (an exact select, no scatter)
    ptr = st.ring_ptr.long().view(K, 1, 1)
    read = ptr.expand(K, 1, cfg.topo.n_flows)
    fb_del = st.ring_del.gather(1, read).squeeze(1)
    fb_loss = st.ring_loss.gather(1, read).squeeze(1)
    fb_cnp = st.ring_cnp.gather(1, read).squeeze(1)
    slot = statics.ring_slots == ptr                             # [K, D, 1]
    ring_del = torch.where(slot, delivered.unsqueeze(1), st.ring_del)
    ring_loss = torch.where(slot, loss_evt.unsqueeze(1), st.ring_loss)
    ring_cnp = torch.where(slot, cnp_evt.unsqueeze(1), st.ring_cnp)
    ring_ptr = torch.remainder(st.ring_ptr + 1, cfg.rtt_ticks)

    # ------------------------------------------------------------------
    # 5. Byte accounting & comm-phase completion
    # ------------------------------------------------------------------
    to_deliver = torch.clamp_min(to_deliver - delivered, 0.0)
    flow_done = (to_deliver <= 0.5 * cfg.protocol.cc.mss).to(torch.int32)
    job_all_done = g.min(flow_done, 1) > 0
    comm_done = in_comm & job_all_done

    last_phase = st.phase_idx >= statics.last_phase
    iter_done = comm_done & last_phase
    phase_idx = torch.where(comm_done,
                            torch.where(last_phase, 0, st.phase_idx + 1),
                            st.phase_idx)
    in_comm = in_comm & ~comm_done

    # iteration bookkeeping + straggler sampling for the next iteration
    iter_time = tc - st.iter_start
    slot = torch.clamp_max(st.iter_idx, cfg.max_iters_recorded - 1) \
        .long().unsqueeze(-1)
    old = st.iter_times.gather(2, slot)
    iter_times = st.iter_times.scatter(
        2, slot, torch.where(iter_done.unsqueeze(-1),
                             iter_time.unsqueeze(-1), old))
    iter_idx = st.iter_idx + iter_done.to(torch.int32)
    iter_start = torch.where(iter_done, tc, st.iter_start)

    straggle_extra = torch.where(
        iter_done, torch.where(inp.straggles, inp.strag_amt, 0.0),
        st.straggle_extra)

    next_compute = sweep.compute.gather(
        2, phase_idx.long().unsqueeze(-1)).squeeze(-1)
    t_rem = torch.where(
        comm_done,
        next_compute + torch.where(iter_done, straggle_extra, 0.0), t_rem)

    # ------------------------------------------------------------------
    # 6. Protocol update (MLTCP / baselines) on delayed feedback
    # ------------------------------------------------------------------
    fb = core.Feedback(num_acks=fb_del / statics.mss, loss=fb_loss,
                       cnp=fb_cnp, now=t)
    comm_elapsed = est_finish = None
    proto_cfg = cfg.protocol
    if (proto_cfg.cc.variant != int(core.Variant.OFF)
            and proto_cfg.favoritism in favoritism.TIME_BASED):
        comm_elapsed = torch.clamp((tc - comm_start) / wl.flow_period,
                                   0.0, 1.0)
        est_finish = torch.clamp(
            to_deliver / torch.clamp_min(rate, 1.0) / wl.flow_period,
            0.0, 1.0)
    proto, _ = kernel_ops.mltcp_cc_tick(
        proto_cfg, st.proto, fb, wl.flow_total,
        flow_to_job=g, n_jobs=g.n_jobs,
        static_factors=wl.static_factors,
        comm_elapsed=comm_elapsed, est_finish=est_finish, dyn=wl.dyn)

    # CUBIC epoch reset on comm start (idle handling)
    if (cfg.cubic_epoch_reset_on_comm_start
            and proto_cfg.cc.algo == int(core.Algo.CUBIC)):
        cc = proto.cc._replace(
            epoch_start=torch.where(enter_f, tc, proto.cc.epoch_start),
            w_max=torch.where(enter_f, proto.cc.cwnd, proto.cc.w_max))
        proto = proto._replace(cc=cc)

    # ------------------------------------------------------------------
    # 7. Trace accumulators
    # ------------------------------------------------------------------
    acc_util = st.acc_util + fold_sum(dep[:, :M], 2) / statics.cap_dt
    acc_drops = st.acc_drops + fold_sum(dropped_f, 1) / statics.mss
    acc_marks = st.acc_marks
    if ecn:
        acc_marks = acc_marks + fold_sum(marked_f, 1) / statics.mss
    acc_jobbytes = g.sum(delivered, init=st.acc_jobbytes)

    # ------------------------------------------------------------------
    # 8. Telemetry probes + streaming detectors
    # ------------------------------------------------------------------
    tstate = st.telemetry
    if cfg.telemetry is not None:
        spec = cfg.telemetry
        f_job = None
        if spec.wants("job_f"):
            # F of the post-update detection state, averaged per job
            f_flow = core.f_values(proto_cfg, proto.det, comm_elapsed,
                                   est_finish, wl.dyn,
                                   static_factors=wl.static_factors)
            f_job = g.sum(f_flow * statics.spj_inv)
        # a churned-out job leaves the interleave statistic like a
        # padded-out one
        telem_active = sweep.job_active
        if inp.churn is not None:
            telem_active = (inp.churn if telem_active is None
                            else telem_active & inp.churn)
        sig = telem.TickSignals(
            tick=st.tick, t=t, cwnd=proto.cc.cwnd, rate=rate,
            bytes_ratio=proto.det.bytes_ratio, q_len=q_len, red_prob=p_red,
            in_comm=in_comm, phase_idx=phase_idx, iter_idx=iter_idx,
            iter_done=iter_done, iter_time=iter_time, f_job=f_job,
            job_active=telem_active, fault_idx=inp.fault_idx,
            fault_ticks=sweep.fault_tick)
        tstate = telem.tick_update(cfg, spec, st.telemetry, sig,
                                   pairs=statics.pairs)

    return EngineState(
        proto=proto, backlog=backlog, transit=transit,
        ring_del=ring_del, ring_loss=ring_loss, ring_cnp=ring_cnp,
        ring_ptr=ring_ptr,
        to_send=to_send, to_deliver=to_deliver, comm_start=comm_start,
        phase_idx=phase_idx, in_comm=in_comm, t_rem=t_rem,
        iter_idx=iter_idx, iter_start=iter_start, hold_until=hold_until,
        iter_times=iter_times, straggle_extra=straggle_extra,
        key=inp.key, tick=st.tick + 1,
        acc_util=acc_util, acc_drops=acc_drops, acc_marks=acc_marks,
        acc_jobbytes=acc_jobbytes, telemetry=tstate)


# ---------------------------------------------------------------------------
# Run loop
# ---------------------------------------------------------------------------

class RawSimOutput(NamedTuple):
    iter_times: Tensor    # [K, J, MAX_ITERS] seconds (nan where unset)
    iter_counts: Tensor   # [K, J]
    trace_util: Tensor    # [K, n_chunks, M] mean utilization per chunk
    trace_drops: Tensor   # [K, n_chunks] packets per chunk
    trace_marks: Tensor   # [K, n_chunks]
    trace_incomm: Tensor  # [K, n_chunks, J] bool snapshot
    trace_t: Tensor       # [K, n_chunks] chunk end times
    trace_jobtput: Tensor  # [K, n_chunks, J] delivered bytes/s per job
    trace_ratio: Tensor   # [K, n_chunks, J] mean bytes_ratio per job
    final_state: EngineState
    # the final TelemetryState when cfg.telemetry arms it
    telemetry: Optional[telem.TelemetryState] = None


CHUNK_FIELDS = ("trace_util", "trace_drops", "trace_marks", "trace_incomm",
                "trace_t", "trace_jobtput", "trace_ratio")


def _chunk_probes(cfg: SimConfig, statics: TickStatics, st: EngineState,
                  ticks_per_chunk: int) -> tuple:
    """The per-chunk trace outputs, in CHUNK_FIELDS order: the built-in
    chunk probes (`telemetry.CHUNK_PROBES`)."""
    return telem.chunk_capture(cfg, statics, st, ticks_per_chunk)


def _check_cfg(cfg: SimConfig) -> None:
    for name, kind in (("telemetry", telem.TelemetrySpec),
                       ("faults", faults_mod.FaultSpec)):
        value = getattr(cfg, name)
        if value is not None and not isinstance(value, kind):
            raise TypeError(f"SimConfig.{name} must be a {kind.__name__} "
                            f"or None, not {type(value).__name__}")
    if abs(cfg.protocol.cc.tick_dt - cfg.dt) > 1e-12:
        raise ValueError(
            f"protocol.cc.tick_dt ({cfg.protocol.cc.tick_dt}) must equal the "
            f"simulator dt ({cfg.dt}); build CCParams with tick_dt=dt")


def _validate_sweep(cfg: SimConfig, sweep: SweepParams) -> None:
    _check_cfg(cfg)
    if sweep.slope.ndim != 1:
        raise ValueError("sweep needs a leading [K] axis on every field "
                         "(use make_sweep / grid_sweep)")
    k = sweep_len(sweep)
    dev = sweep.slope.device
    for name in SweepParams._fields:
        v = getattr(sweep, name)
        if v is None:
            continue
        want = (k,) + _point_shape(name, cfg)
        if tuple(v.shape) != want:
            raise ValueError(f"sweep field {name!r} has shape "
                             f"{tuple(v.shape)}; expected {want}")
        if v.device != dev:
            raise ValueError(f"sweep field {name!r} is on {v.device}, the "
                             f"sweep on {dev}")
    cas = (sweep.cassini_offset, sweep.cassini_period, sweep.cassini_eps)
    if any(c is not None for c in cas) and any(c is None for c in cas):
        raise ValueError("cassini_offset / cassini_period / cassini_eps "
                         "must be set together (or all None)")
    required = () if cfg.faults is None else cfg.faults.leaves()
    for name in FAULT_FIELDS:
        v = getattr(sweep, name)
        if name in required and v is None:
            raise ValueError(
                f"cfg.faults arms {name!r} but the sweep leaf is None "
                f"(use faults.schedule / faults.identity_schedule)")
        if name not in required and v is not None:
            raise ValueError(
                f"sweep carries {name!r} but cfg.faults "
                f"{'is None' if cfg.faults is None else 'does not arm it'}")


def run_chunk_reference(cfg: SimConfig, statics: TickStatics,
                        sweep: SweepParams, wl: _WorkloadView,
                        st: EngineState, inputs: TickInputs
                        ) -> tuple[EngineState, tuple]:
    """One chunk as the per-tick loop: the accumulators start at 0, each of
    the chunk's ticks runs `_tick`, and the chunk's probes are read
    (CHUNK_FIELDS order).  The chunk kernel's plain version."""
    st = st._replace(acc_util=torch.zeros_like(st.acc_util),
                     acc_drops=torch.zeros_like(st.acc_drops),
                     acc_marks=torch.zeros_like(st.acc_marks),
                     acc_jobbytes=torch.zeros_like(st.acc_jobbytes))
    n_ticks = int(inputs.t.shape[0])
    for i in range(n_ticks):
        st = _tick(cfg, statics, sweep, wl, st, inputs.at(i))
    return st, _chunk_probes(cfg, statics, st, n_ticks)


# Runs of `run_ticks` this process: one per `simulate_sweep` call, the
# port's counterpart of the reference's sweep-program traces
# (`netsim.counters.traces`).
RUN_COUNT = 0


def run_ticks(cfg: SimConfig, sweep: SweepParams,
              per_tick: bool = False, eager: bool = False) -> RawSimOutput:
    """The chunked run loop: ``n_chunks`` chunks of ticks, recording the
    chunk traces after each (the reference's scan of scans).  On the card
    each chunk is one launch of the chunk kernel (`ChunkRun`, from
    `kernels.ops.netsim_chunk`); with ``per_tick``, on the CPU, and for the
    configurations the kernel does not take (counted there), each chunk
    runs `run_chunk_reference`: on the card as one replay of its CUDA
    graph (`tick_graph.TickGraph`), but where `tick_graph.eager_reason`
    keeps the eager loop (counted there) or ``eager`` asks for it (the
    graph's plain version, for the card's comparisons).  Nothing in the
    loop reads back to the host, so the host draws the next chunk's inputs
    while the card runs the last."""
    log = counters.recording()
    return _run_ticks(cfg, sweep, log,
                      -1 if log is None else log.begin("setup"),
                      per_tick, eager)


def _run_ticks(cfg: SimConfig, sweep: SweepParams,
               log: Optional[counters.SpanLog], setup: int,
               per_tick: bool = False, eager: bool = False) -> RawSimOutput:
    """`run_ticks` after its check for a span log: ``setup`` is the open
    ``setup`` span, which closes where the chunk loop starts."""
    global RUN_COUNT
    RUN_COUNT += 1
    dev = sweep.slope.device
    statics = _build_statics(cfg, dev)
    st = _init_state(cfg, statics, sweep)
    wl = _workload_view(cfg, statics, sweep)
    ticks_per_chunk = max(1, cfg.n_ticks // cfg.n_chunks)
    n_chunks = cfg.n_ticks // ticks_per_chunk
    chunks = (None if per_tick or eager
              else kernel_ops.netsim_chunk(cfg, statics, sweep, wl, st,
                                           n_chunks))
    graph = (None if chunks is not None or eager
             else tick_graph.runner(cfg, statics, sweep, wl, st))
    inputs_of, run_chunk = chunk_inputs, (
        chunks.step if chunks is not None
        else graph.step if graph is not None else run_chunk_reference)
    if log is not None:
        log.end(setup)
        inputs_of = counters.timed(log, "chunk_inputs", inputs_of,
                                   ticks_per_chunk)
        run_chunk = counters.timed(log, "run_chunk", run_chunk,
                                   ticks_per_chunk)
        loop = log.begin("loop", n_chunks * ticks_per_chunk)
    if chunks is not None:
        # the card's main path: the state stays packed between chunks and
        # the kernel writes the traces
        for _ in range(n_chunks):
            run_chunk(inputs_of(cfg, statics, sweep, chunks,
                                ticks_per_chunk, log))
    else:
        traces = []
        for _ in range(n_chunks):
            if graph is not None:
                # the state stays in the graph's static buffers
                traces.append(run_chunk(inputs_of(
                    cfg, statics, sweep, graph, ticks_per_chunk, log)))
            else:
                inputs = inputs_of(cfg, statics, sweep, st, ticks_per_chunk,
                                   log)
                st, probes = run_chunk(cfg, statics, sweep, wl, st, inputs)
                traces.append(probes)
    if log is not None:
        log.end(loop)
    if chunks is not None:
        st, stacked = chunks.state(), list(chunks.traces)
    else:
        if graph is not None:
            st = graph.state()
        stacked = [torch.stack(col_, dim=1) for col_ in zip(*traces)]
    return RawSimOutput(iter_times=st.iter_times, iter_counts=st.iter_idx,
                        **dict(zip(CHUNK_FIELDS, stacked)), final_state=st,
                        telemetry=st.telemetry)


def simulate_sweep(cfg: SimConfig, sweep: SweepParams,
                   device=None) -> RawSimOutput:
    """Run K simulations batched over the sweep axis, on the card unless
    ``device="cpu"`` (the sweep's tensors move there).  Every leaf of the
    returned RawSimOutput has a leading [K] axis (postprocess with
    `metrics.postprocess_sweep`)."""
    log = counters.recording()
    setup = -1 if log is None else log.begin("setup")
    dev = device_mod.resolve(device)
    sweep = SweepParams(*[None if v is None else v.to(dev) for v in sweep])
    _validate_sweep(cfg, sweep)
    return _run_ticks(cfg, sweep, log, setup)


def tree_map(fn, tree):
    """``fn`` on every tensor or array of a tree of NamedTuples, dicts and
    Nones (a RawSimOutput, an EngineState)."""
    if tree is None:
        return None
    if isinstance(tree, (Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {name: tree_map(fn, v) for name, v in tree.items()}
    return type(tree)(*[tree_map(fn, v) for v in tree])


def point_of(tree, i: int):
    """Point i of a [K]-batched output or state, without the K axis."""
    return tree_map(lambda x: x[i], tree)


def simulate(cfg: SimConfig, device=None) -> RawSimOutput:
    """Run one simulation: a K=1 `simulate_sweep`, returned without the K
    axis (as the reference's `simulate`).  Runs on the card unless
    ``device="cpu"``."""
    return point_of(simulate_sweep(cfg, make_sweep(cfg, device=device),
                                   device=device), 0)
