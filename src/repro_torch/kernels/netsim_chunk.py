"""The simulator's chunk kernel: a whole chunk of fabric ticks in one
launch, its operand packing, its shared-memory budget and its launch
counter.

One launch advances every sweep point by a chunk of ticks: one CTA per
point runs `netsim.engine._tick` back to back, the job phase machines,
injection, RED/ECN enqueue and service, routing, the loss and CNP draws,
the feedback ring, byte accounting and the MLTCP/CC update (the arithmetic
of the per-tick kernel, shared through ``csrc/mltcp_cc.cuh``), with the
point's state in shared memory.  It is the card's redesign of the CC tick
that replaces the Pallas TPU kernel ``repro/kernels/mltcp_step.py::_kernel``:
the reference ran a chunk as one ``jax.lax.scan`` with that kernel inside;
the per-tick port launched ~165 kernels a tick from the host.

Its plain version is the per-tick loop, `netsim.engine.run_chunk_reference`
(then `engine._chunk_probes`), which `engine.run_ticks` runs on the CPU.
The kernel's epilogue writes the chunk's trace probes itself, and
`ChunkRun` keeps a whole run's state packed between chunks, so on the card
(`engine.run_ticks` through `ops.netsim_chunk`) a chunk costs the host one
draw of inputs and one `launch`, which raises for CPU tensors.  On the card kernel and
plain version agree bit for bit on every leaf of the state and of the
probes (``chip_smoke.py``): the kernel is built with ``--fmad=false`` and
IEEE division and repeats the torch code op for op, its folds in the
same order.  `host_draws` is the host's random draws in C (the library's
host code), bit for bit `netsim.random.chunk_draws`, for the card's
`engine.chunk_inputs`.

What bounds it: the latency of a tick's chain of dependent phases (see the
source note), not bytes: the state (but ``iter_times``, of which only the
completed iterations' slots are written) is read and written once per
chunk and the chunk inputs once.

Operands.  The state travels field-major, ``[F, K, ...]`` (`pack_state`),
so `unpack_state` returns contiguous views; the run's constants (sweep
scalars, workload tables, routing) are packed once per run (`prepare`);
the chunk inputs are `engine.TickInputs` as `engine.chunk_inputs` makes
them.  The name lists below are the enums of ``csrc/netsim_chunk.cu``, in
order (tests/test_torch_chunk.py parses the source to hold them equal).

Telemetry and faults (``cfg.telemetry``, ``cfg.faults``) run in the armed
kernel (the template's ARMED, `armed_bits`): the ten built-in probes and
the three detectors of `netsim.telemetry`, the four fault channels of
`netsim.faults`; `ARMED_SPECIALIZATIONS` lists the CC specializations it
is built for (an armed run on another raises on the card,
`ops.check_armed_specialization`).  The telemetry state packs into the ``tel_*`` operands and
the probes' rings into one ``[K, cap, W]`` buffer (`series_layout`);
an unarmed run passes none of them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cc.types import Algo, Variant
from repro_torch.kernels import build
from repro_torch.kernels import mltcp_step as ms
from repro_torch.netsim import telemetry as telem

Tensor = torch.Tensor

# (enum name, EngineState path) per packed state field, in enum order
FLOW_FIELDS = (
    ("F_BYTES_SENT", "proto.det.bytes_sent"),
    ("F_RATIO", "proto.det.bytes_ratio"),
    ("F_PREV_ACK", "proto.det.prev_ack_tstamp"),
    ("F_ITER_GAP", "proto.det.iter_gap"),
    ("F_MAX_GAP", "proto.det.max_gap"),
    ("F_CWND", "proto.cc.cwnd"),
    ("F_SSTHRESH", "proto.cc.ssthresh"),
    ("F_COOLDOWN", "proto.cc.cooldown"),
    ("F_W_MAX", "proto.cc.w_max"),
    ("F_EPOCH", "proto.cc.epoch_start"),
    ("F_RATE_CUR", "proto.cc.rate_cur"),
    ("F_RATE_TGT", "proto.cc.rate_target"),
    ("F_ALPHA", "proto.cc.alpha"),
    ("F_T_CNP", "proto.cc.t_last_cnp"),
    ("F_T_INC", "proto.cc.t_last_inc"),
    ("F_T_ALPHA", "proto.cc.t_last_alpha"),
    ("F_TO_SEND", "to_send"),
    ("F_TO_DELIVER", "to_deliver"),
    ("F_COMM_START", "comm_start"),
)
IFLOW_FIELDS = (("I_STAGE", "proto.cc.inc_stage"),
                ("I_N_BOUNDARIES", "proto.det.n_boundaries"))
LINK_FIELDS = (("L_BACKLOG", "backlog"), ("L_TRANSIT", "transit"))
RING_FLAG_FIELDS = (("R_LOSS", "ring_loss"), ("R_CNP", "ring_cnp"))
FJOB_FIELDS = (("J_T_REM", "t_rem"), ("J_ITER_START", "iter_start"),
               ("J_HOLD_UNTIL", "hold_until"),
               ("J_STRAGGLE_EXTRA", "straggle_extra"))
IJOB_FIELDS = (("J_PHASE_IDX", "phase_idx"), ("J_ITER_IDX", "iter_idx"),
               ("J_IN_COMM", "in_comm"))
POINT_FIELDS = (("P_RING_PTR", "ring_ptr"), ("P_TICK", "tick"))
# (enum name, TelemetryState field) of the packed telemetry ints
TEL_INT_FIELDS = (("T_LAST_BAD", "last_bad_tick"),
                  ("T_ITERS_AT_BAD", "iters_at_last_bad"),
                  ("T_TAIL_BAD", "tail_bad"), ("T_TAIL_TICKS", "tail_ticks"),
                  ("T_N_SAMPLES", "n_samples"))
TEL_EV_FIELDS = (("E_START_TICK", "ev_start_tick"),
                 ("E_START_ITER", "ev_start_iter"),
                 ("E_END_TICK", "ev_end_tick"),
                 ("E_LAST_BAD", "ev_last_bad_tick"),
                 ("E_ITERS_AT_BAD", "ev_iters_at_last_bad"))
# (enum name, SweepParams / DynamicParams field) of the per-point scalars
PARAM_FIELDS = (("Q_SLOPE", "slope"), ("Q_INTERCEPT", "intercept"),
                ("Q_G", "g"), ("Q_GAMMA", "gamma"),
                ("Q_INIT_GAP", "init_comm_gap"), ("Q_RED_QMIN", "red_qmin"),
                ("Q_RED_QMAX", "red_qmax"), ("Q_RED_PMAX", "red_pmax"),
                ("Q_CASSINI_EPS", "cassini_eps"))
# the kernel's pointer, int and float argument arrays
OPERANDS = (
    "O_FFLOW", "O_IFLOW", "O_LINK", "O_RING_DEL", "O_RING_FLAGS", "O_FJOB",
    "O_IJOB", "O_POINT", "O_ITER_TIMES", "O_ACC",
    "O_PARAMS", "O_FLOW_TOTAL", "O_FACTORS", "O_JOB_TABLES", "O_CASSINI",
    "O_STATIC_INTS", "O_STATIC_FLOATS",
    "O_T", "O_STARTED", "O_LOSS_U", "O_CNP_U", "O_STRAGGLES", "O_STRAG_AMT",
    "O_TRACE_UTIL", "O_TRACE_DROPS", "O_TRACE_MARKS", "O_TRACE_INCOMM",
    "O_TRACE_T", "O_TRACE_JOBTPUT", "O_TRACE_RATIO",
    "O_FAULT_IDX", "O_CHURN", "O_BLACKHOLE", "O_CAP_DT", "O_JOB_ACTIVE",
    "O_TEL_F", "O_TEL_I", "O_TEL_HIST", "O_TEL_EV", "O_SERIES",
    "O_SAMPLE_TICK")
# the ring's column offset of each built-in probe, telemetry.BUILTIN_PROBES
# order
PROBE_DIMS = tuple(f"D_OFF_{name.upper()}" for name in telem.BUILTIN_PROBES)
DIMS = ("D_K", "D_M", "D_N", "D_J", "D_S", "D_D", "D_P", "D_MAX_ITERS",
        "D_TICKS", "D_U_STRIDE", "D_ECN", "D_CASSINI", "D_CUBIC_RESET",
        "D_N_CHUNKS", "D_CHUNK",
        "D_ARMED", "D_CHURN", "D_BLACKHOLE", "D_FLAPS", "D_JOB_ACTIVE",
        "D_INTERLEAVE", "D_SKETCH", "D_REINTERLEAVE", "D_STRIDE", "D_CAP",
        "D_SERIES_W", "D_TAIL_START", "D_BINS", "D_EVENTS") + PROBE_DIMS
SCALARS = ("S_DT", "S_MSS", "S_HALF_MSS", "S_BUFFER", "S_TPC", "S_SPAN",
           "S_ALPHA", "S_THRESHOLD", "S_SKETCH_LO", "S_SKETCH_HI",
           "S_LOG_LO", "S_INV_W")
# the chunk's fault rows ([T, K, ...]: engine.TickInputs), each with its
# dtype
FAULT_INPUTS = (("O_FAULT_IDX", "fault_idx", torch.int32),
                ("O_CHURN", "churn", torch.bool),
                ("O_BLACKHOLE", "blackhole", torch.bool),
                ("O_CAP_DT", "cap_dt", torch.float32))
# ARMED's bits (the kernel's ARM_TEL, ARM_FAULTS), and the CC
# specializations (algo, variant, aggregate, factors) each armed kernel is
# built for: the telemetry and fault plans' (every algorithm, OFF and WI,
# job-aggregated statistics, no Static factors)
ARM_TEL, ARM_FAULTS = 1, 2
ARMED_SPECIALIZATIONS = frozenset(
    (int(a), int(v), True, False) for a in Algo
    for v in (Variant.OFF, Variant.WI))
# the trace buffers the kernel's epilogue writes (`engine.CHUNK_FIELDS`
# order, each [K, n_chunks, ...]), with a chunk's probe's per-point shape
TRACE_OPERANDS = ("O_TRACE_UTIL", "O_TRACE_DROPS", "O_TRACE_MARKS",
                  "O_TRACE_INCOMM", "O_TRACE_T", "O_TRACE_JOBTPUT",
                  "O_TRACE_RATIO")
# the trace accumulators, [K, M], [K], [K], [K, J] one after the other in
# one buffer; the kernel zeroes them at the chunk's start, as the plain
# version does
ACC_FIELDS = ("acc_util", "acc_drops", "acc_marks", "acc_jobbytes")
# per-flow float and int scratch (the kernel's FX / IX enums); only their
# counts enter the budget
N_FLOW_SCRATCH = 8
N_FLOW_ISCRATCH = 3
# the armed kernel's words per flow (blackholed bytes, F * spj_inv) and
# per job (three snapshots, the padded-jobs mask): ArmedLayout
N_ARMED_FLOW = 2
N_ARMED_JOB = 4

# The card's shared memory a block may use (H100: 227 KB, after the
# launch's opt-in above 48 KB), and the CTA's most threads (the kernel's
# __launch_bounds__).
SMEM_LIMIT = 232_448
MAX_THREADS = 256

# Launches of the CUDA kernel (never of the plain version).
LAUNCH_COUNT = 0


def _get(tree, path: str):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


# ---------------------------------------------------------------------------
# Budget
# ---------------------------------------------------------------------------

def smem_words(M: int, N: int, J: int, S: int, D: int, P: int,
               A: int = 0, P2: int = 0, B: int = 0, E: int = 0) -> int:
    """4-byte words of one point's shared memory: the kernel's ``Layout``,
    and for an armed launch (``A`` its ARMED) its ``ArmedLayout`` with
    ``P2`` job pairs, ``B`` sketch bins and ``E`` schedule rows."""
    L = M + 1
    flow = (len(FLOW_FIELDS) + len(IFLOW_FIELDS) + N_FLOW_SCRATCH
            + N_FLOW_ISCRATCH) * N
    link = 5 * L * N + 3 * L + M
    ring = 2 * D * N
    statics = (2 * N + J * S + J + L * N) + (N + M + 2 * L * N + J)
    jobs = (len(FJOB_FIELDS) + len(IJOB_FIELDS) + 4) * J + 2 * J * P + 2 * J
    armed = 0
    if A:
        armed = (N_ARMED_FLOW * N + N_ARMED_JOB * J + 2 * P2 + J * B
                 + len(TEL_EV_FIELDS) * E)
    return flow + link + ring + statics + jobs + armed


def smem_bytes(M: int, N: int, J: int, S: int, D: int, P: int,
               A: int = 0, P2: int = 0, B: int = 0, E: int = 0) -> int:
    return 4 * smem_words(M, N, J, S, D, P, A, P2, B, E)


def armed_bits(cfg) -> int:
    """The kernel's ARMED for a config: telemetry, faults, both or none."""
    return ((ARM_TEL if cfg.telemetry is not None else 0)
            | (ARM_FAULTS if cfg.faults is not None else 0))


def shape_of(cfg) -> dict:
    """The budget's dimensions of a `SimConfig`: links M, flows N, jobs J,
    the most flows of one job S, the ring depth D and phases P; and the
    armed kernel's: its ARMED A, the detectors' job pairs P2, sketch bins
    B and schedule rows E (0 where unarmed)."""
    n_jobs = cfg.jobs.n_jobs
    f2j = np.asarray(cfg.topo.flow_to_job)
    per_job = np.bincount(f2j, minlength=n_jobs) if f2j.size else [0]
    spec = cfg.telemetry
    tel = spec is not None
    return dict(M=cfg.topo.n_links, N=cfg.topo.n_flows, J=n_jobs,
                S=max(int(np.max(per_job)), 1), D=cfg.rtt_ticks,
                P=int(cfg.jobs.compute.shape[1]), A=armed_bits(cfg),
                P2=(n_jobs * (n_jobs - 1) // 2
                    if tel and spec.needs_interleave() else 0),
                B=spec.sketch_bins if tel and spec.needs_sketch() else 0,
                E=(cfg.faults.n_events
                   if tel and spec.needs_reinterleave() else 0))


def budget_reason(cfg) -> Optional[str]:
    """Why a config's point does not fit one CTA (None: it fits)."""
    shape = shape_of(cfg)
    need = smem_bytes(**shape)
    if need > SMEM_LIMIT:
        dims = ", ".join(f"{k}={v}" for k, v in shape.items())
        return (f"shared memory: a point needs {need} B ({dims}), over the "
                f"{SMEM_LIMIT} B a block may use")
    return None


def threads_for(M: int, N: int, J: int) -> int:
    """The CTA's threads: one per flow, link row or job, in whole warps,
    at most MAX_THREADS (larger counts loop)."""
    widest = max(N, M + 1, J, 1)
    return min(MAX_THREADS, -(-widest // 32) * 32)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

class ChunkState(NamedTuple):
    """The state operands, field-major; the kernel updates them in place."""

    fflow: Tensor        # [19, K, N] float32
    iflow: Tensor        # [2, K, N] int32
    link: Tensor         # [2, K, M+1, N] float32
    ring_del: Tensor     # [K, D, N] float32
    ring_flags: Tensor   # [2, K, D, N] bool
    fjob: Tensor         # [4, K, J] float32
    ijob: Tensor         # [3, K, J] int32 (in_comm as 0/1)
    point: Tensor        # [2, K] int32
    iter_times: Tensor   # [K, J, MAX_ITERS] float32
    acc: Tensor          # [K*M + K + K + K*J] float32 (ACC_FIELDS): the
                         # kernel zeroes them at the chunk's start
    # telemetry (None unless cfg.telemetry arms it): the pair EWMAs (both
    # then either), TEL_INT_FIELDS, the histogram, TEL_EV_FIELDS, the
    # probes' rings (`TelemetryLayout` columns) and their sample ticks
    tel_f: Optional[Tensor] = None        # [K, 2 * P2] float32
    tel_i: Optional[Tensor] = None        # [5, K] int32
    tel_hist: Optional[Tensor] = None     # [K, J, B] int32
    tel_ev: Optional[Tensor] = None       # [5, K, E] int32
    series: Optional[Tensor] = None       # [K, cap, W] float32
    sample_tick: Optional[Tensor] = None  # [K, cap] int32


class TelemetryLayout(NamedTuple):
    """Where a spec's probes sit in the packed ring ``[K, cap, W]``
    (``probes``: (name, first column, per-sample shape) in spec order) and
    which detectors' state the packed operands carry."""

    probes: tuple
    width: int
    interleave: bool
    sketch: bool
    reinterleave: bool


def telemetry_layout(cfg) -> Optional[TelemetryLayout]:
    spec = cfg.telemetry
    if spec is None:
        return None
    probes, off = [], 0
    for name in spec.probes:
        shape = telem.probe_shape(name, cfg)
        probes.append((name, off, shape))
        off += int(np.prod(shape)) if shape else 1
    return TelemetryLayout(tuple(probes), off, spec.needs_interleave(),
                           spec.needs_sketch(), spec.needs_reinterleave())


def _pack_telemetry(tel, k: int, j: int) -> dict:
    dev = tel.sample_tick.device
    cap = tel.sample_tick.shape[1]

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ints(fields):
        return torch.stack([getattr(tel, f) if getattr(tel, f) is not None
                            else zeros(k) for _, f in fields])

    return dict(
        tel_f=(torch.cat([tel.ewma_both, tel.ewma_either], dim=1)
               if tel.ewma_both is not None
               else zeros(k, 0, dtype=torch.float32)),
        tel_i=ints(TEL_INT_FIELDS),
        tel_hist=(tel.iter_hist.clone() if tel.iter_hist is not None
                  else zeros(k, j, 0)),
        tel_ev=(ints(TEL_EV_FIELDS) if tel.ev_start_tick is not None
                else zeros(len(TEL_EV_FIELDS), k, 0)),
        series=(torch.cat([v.reshape(k, cap, -1)
                           for v in tel.series.values()], dim=2)
                if tel.series else zeros(k, cap, 0, dtype=torch.float32)),
        sample_tick=tel.sample_tick.clone())


def pack_state(st) -> ChunkState:
    """An `engine.EngineState` as fresh operand buffers (never aliasing
    ``st``, so the kernel may update them in place)."""
    def stack(fields, dtype=None):
        parts = [_get(st, path) for _, path in fields]
        if dtype is not None:
            parts = [p.to(dtype) for p in parts]
        return torch.stack(parts)

    k, j = st.phase_idx.shape
    return ChunkState(
        fflow=stack(FLOW_FIELDS), iflow=stack(IFLOW_FIELDS),
        link=stack(LINK_FIELDS), ring_del=st.ring_del.clone(),
        ring_flags=stack(RING_FLAG_FIELDS), fjob=stack(FJOB_FIELDS),
        ijob=stack(IJOB_FIELDS, torch.int32), point=stack(POINT_FIELDS),
        iter_times=st.iter_times.clone(),
        acc=torch.cat([getattr(st, f).reshape(-1) for f in ACC_FIELDS]),
        **({} if st.telemetry is None
           else _pack_telemetry(st.telemetry, k, j)))


def _unpack_telemetry(cs: ChunkState, layout: TelemetryLayout):
    k, cap = cs.sample_tick.shape
    series = {name: cs.series[:, :, off:off + (
        int(np.prod(shape)) if shape else 1)].reshape((k, cap) + shape)
        for name, off, shape in layout.probes}
    kw = dict(n_samples=cs.tel_i[-1])
    if layout.interleave:
        p2 = cs.tel_f.shape[1] // 2
        kw.update(ewma_both=cs.tel_f[:, :p2], ewma_either=cs.tel_f[:, p2:],
                  **{f: x for (_, f), x in zip(TEL_INT_FIELDS[:-1],
                                               cs.tel_i[:-1])})
    if layout.sketch:
        kw["iter_hist"] = cs.tel_hist
    if layout.reinterleave:
        kw.update({f: x for (_, f), x in zip(TEL_EV_FIELDS, cs.tel_ev)})
    return telem.TelemetryState(series=series, sample_tick=cs.sample_tick,
                                **kw)


def unpack_state(cs: ChunkState, key: np.ndarray,
                 layout: Optional[TelemetryLayout] = None):
    """The `engine.EngineState` the buffers hold (views, no copies but
    ``in_comm``), with the host-side ``key``; ``layout`` (the run's
    `telemetry_layout`) unpacks the telemetry state."""
    from repro_torch.core import iteration
    from repro_torch.core.cc.types import FlowCCState
    from repro_torch.core.mltcp import MLTCPState
    from repro_torch.netsim.engine import EngineState

    vals = {path: x for fields, buf in (
        (FLOW_FIELDS, cs.fflow), (IFLOW_FIELDS, cs.iflow),
        (LINK_FIELDS, cs.link), (RING_FLAG_FIELDS, cs.ring_flags),
        (FJOB_FIELDS, cs.fjob), (IJOB_FIELDS, cs.ijob),
        (POINT_FIELDS, cs.point)) for (_, path), x in zip(fields, buf)}
    vals["in_comm"] = vals["in_comm"] != 0
    k, m1 = cs.link.shape[1:3]
    j = cs.fjob.shape[2]
    m = m1 - 1
    acc_util, acc_drops, acc_marks, acc_jobbytes = torch.split(
        cs.acc, [k * m, k, k, k * j])

    def group(cls, prefix):
        return cls(**{f: vals[f"{prefix}.{f}"] for f in cls._fields})

    proto = MLTCPState(cc=group(FlowCCState, "proto.cc"),
                       det=group(iteration.IterDetectState, "proto.det"))
    return EngineState(
        proto=proto, **{f: vals[f] for f in EngineState._fields
                        if f in vals},
        ring_del=cs.ring_del, iter_times=cs.iter_times, key=key,
        acc_util=acc_util.view(k, m), acc_drops=acc_drops,
        acc_marks=acc_marks, acc_jobbytes=acc_jobbytes.view(k, j),
        telemetry=(None if cs.series is None
                   else _unpack_telemetry(cs, layout)))


class RunOperands(NamedTuple):
    """What stays constant over a run, packed once (`prepare`)."""

    params: Tensor            # [K, len(PARAM_FIELDS)] float32
    flow_total: Tensor        # [K, N]
    factors: Optional[Tensor]  # [K, N]
    job_tables: Tensor        # [K, 2, J, P]: compute, comm_bytes
    cassini: Optional[Tensor]  # [K, 2, J]: offset, period
    static_ints: Tensor       # f2j [N], last_link [N], members [J*S]
                              # (-1 pads), last_phase [J], prev_link [M+1, N]
    static_floats: Tensor     # spj_inv [N], cap_dt [M], first_hot [M+1, N],
                              # keep = ~is_final [M+1, N], flows_per_job [J]
    dims: dict                # DIMS but the chunk's (ticks, stride, column)
    scalars: tuple            # SCALARS before the chunk's (S_TPC, S_SPAN)
    cc: object                # CCParams
    aggregate: bool
    threads: int
    job_active: Optional[Tensor] = None  # [K, J] bool, read when armed
    layout: Optional[TelemetryLayout] = None
    tel_scalars: tuple = (0.0,) * 6      # SCALARS after S_SPAN


def prepare(cfg, statics, sweep, wl) -> RunOperands:
    """Pack a run's constants for the kernel: the sweep scalars, the
    workload tables, the routing and the flow->job map."""
    k = int(sweep.slope.shape[0])
    M, N, J = cfg.topo.n_links, cfg.topo.n_flows, cfg.jobs.n_jobs
    g = statics.groups
    S = int(g.members.shape[1])
    P = int(sweep.compute.shape[2])
    dyn = wl.dyn
    cols = []
    for _, name in PARAM_FIELDS:
        v = getattr(dyn, name, None)
        if v is None:
            v = getattr(sweep, name)
        if v is None:        # cassini_eps without Cassini: unread
            v = torch.zeros_like(sweep.slope)
        cols.append(v.to(torch.float32))
    members = torch.where(g.members >= N, -1, g.members)
    ints = torch.cat([
        g.f2j, statics.last_link.reshape(-1), members.reshape(-1),
        statics.last_phase.long(), statics.prev_link.reshape(-1)]
    ).to(torch.int32)
    floats = torch.cat([
        statics.spj_inv, statics.cap_dt, statics.first_hot.reshape(-1),
        (~statics.is_final).to(torch.float32).reshape(-1),
        statics.flows_per_job])
    cassini = None
    if sweep.cassini_period is not None:
        cassini = torch.stack([sweep.cassini_offset, sweep.cassini_period],
                              dim=1).contiguous()
    cc = cfg.protocol.cc
    dims = dict(D_K=k, D_M=M, D_N=N, D_J=J, D_S=S, D_D=cfg.rtt_ticks, D_P=P,
                D_MAX_ITERS=cfg.max_iters_recorded,
                D_ECN=int(cfg.is_ecn()), D_CASSINI=int(cassini is not None),
                D_CUBIC_RESET=int(cfg.cubic_epoch_reset_on_comm_start))
    dims.update(_armed_dims(cfg, sweep))
    layout = telemetry_layout(cfg)
    tel_scalars = (0.0,) * 6
    if cfg.telemetry is not None:
        spec = cfg.telemetry
        c = telem.sketch_constants(spec)
        tel_scalars = (telem.ewma_alpha(cfg, spec),
                       float(np.float32(spec.overlap_threshold)),
                       c["lo"], c["hi"], c["log_lo"], c["inv_w"])
    return RunOperands(
        params=torch.stack(cols, dim=1).contiguous(),
        flow_total=wl.flow_total.contiguous(),
        factors=(None if wl.static_factors is None
                 else wl.static_factors.contiguous()),
        job_tables=torch.stack([sweep.compute, sweep.comm_bytes],
                               dim=1).contiguous(),
        cassini=cassini, static_ints=ints.contiguous(),
        static_floats=floats.contiguous(), dims=dims,
        scalars=(cfg.dt, cc.mss, 0.5 * cc.mss, cfg.buffer_bytes),
        cc=cc, aggregate=bool(cfg.protocol.aggregate_by_job),
        threads=threads_for(M, N, J),
        job_active=(None if sweep.job_active is None
                    else sweep.job_active.contiguous()),
        layout=layout, tel_scalars=tel_scalars)


def _armed_dims(cfg, sweep) -> dict:
    """The armed kernel's DIMS of a run (all 0, offsets -1, unarmed)."""
    spec, fs = cfg.telemetry, cfg.faults
    dims = {name: 0 for name in DIMS[DIMS.index("D_ARMED"):]}
    dims.update({name: -1 for name in PROBE_DIMS})
    dims["D_ARMED"] = armed_bits(cfg)
    if fs is not None:
        dims.update(D_CHURN=int(fs.churn), D_BLACKHOLE=int(fs.blackholes),
                    D_FLAPS=int(fs.link_flaps))
    if spec is not None:
        shape = shape_of(cfg)
        dims.update(
            D_JOB_ACTIVE=int(sweep.job_active is not None),
            D_INTERLEAVE=int(spec.needs_interleave()),
            D_SKETCH=int(spec.needs_sketch()),
            D_REINTERLEAVE=int(spec.needs_reinterleave()),
            D_STRIDE=spec.stride, D_CAP=spec.n_slots(cfg.n_ticks),
            D_TAIL_START=cfg.n_ticks // 2, D_BINS=shape["B"],
            D_EVENTS=shape["E"])
        layout = telemetry_layout(cfg)
        dims["D_SERIES_W"] = layout.width
        for name, off, _ in layout.probes:
            if telem.is_builtin(name):
                dims[f"D_OFF_{name.upper()}"] = off
    return dims


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"netsim_chunk: {name!r} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"netsim_chunk: {name!r} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"netsim_chunk: {name!r} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")


def new_traces(k: int, n_chunks: int, m: int, j: int, device) -> tuple:
    """The run's trace buffers, `engine.CHUNK_FIELDS` order, [K, C, ...]."""
    def f(*shape, dtype=torch.float32):
        return torch.empty((k, n_chunks) + shape, dtype=dtype, device=device)
    return (f(m), f(), f(), f(j, dtype=torch.bool), f(), f(j), f(j))


def launch_arguments(run: RunOperands, cs: ChunkState, inputs,
                     traces: tuple, chunk: int) -> tuple:
    """The kernel's argument arrays for one chunk, as ctypes arrays:
    (operand pointers, dims, scalars, CC constants), after checking every
    chunk input's device, dtype, shape and layout; the probes go to column
    ``chunk`` of ``traces`` (`new_traces`)."""
    device = cs.fflow.device
    d = run.dims
    n_ticks = int(inputs.t.shape[0])
    K, N, J = d["D_K"], d["D_N"], d["D_J"]
    _check("t", inputs.t, (n_ticks, K), torch.float32, device)
    for name in ("started", "straggles"):
        _check(name, getattr(inputs, name), (n_ticks, K, J), torch.bool,
               device)
    _check("strag_amt", inputs.strag_amt, (n_ticks, K, J), torch.float32,
           device)
    for name in ("t", "started", "straggles", "strag_amt"):
        if not getattr(inputs, name).is_contiguous():
            raise ValueError(f"netsim_chunk: {name!r} is not contiguous")
    # the uniforms may be row views of one [T, K, W] buffer: N values a
    # row, rows `stride` apart
    u_stride = inputs.loss_u.stride(1)
    for name in ("loss_u", "cnp_u"):
        u = getattr(inputs, name)
        _check(name, u, (n_ticks, K, N), torch.float32, device)
        if (u.stride(2) != 1 or u.stride(1) != u_stride
                or u.stride(0) != K * u_stride):
            raise ValueError(f"netsim_chunk: {name!r} has strides "
                             f"{u.stride()}, not rows of one buffer")
    n_chunks = int(traces[0].shape[1])
    if not 0 <= chunk < n_chunks:
        raise ValueError(f"netsim_chunk: chunk {chunk} outside the "
                         f"{n_chunks} columns of the traces")
    for name, t in zip(TRACE_OPERANDS, traces):
        if (t.shape[:2] != (K, n_chunks) or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"netsim_chunk: trace {name} is not a "
                             f"contiguous [K, C, ...] buffer on {device}")
    # the chunk's fault rows: present exactly where the run arms them
    want_rows = dict(fault_idx=bool(d["D_ARMED"] & ARM_FAULTS),
                     churn=bool(d["D_CHURN"]), blackhole=bool(d["D_BLACKHOLE"]),
                     cap_dt=bool(d["D_FLAPS"]))
    widths = dict(fault_idx=(), churn=(J,), blackhole=(N,),
                  cap_dt=(d["D_M"],))
    for _, name, dtype in FAULT_INPUTS:
        t = getattr(inputs, name)
        if (t is not None) != want_rows[name]:
            raise ValueError(f"netsim_chunk: chunk input {name!r} is "
                             f"{'missing' if t is None else 'unexpected'}")
        if t is not None:
            _check(name, t, (n_ticks, K) + widths[name], dtype, device)
            if not t.is_contiguous():
                raise ValueError(f"netsim_chunk: {name!r} is not contiguous")
    if (cs.series is not None) != bool(d["D_ARMED"] & ARM_TEL):
        raise ValueError("netsim_chunk: the state's telemetry does not "
                         "match the run's")
    ptrs = {
        "O_FFLOW": cs.fflow, "O_IFLOW": cs.iflow, "O_LINK": cs.link,
        "O_RING_DEL": cs.ring_del, "O_RING_FLAGS": cs.ring_flags,
        "O_FJOB": cs.fjob, "O_IJOB": cs.ijob, "O_POINT": cs.point,
        "O_ITER_TIMES": cs.iter_times, "O_ACC": cs.acc,
        "O_PARAMS": run.params, "O_FLOW_TOTAL": run.flow_total,
        "O_FACTORS": run.factors, "O_JOB_TABLES": run.job_tables,
        "O_CASSINI": run.cassini, "O_STATIC_INTS": run.static_ints,
        "O_STATIC_FLOATS": run.static_floats,
        "O_T": inputs.t, "O_STARTED": inputs.started,
        "O_LOSS_U": inputs.loss_u, "O_CNP_U": inputs.cnp_u,
        "O_STRAGGLES": inputs.straggles, "O_STRAG_AMT": inputs.strag_amt,
        **dict(zip(TRACE_OPERANDS, traces)),
        **{o: getattr(inputs, name) for o, name, _ in FAULT_INPUTS},
        "O_JOB_ACTIVE": run.job_active, "O_TEL_F": cs.tel_f,
        "O_TEL_I": cs.tel_i, "O_TEL_HIST": cs.tel_hist,
        "O_TEL_EV": cs.tel_ev, "O_SERIES": cs.series,
        "O_SAMPLE_TICK": cs.sample_tick}
    for name, t in ptrs.items():
        if t is not None and t.device != device:
            raise ValueError(f"netsim_chunk: operand {name} is on "
                             f"{t.device}, the state on {device}")
    dims = dict(d, D_TICKS=n_ticks, D_U_STRIDE=u_stride, D_N_CHUNKS=n_chunks,
                D_CHUNK=chunk)
    # engine._chunk_probes divides by float32 tensors of these
    dt = run.scalars[0]
    scalars = run.scalars + (float(n_ticks), n_ticks * dt) + run.tel_scalars
    consts = ms._consts(run.cc)
    return (
        (ctypes.c_void_p * len(OPERANDS))(*[
            None if ptrs[n] is None else ptrs[n].data_ptr()
            for n in OPERANDS]),
        (ctypes.c_int * len(DIMS))(*[dims[n] for n in DIMS]),
        (ctypes.c_float * len(SCALARS))(*scalars),
        (ctypes.c_float * len(ms.CONST_FIELDS))(*[
            consts[f] for f in ms.CONST_FIELDS]))


def specialization(run: RunOperands) -> tuple:
    """(algo, variant, aggregate, factors): the kernel's CC template
    arguments (its ARMED travels in the dims, ``D_ARMED``)."""
    return (int(run.cc.algo), int(run.cc.variant), int(run.aggregate),
            int(run.factors is not None))


# ---------------------------------------------------------------------------
# Build and launch
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    lib.netsim_chunk_launch.restype = ctypes.c_int
    lib.netsim_chunk_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.netsim_chunk_attributes.restype = ctypes.c_int
    lib.netsim_chunk_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.netsim_chunk_sketch_check.restype = ctypes.c_int
    lib.netsim_chunk_sketch_check.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.netsim_chunk_smem_bytes.restype = ctypes.c_longlong
    lib.netsim_chunk_smem_bytes.argtypes = [ctypes.c_void_p]
    bind_draws(lib)


def bind_draws(lib: ctypes.CDLL) -> None:
    """The argument types of the library's host draws (`host_draws`)."""
    lib.netsim_chunk_draws.restype = None
    lib.netsim_chunk_draws.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


LIBRARY = build.KernelLibrary("netsim_chunk", _bind)


def launch(run: RunOperands, cs: ChunkState, inputs, traces: tuple,
           chunk: int) -> None:
    """Launch one chunk on the current stream without synchronizing: the
    kernel advances ``cs`` in place and writes the chunk's probes into
    column ``chunk`` of ``traces``.  Raises if the launch was refused;
    counts it in `LAUNCH_COUNT`."""
    global LAUNCH_COUNT
    device = cs.fflow.device
    if device.type != "cuda":
        raise ValueError(f"netsim_chunk: no kernel for device {device}")
    operands, dims, scalars, consts = launch_arguments(run, cs, inputs,
                                                       traces, chunk)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.netsim_chunk_launch(
            *specialization(run), ctypes.cast(operands, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p),
            ctypes.cast(scalars, ctypes.c_void_p),
            ctypes.cast(consts, ctypes.c_void_p),
            run.cc.fast_recovery_stages, run.threads, stream)
    build.check_launch("netsim_chunk", rc)
    LAUNCH_COUNT += 1


def traces_for(cs: ChunkState, n_chunks: int) -> tuple:
    k, m1 = cs.link.shape[1:3]
    return new_traces(k, n_chunks, m1 - 1, cs.fjob.shape[2], cs.fflow.device)


class ChunkRun:
    """A whole run's chunks through the kernel, the state packed once.

    Each `step` launches one chunk: the kernel advances the packed state in
    place and writes the chunk's probes into column ``chunk`` of
    ``traces``, so per chunk the host only draws the inputs and launches.
    ``key`` and ``tick`` (the packed [K] counter, on the card) are what
    `engine.chunk_inputs` reads of a state; `state` unpacks the state.
    ``launch_fn`` replaces `launch` (the CPU build of the kernel's body in
    the tests).
    """

    def __init__(self, run: RunOperands, st, n_chunks: int, launch_fn=None):
        self.run = run
        self.cs = pack_state(st)
        self.key = st.key
        self.traces = traces_for(self.cs, n_chunks)
        self.chunk = 0
        self._launch = launch if launch_fn is None else launch_fn

    @property
    def tick(self) -> Tensor:
        return self.cs.point[[f for f, _ in POINT_FIELDS].index("P_TICK")]

    def step(self, inputs) -> None:
        self._launch(self.run, self.cs, inputs, self.traces, self.chunk)
        self.key = inputs.key[-1]
        self.chunk += 1

    def state(self):
        return unpack_state(self.cs, self.key, self.run.layout)


def host_draws(key: np.ndarray, n_ticks: int, n_flows: int, n_jobs: int,
               out: Tensor, lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`netsim.random.chunk_draws` from the library's C version (host code,
    bit for bit the same draws): the uniforms straight into ``out``, a
    contiguous float32 CPU tensor [T, K, 2N + 2J] laid out as
    `engine.chunk_inputs` ships them (loss, CNP, straggle, straggle
    amount); returns the key after each tick, [T, K, 2]."""
    key = np.ascontiguousarray(key, np.uint32)
    k = key.shape[0]
    want = (n_ticks, k, 2 * n_flows + 2 * n_jobs)
    if (out.device.type != "cpu" or out.dtype != torch.float32
            or tuple(out.shape) != want or not out.is_contiguous()):
        raise ValueError(f"host_draws: out must be a contiguous float32 CPU "
                         f"tensor of shape {want}")
    keys = np.empty((n_ticks, k, 2), np.uint32)
    lib = LIBRARY.load() if lib is None else lib
    lib.netsim_chunk_draws(key.ctypes.data, k, n_ticks, n_flows, n_jobs,
                           keys.ctypes.data, out.data_ptr())
    return keys


def launch_smem_bytes(run: RunOperands) -> int:
    """The dynamic shared memory a launch of ``run`` asks for, from the
    library (the size `netsim_chunk_launch` passes)."""
    dims = dict(run.dims, D_TICKS=0, D_U_STRIDE=0, D_N_CHUNKS=0, D_CHUNK=0)
    arr = (ctypes.c_int * len(DIMS))(*[dims[n] for n in DIMS])
    return int(LIBRARY.load().netsim_chunk_smem_bytes(
        ctypes.cast(arr, ctypes.c_void_p)))


def kernel_attributes(algo: int = int(Algo.RENO), variant: int = 1,
                      aggregate: bool = True, factors: bool = False,
                      armed: int = 0) -> dict:
    """Registers, local (spill) bytes, static shared bytes and the most
    threads a block of one specialization, from the runtime."""
    lib = LIBRARY.load()
    out = (ctypes.c_int * 4)()
    build.check_launch("netsim_chunk attributes", lib.netsim_chunk_attributes(
        algo, variant, int(aggregate), int(factors), armed,
        ctypes.cast(out, ctypes.c_void_p)))
    return dict(registers=out[0], local_bytes=out[1],
                static_smem_bytes=out[2], max_threads=out[3])


def sketch_check(x: Tensor, spec) -> tuple[Tensor, Tensor]:
    """``logf`` and the sketch's bin of every element of the float32 CUDA
    tensor ``x`` by the chunk kernel's own device function (its
    `telemetry.sketch_constants` from ``spec``): what the card's check
    holds against ``torch.log`` and `telemetry.tick_update`'s bins."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("sketch_check: x must be a contiguous float32 "
                         "CUDA tensor")
    c = telem.sketch_constants(spec)
    scalars = (ctypes.c_float * 4)(c["lo"], c["hi"], c["log_lo"], c["inv_w"])
    logs = torch.empty_like(x)
    bins = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.netsim_chunk_sketch_check(
            x.data_ptr(), x.numel(), logs.data_ptr(), bins.data_ptr(),
            ctypes.cast(scalars, ctypes.c_void_p), spec.sketch_bins, stream)
    build.check_launch("netsim_chunk sketch check", rc)
    return logs, bins
