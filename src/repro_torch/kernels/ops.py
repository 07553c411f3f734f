"""Dispatch to the port's kernels.

  flash_attention  -- attention for `models.attention` (flash_attention.py)
  rg_lru           -- the RG-LRU scan for `models.rglru` (rg_lru.py)
  mltcp_cc_tick    -- the fused CC-tick kernel as a drop-in for
                      `repro_torch.core.cc_tick` (mltcp_step.py)
  netsim_chunk     -- a simulator run through the chunk kernel: a chunk of
                      fabric ticks, the CC update included, per launch
                      (netsim_chunk.py)

Each launches its CUDA kernel on CUDA tensors and runs the kernel's plain
version on CPU tensors; nothing catches a build or launch failure.

`mltcp_cc_tick` computes the job-aggregated numerator and the
``n_boundaries`` counter outside the kernel, as the reference wrapper does,
and hands the protocol scalars (``dyn``) and the Static-baseline factors
to the kernel as operands, and the F family (the linear F or one of the
paper's F1..F6) as the launch's F id.  Only the structural options the
kernel does not implement (a favoritism policy other than
``largest_data_sent`` without Static factors, an F that is a Python
callable) run `core.cc_tick` instead — loudly, via
``FALLBACK_COUNT`` and one warning per reason.  Every other case goes to
`mltcp_step.mltcp_tick`.

`netsim_chunk` decides, once per run, whether a simulator run goes through
the chunk kernel: on the card it does, but for the structural cases that
keep the per-tick path there (`engine._tick` per tick, its CC update
through `mltcp_cc_tick`) — loudly, via ``CHUNK_FALLBACK_COUNT`` and one
warning per reason: a configuration that `fallback_reason` sends to
`core.cc_tick`, a telemetry spec that arms a probe added with
`telemetry.register_probe` (a Python callable the kernel cannot run), and
a point whose state does not fit the kernel's shared-memory budget
(`netsim_chunk.budget_reason`).  Built-in probes, detectors and fault
tables run in the armed chunk kernel on every CC specialization.  On the
card that per-tick path is replayed as a CUDA graph of a chunk
(`netsim.tick_graph`).  On the CPU the per-tick path is the plain version
and nothing is counted.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch.distributed.tensor import Shard

from repro_torch.core import iteration
from repro_torch.core import mltcp as core
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mltcp_step as ms
from repro_torch.kernels import netsim_chunk as nc
from repro_torch.kernels import rg_lru as rl
from repro_torch.launch import layout
from repro_torch.netsim import telemetry as telem

Tensor = torch.Tensor

# Incremented once per call routed through core.cc_tick instead of the
# fused kernel; the engine's main path must leave it at 0.
FALLBACK_COUNT = 0
_FALLBACK_WARNED: set = set()
# Incremented once per run on the card that a configuration the chunk
# kernel does not take sends through the per-tick path; the engine's main
# path must leave it at 0.
CHUNK_FALLBACK_COUNT = 0
_CHUNK_FALLBACK_WARNED: set = set()


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    window: int = 0, softcap: Optional[float] = None
                    ) -> Tensor:
    """Attention through the flash kernel. q: [B,T,H,D]; k/v: [B,S,K,D].
    On DTensors each device runs the kernel on its own heads
    (`_flash_on_shards`)."""
    if layout.is_sharded(q, k, v):
        return _flash_on_shards(q, k, v, causal, window, softcap)
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window, softcap=softcap)


def _flash_on_shards(q, k, v, causal, window, softcap):
    """The flash kernel on each device's local shards.  The kernel takes
    whole heads and whole sequences, so the operands are first
    redistributed (`layout.sharded_call`): the batch keeps its data-axis
    shards, and the model axis splits the query heads, in chunks of
    ceil(H / m) as DTensor splits them (the first devices hold the most;
    a device may hold none).  The KV heads split alike where they and the
    query heads divide evenly (each device's group intact); otherwise they
    are replicated on the model axis and each device takes, for each of
    its query heads, the KV head it reads (its group becomes one)."""
    m = layout.model_split(q)
    h, kv = q.shape[2], k.shape[2]
    even = m > 1 and h % m == 0 and kv % m == 0
    q_at = layout.kernel_placements(q, (0,), 2 if m > 1 else None)
    kv_at = layout.kernel_placements(q, (0,), 2 if even else None)
    pick = None
    if m > 1 and not even:
        chunk = -(-h // m)
        lo = layout.model_rank(q) * chunk
        group = h // kv
        pick = [(lo + j) // group for j in range(max(0, min(chunk, h - lo)))]

    def local_flash(ql, kl, vl):
        if pick is not None:
            idx = torch.tensor(pick, dtype=torch.long, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        if ql.shape[2] == 0:
            # a device that holds no query head: its empty result still
            # joined to K/V, so that its backward issues the collectives
            # that the other devices' backward does
            return ql + 0 * (kl.sum() + vl.sum())
        return fa.flash_attention(ql.contiguous(), kl.contiguous(),
                                  vl.contiguous(), causal=causal,
                                  window=window, softcap=softcap)

    return layout.sharded_call(local_flash, (q, k, v), (q_at, kv_at, kv_at),
                               q_at, q.shape)


def rg_lru(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t through the scan kernel. a/b: [B,T,D].
    On DTensors each device scans its own channels: the batch keeps its
    data-axis shards and the channels shard on the model axis where it
    divides them (else they replicate there); time is never split."""
    if layout.is_sharded(a, b):
        m = layout.model_split(a)
        at = layout.kernel_placements(
            a, (0,), 2 if m > 1 and a.shape[2] % m == 0 else None)
        h_at = [Shard(1) if p == Shard(2) else p for p in at]

        def local_scan(al, bl, hl=None):
            return rl.rg_lru(al.contiguous(), bl.contiguous(),
                             None if hl is None else hl.contiguous())

        args = (a, b) if h0 is None else (a, b, h0)
        return layout.sharded_call(local_scan, args,
                                   (at, at, h_at)[:len(args)], at, a.shape)
    return rl.rg_lru(a.contiguous(), b.contiguous(),
                     None if h0 is None else h0.contiguous())


def reset_fallback_warnings() -> None:
    """Re-arm the once-per-reason fallback warnings."""
    _FALLBACK_WARNED.clear()
    _CHUNK_FALLBACK_WARNED.clear()


def fallback_reason(cfg: core.MLTCPConfig,
                    static_factors: Optional[Tensor]) -> Optional[str]:
    """Why this config cannot run the kernel (None: it can): a favoritism
    policy other than ``largest_data_sent`` without Static factors (with
    them it is moot, as in the reference dispatch), or an F that
    `mltcp_step.f_id` refuses (a callable: the kernels compute the linear
    F and F1..F6 alone).  Static factors do not make F moot: their
    negative sentinel entries keep the flow's F."""
    if static_factors is None and cfg.favoritism != "largest_data_sent":
        return f"favoritism={cfg.favoritism!r}"
    try:
        ms.f_id(cfg.f_spec)
    except ValueError:
        return f"f_spec={cfg.f_spec!r}"
    return None


def mltcp_cc_tick(cfg: core.MLTCPConfig, state: core.MLTCPState,
                  fb: core.Feedback, total_bytes: Tensor,
                  flow_to_job=None, n_jobs: int = 0,
                  static_factors: Optional[Tensor] = None,
                  comm_elapsed: Optional[Tensor] = None,
                  est_finish: Optional[Tensor] = None,
                  dyn: Optional[core.DynamicParams] = None
                  ) -> tuple[core.MLTCPState, Tensor]:
    """`core.cc_tick` backed by the fused kernel (same arguments)."""
    global FALLBACK_COUNT
    reason = fallback_reason(cfg, static_factors)
    if reason is not None:
        FALLBACK_COUNT += 1
        if reason not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(reason)
            warnings.warn(
                f"mltcp_cc_tick: option {reason} is outside the fused "
                f"kernel's specialization; running core.cc_tick instead",
                stacklevel=2)
        return core.cc_tick(cfg, state, fb, total_bytes,
                            flow_to_job=flow_to_job, n_jobs=n_jobs,
                            static_factors=static_factors,
                            comm_elapsed=comm_elapsed,
                            est_finish=est_finish, dyn=dyn)

    d, c = state.det, state.cc
    k, n = c.cwnd.shape
    if dyn is None:
        dyn = core.DynamicParams.from_config(cfg, k=k, device=c.cwnd.device)
    # per-flow operands must be [K, N]: a table leaking through unreduced
    # would otherwise be read as flow state
    for op_name, op in (("total_bytes", total_bytes),
                        ("static_factors", static_factors)):
        if op is not None and tuple(op.shape) != (k, n):
            raise ValueError(
                f"mltcp_cc_tick: operand {op_name!r} has shape "
                f"{tuple(op.shape)}, expected [K, N] = {(k, n)}")

    # job-aggregated numerator (paper §4.1: stats aggregated per job), in
    # the order-fixed per-job fold (core.segment)
    ackb = iteration.ack_bytes(fb.num_acks, cfg.cc.mss)
    groups = core.job_groups(flow_to_job, n_jobs, c.cwnd)
    aggregate = cfg.aggregate_by_job and groups is not None
    arrays = {
        "bytes_sent": d.bytes_sent, "prev_ack_tstamp": d.prev_ack_tstamp,
        "iter_gap": d.iter_gap, "max_gap": d.max_gap,
        "cwnd": c.cwnd, "ssthresh": c.ssthresh, "cooldown": c.cooldown,
        "w_max": c.w_max, "epoch_start": c.epoch_start,
        "rate_cur": c.rate_cur, "rate_target": c.rate_target,
        "alpha": c.alpha, "t_last_cnp": c.t_last_cnp,
        "t_last_inc": c.t_last_inc, "t_last_alpha": c.t_last_alpha,
        "stage": c.inc_stage, "prev_ratio": d.bytes_ratio,
        "num_acks": fb.num_acks, "ack_bytes": ackb,
        "loss": fb.loss, "cnp": fb.cnp, "total_bytes": total_bytes,
    }
    if aggregate:
        arrays["job_numer"] = groups.spread(groups.sum(d.bytes_sent + ackb))
    out = ms.mltcp_tick(ms.static_params(cfg.cc, aggregate, cfg.f_spec),
                        dyn.stacked(), arrays, fb.now, static_factors)

    # boundary counter (metrics only), outside the kernel, through the same
    # predicate helper the plain path uses
    boundary = iteration.boundary_mask(d.prev_ack_tstamp, d.iter_gap, dyn.g,
                                       fb.num_acks, fb.now)
    det = iteration.IterDetectState(
        bytes_sent=out["bytes_sent"], bytes_ratio=out["ratio"],
        prev_ack_tstamp=out["prev_ack_tstamp"], iter_gap=out["iter_gap"],
        max_gap=out["max_gap"],
        n_boundaries=d.n_boundaries + boundary.to(torch.int32))
    ccs = core.FlowCCState(
        cwnd=out["cwnd"], ssthresh=out["ssthresh"], cooldown=out["cooldown"],
        w_max=out["w_max"], epoch_start=out["epoch_start"],
        rate_cur=out["rate_cur"], rate_target=out["rate_target"],
        alpha=out["alpha"], t_last_cnp=out["t_last_cnp"],
        t_last_inc=out["t_last_inc"], t_last_alpha=out["t_last_alpha"],
        inc_stage=out["stage"])
    return core.MLTCPState(cc=ccs, det=det), out["rate"]


def custom_probe_reason(cfg) -> Optional[str]:
    """Why the armed chunk kernel cannot run a configuration's telemetry
    (None: it can, or nothing is armed): a probe added with
    `telemetry.register_probe`, a Python callable."""
    if cfg.telemetry is not None:
        for name in cfg.telemetry.probes:
            if not telem.is_builtin(name):
                return (f"telemetry probe {name!r} is a Python callable "
                        f"(register_probe)")
    return None


def chunk_fallback_reason(cfg, sweep) -> Optional[str]:
    """Why a simulator configuration cannot run the chunk kernel (None: it
    can): the CC kernel's own structural fallback, an armed configuration
    the armed kernel cannot run (`custom_probe_reason`), or the
    shared-memory budget."""
    reason = fallback_reason(cfg.protocol, sweep.static_job_factors)
    if reason is not None:
        return reason
    reason = custom_probe_reason(cfg)
    if reason is not None:
        return reason
    return nc.budget_reason(cfg)


def on_card(t: Tensor) -> bool:
    return t.device.type == "cuda"


def netsim_chunk(cfg, statics, sweep, wl, st, n_chunks: int
                 ) -> Optional[nc.ChunkRun]:
    """The run of ``n_chunks`` chunks from state ``st`` through the chunk
    kernel (`netsim_chunk.ChunkRun`: the state packed once, one launch per
    chunk), or None where the per-tick path runs it: on the CPU, and for a
    configuration the kernel does not take, counted and warned once per
    reason."""
    global CHUNK_FALLBACK_COUNT
    if not on_card(st.backlog):
        return None
    reason = chunk_fallback_reason(cfg, sweep)
    if reason is not None:
        CHUNK_FALLBACK_COUNT += 1
        if reason not in _CHUNK_FALLBACK_WARNED:
            _CHUNK_FALLBACK_WARNED.add(reason)
            warnings.warn(
                f"netsim_chunk: {reason} is outside the chunk kernel; "
                f"running the per-tick path instead", stacklevel=2)
        return None
    return nc.ChunkRun(nc.prepare(cfg, statics, sweep, wl), st, n_chunks)
