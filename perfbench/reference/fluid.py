"""A plain fluid simulator of the MLTCP fabric, in NumPy float32.

The benchmark's yardstick for the simulator's cells: built from a
configuration file's numbers and a list of points, it works out every
derived value again (fabric, phase programs, isolation times, RED ramp,
draws) and steps all points together, one tick at a time, with NumPy
ops.  It shares no code or data with the program.

Semantics (paper §3 and the simulator's model):

* jobs run an iteration program of (compute seconds, comm bytes) phases;
  a job's flows enter a comm phase together, each with its share of the
  phase's bytes, and leave it when every flow has delivered within half a
  packet; an iteration's time is recorded when its last phase ends;
* a flow injects ``min(rate * dt, bytes left)`` a tick onto its first
  link; links queue bytes store-and-forward, serve ``cap * dt`` a tick
  shared in proportion to the queued bytes, and RED (gentle: 0 to pmax
  on [qmin, qmax], pmax to 1 on [qmax, 2 qmax]) drops on enqueue, or,
  for DCQCN, marks ECN; a full buffer drops in both modes;
* dropped bytes are sent again; a flow sees a loss (or CNP) event with
  probability ``1 - exp(-bytes / mss)`` of its dropped (marked) bytes,
  one round-trip later, with the delivered bytes as acks;
* the protocol is Algorithm 1 (bytes_ratio, boundary detection, job
  aggregation), the linear F on bytes_ratio scaling Reno's additive
  increase or DCQCN's rate increase for the WI variant, and the plain
  algorithms for OFF;
* every chunk of ticks records the seven traces: mean link utilization,
  dropped and marked packets, in-comm flags, time, per-job delivered
  bytes per second and per-job mean bytes_ratio.

Arithmetic is float32 with each operation rounded on its own, sums taken
as left folds in flow (or link) order, so that a correct simulator built
with IEEE float32 operations reproduces it bit for bit, up to the first
tick where a loss or CNP draw falls within a few ulps of its probability
(`first_ambiguous`): there a float32 ``expm1`` a last bit away decides
the event the other way.

``quantize`` holds the state in a lower precision between ticks (the
comparison's control; `bf16` rounds to bfloat16).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from reference import rng

F32 = np.float32
GBPS = 1e9 / 8.0
BENCH = Path(__file__).resolve().parents[1]


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), kept as float32."""
    if x.dtype != F32:
        return x
    b = np.ascontiguousarray(x).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(F32).reshape(x.shape)


# a draw this close to its probability decides nothing (`_note_ambiguous`)
AMBIGUOUS_ULPS = F32(4)


def _fold(x: np.ndarray, axis: int) -> np.ndarray:
    """Left-fold sum along ``axis``: ((x0 + x1) + x2) + ..."""
    return np.add.accumulate(x, axis=axis, dtype=F32).take(-1, axis=axis)


class Fabric:
    """The fabric and workload of a list of points, on the largest point's
    jobs (smaller points leave their trailing jobs inactive).  The fabric
    is one bottleneck link that every flow crosses (the paper's dumbbell,
    Fig. 6a), S flows a job."""

    def __init__(self, cfg: dict, points: list[dict]):
        topo = cfg["topology"]
        if topo["kind"] != "dumbbell":
            raise ValueError(f"unknown topology {topo['kind']!r}")
        self.J = max(int(p["n_jobs"]) for p in points)
        self.S = int(topo["sockets_per_job"])
        self.N = self.J * self.S
        self.f2j = np.repeat(np.arange(self.J), self.S)
        self.cap = topo["cap_gbps"] * GBPS

        job = cfg["job"]
        scale = cfg["work_scale"]
        compute = np.asarray(job["compute_s"], np.float64) * scale
        comm = np.asarray(job["comm_bytes"], np.float64) * scale
        iso = compute.sum() + comm.sum() / (cfg["iso_link_gbps"] * GBPS)
        K = len(points)
        self.K = K
        self.P = compute.shape[0]
        self.active = np.zeros((K, self.J), bool)
        for i, p in enumerate(points):
            self.active[i, :int(p["n_jobs"])] = True
        act = self.active
        self.compute = np.where(act[..., None], compute, 0.0).astype(F32)
        self.comm = np.where(act[..., None], comm, 0.0).astype(F32)
        self.iso = np.where(act, iso, 0.0).astype(F32)
        self.straggle_prob = np.where(
            act, job.get("straggle_prob", 0.0), 0.0).astype(F32)
        self.seeds = np.asarray([int(p["seed"]) for p in points], np.int64)
        self.wi = np.asarray([p["variant"] == "WI" for p in points])[:, None]


class FluidSim:
    """All points of a `Fabric` stepped together."""

    def __init__(self, cfg: dict, points: list[dict],
                 quantize: Optional[Callable] = None):
        self.fab = fab = Fabric(cfg, points)
        self.q = quantize
        proto, cc = cfg["protocol"], cfg["cc"]
        if proto["algo"] not in ("reno", "dcqcn"):
            raise ValueError(f"the reference runs Reno and DCQCN, not "
                             f"{proto['algo']!r}")
        if (proto["f_spec"], proto["favoritism"], proto["aggregate_by_job"]
                ) != ("linear", "largest_data_sent", True):
            raise ValueError("the reference computes the linear F over "
                             "largest_data_sent, job-aggregated, only")
        self.ecn = proto["algo"] == "dcqcn"
        self.dt = float(cfg["dt"])
        self.n_ticks = int(round(cfg["sim_time"] / self.dt))
        self.D = max(1, int(round(cc["rtt"] / self.dt)))
        self.tpc = max(1, self.n_ticks // int(cfg["n_chunks"]))
        self.n_chunks = self.n_ticks // self.tpc
        self.max_iters = int(cfg["max_iters_recorded"])
        K, J, N, P = fab.K, fab.J, fab.N, fab.P

        def col(v):
            return np.full((K, 1), v, F32)

        self.slope, self.intercept = col(proto["slope"]), col(
            proto["intercept"])
        self.g, self.gamma = col(proto["g"]), col(proto["gamma"])
        self.one_minus_gamma = F32(1) - self.gamma
        self.init_gap = col(proto["init_comm_gap"])
        self.qmin, self.qmax = col(cfg["red_qmin"]), col(cfg["red_qmax"])
        self.pmax = col(cfg["red_pmax"])
        self.span = self.qmax - self.qmin
        self.rest = F32(1.0) - self.pmax
        self.buffer = F32(cfg["buffer_bytes"])
        self.cap_dt = F32(fab.cap) * F32(self.dt)
        self.mss = F32(cc["mss"])
        self.half_mss = F32(0.5 * cc["mss"])
        self.spj_inv = F32(1.0 / fab.S)
        self.flows_per_job = F32(fab.S)
        total = _fold(fab.comm, 2)                                # [K, J]
        total = np.repeat(total, fab.S, axis=1)
        self.inv_total = F32(1) / np.maximum(total, F32(1))
        self.c = {name: F32(v) for name, v in cc.items()}
        self.c["mss_over_rtt"] = F32(cc["mss"] / cc["rtt"])
        self.c["one_minus_g"] = F32(1.0 - cc["dcqcn_g"])
        self.cut = np.minimum(F32(1) * F32(cc["reno_beta"]), F32(1))
        self.stages = int(cc["fast_recovery_stages"])
        self._kj = (np.arange(K)[:, None], np.arange(J)[None, :])

        z = lambda *s: np.zeros(s, F32)  # noqa: E731
        # the float state (held in the control's precision between ticks)
        self.backlog = z(K, N)
        self.ring_del = z(self.D, K, N)
        self.to_send, self.to_deliver = z(K, N), z(K, N)
        self.comm_start = z(K, N)
        self.t_rem = fab.compute[:, :, 0].copy()
        self.iter_start, self.straggle_extra = z(K, J), z(K, J)
        self.cwnd = np.full((K, N), cc["init_cwnd"], F32)
        self.ssthresh = np.full((K, N), cc["init_ssthresh"], F32)
        self.cooldown = z(K, N)
        self.rate_cur = np.full((K, N), cc["line_rate"], F32)
        self.rate_target = np.full((K, N), cc["line_rate"], F32)
        self.alpha = np.ones((K, N), F32)
        self.t_last_cnp, self.t_last_inc = z(K, N), z(K, N)
        self.t_last_alpha = z(K, N)
        self.bytes_sent, self.ratio, self.prev_ack = z(K, N), z(K, N), z(K, N)
        self.iter_gap = np.broadcast_to(self.init_gap, (K, N)).copy()
        self.max_gap = self.iter_gap.copy()
        # flags and counters
        self.ring_loss = np.zeros((self.D, K, N), bool)
        self.ring_cnp = np.zeros((self.D, K, N), bool)
        self.stage = np.zeros((K, N), np.int32)
        self.phase = np.zeros((K, J), np.int32)
        self.in_comm = np.zeros((K, J), bool)
        self.iter_idx = np.zeros((K, J), np.int32)
        self.iter_times = np.full((K, J, self.max_iters), np.nan, F32)
        self.key = rng.seed_keys(fab.seeds)
        self.tick = 0
        # each point's first tick with an ambiguous draw (n_ticks: none)
        self.first_ambiguous = np.full(K, self.n_ticks, np.int64)

    STATE = ("backlog", "ring_del", "to_send", "to_deliver", "comm_start",
             "t_rem", "iter_start", "straggle_extra", "cwnd", "ssthresh",
             "cooldown", "rate_cur", "rate_target", "alpha", "t_last_cnp",
             "t_last_inc", "t_last_alpha", "bytes_sent", "ratio", "prev_ack",
             "iter_gap", "max_gap")

    # ------------------------------------------------------------------
    def _spread(self, x):
        """Per job [K, J] -> per flow [K, N]."""
        return np.repeat(x, self.fab.S, axis=1)

    def _job_sum(self, x, init=None):
        """Per-job sums of [K, N], folded in flow order onto ``init``."""
        g = x.reshape(x.shape[0], self.fab.J, self.fab.S)
        acc = g[..., 0] if init is None else init + g[..., 0]
        for i in range(1, self.fab.S):
            acc = acc + g[..., i]
        return acc

    def _phase_value(self, table):
        """table[k, j, phase[k, j]]."""
        if self.fab.P == 1:
            return table[:, :, 0]
        return table[self._kj[0], self._kj[1], self.phase]

    def _tick(self, t, loss_u, cnp_u, straggles, strag_amt, acc):
        """One tick of every point at time ``t`` (a float32 scalar).  The
        ``if x.any()`` guards skip updates whose mask is all False; they
        change no value."""
        fab, c, dt = self.fab, self.c, F32(self.dt)
        zero, one = F32(0), F32(1)
        # 1. phase machine: compute countdown, then the comm phase (start
        # offsets are 0: every active job has started)
        running = ~self.in_comm & fab.active
        t_rem = np.where(running, self.t_rem - dt, self.t_rem)
        enter = running & (t_rem <= zero)
        in_comm = self.in_comm | enter
        to_send, to_deliver = self.to_send, self.to_deliver
        if enter.any():
            enter_f = self._spread(enter)
            quota = self._spread(self._phase_value(fab.comm)) * self.spj_inv
            to_send = np.where(enter_f, quota, to_send)
            to_deliver = np.where(enter_f, quota, to_deliver)
            self.comm_start = np.where(enter_f, t, self.comm_start)
        # 2. injection at the rate of the state before the update
        rate = (self.rate_cur if self.ecn
                else self.cwnd * c["mss_over_rtt"])
        active = self._spread(in_comm) & (to_send > zero)
        inj = np.where(active, np.minimum(rate * dt, to_send), zero)
        to_send = to_send - inj
        # 3. the link: RED on enqueue, service, departures
        q_len = _fold(self.backlog, 1)[:, None]                   # [K, 1]
        p_red = (np.minimum(np.maximum((q_len - self.qmin) / self.span,
                                       zero), one) * self.pmax
                 + np.minimum(np.maximum((q_len - self.qmax) / self.qmax,
                                         zero), one) * self.rest)
        over = (q_len >= self.buffer).astype(F32)
        if self.ecn:
            marked = inj * p_red
            dropped = inj * over
        else:
            dropped = inj * np.minimum(p_red + over, one)
        backlog = self.backlog + (inj - dropped)
        tot = _fold(backlog, 1)[:, None]
        serve = np.where(tot > zero, np.minimum(
            self.cap_dt / np.maximum(tot, F32(1e-9)), one), zero)
        delivered = backlog * serve
        self.backlog = backlog - delivered
        p_loss = -np.expm1(-dropped / self.mss)
        loss_evt = loss_u < p_loss
        self._note_ambiguous(loss_u, p_loss)
        to_send = to_send + dropped
        self.to_send = to_send
        # 4. the feedback ring: read this tick's slot, then write it
        ptr = self.tick % self.D
        fb_del = self.ring_del[ptr]
        fb_loss = self.ring_loss[ptr].copy()
        self.ring_del = self.ring_del.copy()
        self.ring_del[ptr] = delivered
        self.ring_loss[ptr] = loss_evt
        if self.ecn:
            fb_cnp = self.ring_cnp[ptr].copy()
            p_cnp = -np.expm1(-marked / self.mss)
            self.ring_cnp[ptr] = cnp_u < p_cnp
            self._note_ambiguous(cnp_u, p_cnp)
        # 5. bytes delivered, phase and iteration ends
        to_deliver = np.maximum(to_deliver - delivered, zero)
        self.to_deliver = to_deliver
        job_done = (to_deliver <= self.half_mss).reshape(
            fab.K, fab.J, fab.S).all(-1)
        comm_done = in_comm & job_done
        if comm_done.any():
            last = self.phase >= fab.P - 1
            iter_done = comm_done & last
            self.phase = np.where(comm_done, np.where(last, 0,
                                                      self.phase + 1),
                                  self.phase).astype(np.int32)
            in_comm = in_comm & ~comm_done
            if iter_done.any():
                kk, jj = np.nonzero(iter_done)
                slot = np.minimum(self.iter_idx[kk, jj], self.max_iters - 1)
                self.iter_times[kk, jj, slot] = t - self.iter_start[kk, jj]
                self.iter_idx = self.iter_idx + iter_done.astype(np.int32)
                self.iter_start = np.where(iter_done, t, self.iter_start)
                self.straggle_extra = np.where(
                    iter_done, np.where(straggles, strag_amt, zero),
                    self.straggle_extra)
            t_rem = np.where(comm_done, self._phase_value(fab.compute)
                             + np.where(iter_done, self.straggle_extra,
                                        zero), t_rem)
        self.in_comm = in_comm
        self.t_rem = t_rem
        # 6. the protocol on the feedback of one round-trip ago
        acks = fb_del / self.mss
        ackb = acks * self.mss
        has_ack = acks > zero
        bytes_sent = self.bytes_sent + ackb
        numer = self._spread(self._job_sum(bytes_sent))
        gap = t - self.prev_ack
        max_gap = np.maximum(self.max_gap, gap)
        boundary = has_ack & (gap > self.g * self.iter_gap)
        ratio_mid = np.minimum(numer * self.inv_total, one)
        bytes_sent = np.where(has_ack, bytes_sent, self.bytes_sent)
        ratio = np.where(has_ack, ratio_mid, self.ratio)
        max_gap = np.where(has_ack, max_gap, self.max_gap)
        if boundary.any():
            gap_upd = (self.one_minus_gamma * self.iter_gap
                       + self.gamma * max_gap)
            bytes_sent = np.where(boundary, zero, bytes_sent)
            ratio = np.where(boundary, zero, ratio)
            self.iter_gap = np.where(boundary, gap_upd, self.iter_gap)
            max_gap = np.where(boundary, self.init_gap, max_gap)
        self.bytes_sent, self.ratio, self.max_gap = bytes_sent, ratio, max_gap
        self.prev_ack = np.where(has_ack, t, self.prev_ack)
        f = np.where(fab.wi, self.slope * ratio + self.intercept, one)
        if self.ecn:
            self._dcqcn(f, fb_cnp, t)
        else:
            self._reno(f, acks, fb_loss)
        # 7. the chunk's trace accumulators
        acc["util"] = acc["util"] + _fold(delivered, 1) / self.cap_dt
        acc["drops"] = acc["drops"] + _fold(dropped, 1) / self.mss
        if self.ecn:
            acc["marks"] = acc["marks"] + _fold(marked, 1) / self.mss
        acc["jobbytes"] = self._job_sum(delivered, init=acc["jobbytes"])
        if self.q is not None:
            for name in self.STATE:
                setattr(self, name, self.q(getattr(self, name)))
        self.tick += 1

    def _note_ambiguous(self, u, p):
        """Mark the points where a draw lies within `AMBIGUOUS_ULPS` ulps
        of its event probability: there two correct float32 ``expm1`` (each
        within an ulp or two, as C libraries and CUDA's are) may decide the
        event either way, and the runs may part from that tick on."""
        near = (p > 0) & (np.abs(u - p) <= AMBIGUOUS_ULPS * np.spacing(p))
        if near.any():
            hit = near.any(axis=1) & (self.first_ambiguous > self.tick)
            self.first_ambiguous[hit] = self.tick

    def _reno(self, f, acks, loss):
        c = self.c
        cwnd = self.cwnd
        in_ss = cwnd < self.ssthresh
        grow_ca = f * acks / np.maximum(cwnd, F32(1e-6))
        cwnd_inc = cwnd + np.where(in_ss, acks, grow_ca)
        cooldown = np.maximum(self.cooldown - c["tick_dt"], F32(0))
        cut = loss & (self.cooldown <= F32(0))
        if cut.any():
            cwnd_cut = np.maximum(self.cut * cwnd, c["min_cwnd"])
            cwnd_inc = np.where(cut, cwnd_cut, cwnd_inc)
            self.ssthresh = np.where(cut, np.maximum(cwnd_cut, F32(2)),
                                     self.ssthresh)
            cooldown = np.where(cut, c["rtt"], cooldown)
        self.cwnd, self.cooldown = cwnd_inc, cooldown

    def _dcqcn(self, f, cnp_sig, now):
        c = self.c
        rate, alpha, target = self.rate_cur, self.alpha, self.rate_target
        lo, hi = c["rate_min"], c["line_rate"]
        cnp = cnp_sig & ((now - self.t_last_cnp) >= c["cnp_interval"])
        alpha_fired = (now - self.t_last_alpha) >= c["alpha_timer"]
        inc_fired = (now - self.t_last_inc) >= c["inc_timer"]
        new_rate, new_target, new_alpha = rate, target, alpha
        stage = self.stage
        if alpha_fired.any():
            new_alpha = np.where(alpha_fired, c["one_minus_g"] * alpha,
                                 alpha)
        if inc_fired.any():
            stage = stage + inc_fired.astype(np.int32)
            in_ai = stage > self.stages
            tgt = np.where(inc_fired & in_ai, target + f * c["rate_ai"],
                           target)
            new_target = np.minimum(tgt, hi)
            step = np.minimum(f, F32(2)) * F32(0.5) * (new_target - rate)
            new_rate = np.where(inc_fired, rate + step, rate)
        if cnp.any():
            md = np.minimum(F32(1) * (F32(1) - alpha / F32(2)), F32(1))
            rate_cut = np.minimum(np.maximum(md * rate, lo), hi)
            new_rate = np.where(cnp, rate_cut, new_rate)
            new_target = np.where(cnp, rate, new_target)
            new_alpha = np.where(cnp, c["one_minus_g"] * alpha
                                 + c["dcqcn_g"], new_alpha)
            stage = np.where(cnp, 0, stage).astype(np.int32)
            self.t_last_cnp = np.where(cnp, now, self.t_last_cnp)
        self.stage = stage
        self.rate_cur = np.minimum(np.maximum(new_rate, lo), hi)
        self.rate_target = np.minimum(np.maximum(new_target, lo), hi)
        self.alpha = np.minimum(np.maximum(new_alpha, F32(0)), F32(1))
        self.t_last_inc = np.where(cnp | inc_fired, now, self.t_last_inc)
        self.t_last_alpha = np.where(cnp | alpha_fired, now,
                                     self.t_last_alpha)

    # ------------------------------------------------------------------
    def run(self, draws=None) -> dict:
        """The whole run: per point iteration times [K, J, I], counts
        [K, J] and the seven traces [K, C, ...].  ``draws`` yields each
        chunk's (loss, CNP, straggle flags, straggle amounts), as
        `chunk_draws` does (the default)."""
        fab = self.fab
        K, J, T = fab.K, fab.J, self.tpc
        names = ("util", "drops", "marks", "incomm", "t", "jobtput",
                 "ratio")
        traces = {n: [] for n in names}
        span = F32(T * self.dt)
        if draws is None:
            draws = chunk_draws(self.key, self.n_chunks, T, fab)
        for _, (loss_u, cnp_u, straggles, strag_amt) in zip(
                range(self.n_chunks), draws):
            acc = dict(util=np.zeros(K, F32), drops=np.zeros(K, F32),
                       marks=np.zeros(K, F32),
                       jobbytes=np.zeros((K, J), F32))
            for i in range(T):
                self._tick(F32(self.tick) * F32(self.dt), loss_u[i],
                           cnp_u[i], straggles[i], strag_amt[i], acc)
            tr = dict(
                util=(acc["util"] / F32(T))[:, None], drops=acc["drops"],
                marks=acc["marks"], incomm=self.in_comm.copy(),
                t=np.full(K, F32(self.tick) * F32(self.dt), F32),
                jobtput=acc["jobbytes"] / span,
                ratio=self._job_sum(self.ratio) / self.flows_per_job)
            for n in names:
                v = tr[n]
                traces[n].append(v if self.q is None else self.q(v))
        return dict(iter_times=self.iter_times, iter_counts=self.iter_idx,
                    first_ambiguous=self.first_ambiguous,
                    ticks_per_chunk=T, dt=self.dt,
                    **{f"trace_{n}": np.stack(v, 1)
                       for n, v in traces.items()})


def chunk_draws(key, n_chunks: int, T: int, fab: Fabric):
    """Each chunk's draws from the points' keys: loss and CNP uniforms,
    straggle flags and straggle amounts."""
    for _ in range(n_chunks):
        key, loss_u, cnp_u, strag_u, samt_u = rng.chunk_uniforms(
            key, T, fab.N, fab.J)
        yield (loss_u, cnp_u, strag_u < fab.straggle_prob,
               (F32(0.05) + F32(0.05) * samt_u) * fab.iso)


def _draw_layout(sim: "FluidSim"):
    """(dtype, shape) of each array of a chunk's draws."""
    T, K, N, J = sim.tpc, sim.fab.K, sim.fab.N, sim.fab.J
    return ((F32, (T, K, N)), (F32, (T, K, N)), (np.bool_, (T, K, J)),
            (F32, (T, K, J)))


def _draw_main() -> None:
    """The draw process: reads ``[cfg, points]`` as one JSON line on
    standard input and writes each chunk's draws to standard output as
    raw arrays (`_draw_layout`)."""
    cfg, points = json.loads(sys.stdin.readline())
    sim = FluidSim(cfg, points)
    out = sys.stdout.buffer
    layout = _draw_layout(sim)
    for chunk in chunk_draws(sim.key, sim.n_chunks, sim.tpc, sim.fab):
        for (dtype, _), a in zip(layout, chunk):
            out.write(np.ascontiguousarray(a, dtype).tobytes())
    out.flush()


def _read_draws(stream, sim: "FluidSim"):
    """Each chunk's draws, read from the draw process's output."""
    layout = _draw_layout(sim)
    for _ in range(sim.n_chunks):
        chunk = []
        for dtype, shape in layout:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            buf = stream.read(n)
            if len(buf) != n:
                raise RuntimeError("the draw process ended early")
            chunk.append(np.frombuffer(buf, dtype).reshape(shape))
        yield tuple(chunk)


def simulate(cfg: dict, points: list[dict],
             quantize: Optional[Callable] = None,
             worker: bool = True) -> dict:
    """Run every point of ``points`` ({variant, n_jobs, seed}) as the
    configuration ``cfg`` states; see `FluidSim.run`.  With ``worker``
    the draws come from a second process (a plain child on a pipe, so
    nothing is written outside it), a chunk ahead of the simulation; it
    is waited for, or killed on an error, before this returns."""
    sim = FluidSim(cfg, points, quantize)
    if not worker:
        return sim.run()
    code = (f"import sys; sys.path.insert(0, {str(BENCH)!r}); "
            "from reference import fluid; fluid._draw_main()")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        proc.stdin.write(json.dumps([cfg, points]).encode() + b"\n")
        proc.stdin.close()
        out = sim.run(_read_draws(proc.stdout, sim))
        if proc.wait(timeout=60) != 0:
            raise RuntimeError(f"the draw process exited {proc.returncode}")
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()


def postprocess(out: dict, i: int, n_jobs: int) -> dict:
    """Point i's results as users read them: each active job's recorded
    iteration times, drops and marks per second, and the traces cut to
    the active jobs."""
    it, counts = out["iter_times"][i], out["iter_counts"][i]
    per_job = [it[j, :min(int(counts[j]), it.shape[1])]
               for j in range(n_jobs)]
    per_job = [x[~np.isnan(x)] for x in per_job]
    sim_t = float(out["trace_t"][i][-1])
    return dict(
        iter_times=per_job,
        drops_per_s=float(out["trace_drops"][i].sum() / max(sim_t, 1e-9)),
        marks_per_s=float(out["trace_marks"][i].sum() / max(sim_t, 1e-9)),
        trace_t=out["trace_t"][i], trace_util=out["trace_util"][i],
        trace_incomm=out["trace_incomm"][i][:, :n_jobs],
        trace_drops=out["trace_drops"][i],
        trace_marks=out["trace_marks"][i],
        trace_jobtput=out["trace_jobtput"][i][:, :n_jobs],
        trace_ratio=out["trace_ratio"][i][:, :n_jobs],
        first_ambiguous=int(out["first_ambiguous"][i]),
        ticks_per_chunk=int(out["ticks_per_chunk"]), dt=out["dt"])
