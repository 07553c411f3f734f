// The simulator's chunk of fabric ticks in one launch, for Hopper (sm_90a).
//
// Redesign, for the card, of the CC tick that replaces the Pallas TPU
// kernel repro/kernels/mltcp_step.py::_kernel: on the TPU one jax.lax.scan
// ran a chunk of ticks as one program with the CC kernel inside; here one
// CTA per sweep point runs `n_ticks` ticks of netsim/engine.py::_tick back
// to back, the fabric and the MLTCP/CC update together, with the point's
// state in shared memory, loaded once and written back once.  The per-tick
// path launched ~165 kernels a tick from the host; this launches one per
// chunk.
//
// What bounds it: neither bytes nor operations.  A tick is a chain of
// dependent phases (job phase machine -> injection -> RED enqueue -> link
// service -> routing and loss draws -> completion -> CC update), each a
// few shared-memory operations and a fold of at most a few dozen adds,
// separated by seven CTA barriers; the points run on separate SMs.  So a
// tick costs the latency of that chain.  The design keeps the chain short:
// every intermediate stays in shared memory, the per-tick inputs are read
// straight from global memory by the thread that uses them, and the sweep
// points need no communication.
//
// Bitwise parity with the per-tick path (the chunk kernel's plain version,
// engine.run_chunk_reference, whose CC update is mltcp_step.cu): built with
// --fmad=false and IEEE division, every op in the torch code's order, the
// folds left to right in flow, link and member order (core/segment.py:
// fold_sum, JobGroups.sum; JobGroups.min is exact), expm1f for torch.expm1,
// the clamps with torch's NaN semantics, and python-float constants
// rounded once to float32 as torch rounds them.
//
// The CTA's threads own flows, links, jobs or (link, flow) elements phase
// by phase, always by the same `for (x = tid; x < count; x += nt)` split,
// so state a thread writes in one phase and reads in a later one is its
// own.  The engine-level options (ECN vs RED, Cassini, the CUBIC epoch
// reset) are runtime branches uniform across the CTA; the CC
// specializations stay template parameters.
//
// Telemetry and faults (netsim/telemetry.py, netsim/faults.py) are the
// template parameter ARMED (bit 0 telemetry, bit 1 faults); ARMED == 0 is
// the unarmed kernel, whose code every armed hook leaves untouched (each
// sits under `if constexpr`).  Which probes, detectors and fault channels
// an armed launch runs are runtime flags uniform across the CTA.  The
// fault row of each tick comes from the host with the chunk's other
// inputs (engine.chunk_inputs ranks the tick against the schedule): the
// churn mask, the blackhole mask and the flapped capacity (cap * scale)
// * dt, and the row index for the re-interleave detector.  The probes
// write their samples straight into the run's ring buffers in global
// memory ([K, cap, W]) from the phase that owns the value: the injection
// rate in phase 2, the queue and RED probability in 3a, the job state in
// 5, cwnd and bytes_ratio in 6.  The detectors' state lives in shared
// memory through the chunk: the iteration-time histogram row of a job is
// its owner's (phase 5); the pair EWMAs, the overlap fold and the
// re-interleave arrays are thread 0's, run serially in pair order after
// its phase-6 flows, on a snapshot of the job state that phase 5 writes
// (the next tick's phase 1 may already be rewriting the live one).  The
// per-job mean F (probe job_f) folds the flows' F after one more barrier.
#include "mltcp_cc.cuh"

namespace netsim_chunk {

using namespace mltcp;

// FLOW_FIELDS of netsim_chunk.py: float per-flow state, [N_FFLOW, K, N]
enum FFlow {
  F_BYTES_SENT, F_RATIO, F_PREV_ACK, F_ITER_GAP, F_MAX_GAP,
  F_CWND, F_SSTHRESH, F_COOLDOWN, F_W_MAX, F_EPOCH, F_RATE_CUR,
  F_RATE_TGT, F_ALPHA, F_T_CNP, F_T_INC, F_T_ALPHA,
  F_TO_SEND, F_TO_DELIVER, F_COMM_START, N_FFLOW
};
// IFLOW_FIELDS: int32 per-flow state, [N_IFLOW, K, N]
enum IFlow { I_STAGE, I_N_BOUNDARIES, N_IFLOW };
// LINK_FIELDS: float per-(link, flow) state, [N_LINK, K, M+1, N]
enum Link { L_BACKLOG, L_TRANSIT, N_LINK };
// RING_FLAG_FIELDS: bool feedback ring, [N_RFLAG, K, D, N]
enum RFlag { R_LOSS, R_CNP, N_RFLAG };
// FJOB_FIELDS: float per-job state, [N_FJOB, K, J]
enum FJob { J_T_REM, J_ITER_START, J_HOLD_UNTIL, J_STRAGGLE_EXTRA, N_FJOB };
// IJOB_FIELDS: int32 per-job state, [N_IJOB, K, J]
enum IJob { J_PHASE_IDX, J_ITER_IDX, J_IN_COMM, N_IJOB };
// POINT_FIELDS: int32 per-point state, [N_POINT, K]
enum Point { P_RING_PTR, P_TICK, N_POINT };
// PARAM_FIELDS: float per-point sweep scalars, [K, N_PARAM]
enum Param {
  Q_SLOPE, Q_INTERCEPT, Q_G, Q_GAMMA, Q_INIT_GAP,
  Q_RED_QMIN, Q_RED_QMAX, Q_RED_PMAX, Q_CASSINI_EPS, N_PARAM
};
// TEL_INT_FIELDS: the interleave detector's scalars and the ring's write
// count, int32 [N_TELI, K]
enum TelI { T_LAST_BAD, T_ITERS_AT_BAD, T_TAIL_BAD, T_TAIL_TICKS,
            T_N_SAMPLES, N_TELI };
// TEL_EV_FIELDS: the re-interleave detector's per-event arrays, int32
// [N_TELEV, K, E]
enum TelEv { E_START_TICK, E_START_ITER, E_END_TICK, E_LAST_BAD,
             E_ITERS_AT_BAD, N_TELEV };
// OPERANDS: the pointer array's order.  State (read at the start and
// written at the end, in place), run constants, the chunk inputs, then
// the run's trace buffers ([K, C, ...], column D_CHUNK written); then the
// armed kernel's: the chunk's fault rows ([T, K, ...]: row index, churn
// mask, blackhole mask, flapped cap * dt), the padded-jobs mask [K, J],
// the telemetry state (EWMAs [K, 2 * P2], TelI, the histogram [K, J, B],
// TelEv) and the rings (samples [K, cap, W], their ticks [K, cap]).
enum Operand {
  O_FFLOW, O_IFLOW, O_LINK, O_RING_DEL, O_RING_FLAGS, O_FJOB, O_IJOB,
  O_POINT, O_ITER_TIMES, O_ACC,
  O_PARAMS, O_FLOW_TOTAL, O_FACTORS, O_JOB_TABLES, O_CASSINI,
  O_STATIC_INTS, O_STATIC_FLOATS,
  O_T, O_STARTED, O_LOSS_U, O_CNP_U, O_STRAGGLES, O_STRAG_AMT,
  O_TRACE_UTIL, O_TRACE_DROPS, O_TRACE_MARKS, O_TRACE_INCOMM, O_TRACE_T,
  O_TRACE_JOBTPUT, O_TRACE_RATIO,
  O_FAULT_IDX, O_CHURN, O_BLACKHOLE, O_CAP_DT, O_JOB_ACTIVE,
  O_TEL_F, O_TEL_I, O_TEL_HIST, O_TEL_EV, O_SERIES, O_SAMPLE_TICK,
  N_OPERAND
};
// DIMS: the int array's order.  D_ARMED is the specialization's ARMED;
// the armed launch's flags and sizes follow: fault channels, the
// detectors, the ring (stride, slots, width), the tail's first tick, the
// sketch's bins, the schedule's rows, and each built-in probe's column
// offset in the ring's rows (-1: not armed), in telemetry.BUILTIN_PROBES
// order.
enum Dim {
  D_K, D_M, D_N, D_J, D_S, D_D, D_P, D_MAX_ITERS, D_TICKS, D_U_STRIDE,
  D_ECN, D_CASSINI, D_CUBIC_RESET, D_N_CHUNKS, D_CHUNK,
  D_ARMED, D_CHURN, D_BLACKHOLE, D_FLAPS, D_JOB_ACTIVE, D_INTERLEAVE,
  D_SKETCH, D_REINTERLEAVE, D_STRIDE, D_CAP, D_SERIES_W, D_TAIL_START,
  D_BINS, D_EVENTS,
  D_OFF_FLOW_CWND, D_OFF_FLOW_RATE, D_OFF_FLOW_RATIO, D_OFF_LINK_QUEUE,
  D_OFF_LINK_MARK_RATE, D_OFF_JOB_INCOMM, D_OFF_JOB_PHASE, D_OFF_JOB_ITER,
  D_OFF_JOB_F, D_OFF_INTERLEAVE_OVERLAP,
  N_DIM
};
// SCALARS: the float array's order (python floats rounded once): the
// probes divide by S_TPC (the chunk's ticks) and S_SPAN (its seconds);
// then the detectors' constants (telemetry.ewma_alpha, the threshold,
// telemetry.sketch_constants)
enum Scalar {
  S_DT, S_MSS, S_HALF_MSS, S_BUFFER, S_TPC, S_SPAN,
  S_ALPHA, S_THRESHOLD, S_SKETCH_LO, S_SKETCH_HI, S_LOG_LO, S_INV_W,
  N_SCALAR
};
// ARMED bits
constexpr int ARM_TEL = 1, ARM_FAULTS = 2;
// per-flow scratch, float then int
enum FX {
  X_INJ, X_DELIVERED, X_DROPPED, X_MARKED, X_FB_DEL, X_TOTAL, X_FACTOR,
  X_NUMER, N_FX
};
enum IX { X_ENTER, X_FB_FLAGS, X_DONE, N_IX };

struct Args {
  void* op[N_OPERAND];
  int dim[N_DIM];
  float sc[N_SCALAR];
  Consts c;
};

// Shared-memory layout of one point, in 4-byte words; the static int and
// float blocks are copied whole, in the layout of netsim_chunk.py's
// STATIC_INTS / STATIC_FLOATS.  An armed launch appends ArmedLayout.
// netsim_chunk.py::smem_words is the same count.
struct Layout {
  int fflow, iflow, fx, ix, link, row, acc_util, ring_del, ring_flags;
  int sints, sfloats, fjob, ijob, acc_jb, enter, pbytes, jnumer, jtab, cas;
  int total;
  __host__ __device__ Layout(int M, int N, int J, int S, int D, int P) {
    const int L = M + 1;
    int o = 0;
    fflow = o; o += N_FFLOW * N;
    iflow = o; o += N_IFLOW * N;
    fx = o; o += N_FX * N;
    ix = o; o += N_IX * N;
    link = o; o += 5 * L * N;       // backlog, transit, dropped, marked, dep
    row = o; o += 3 * L;            // RED probability, overflow, serve ratio
    acc_util = o; o += M;
    ring_del = o; o += D * N;
    ring_flags = o; o += D * N;
    sints = o; o += 2 * N + J * S + J + L * N;
    sfloats = o; o += N + M + 2 * L * N + J;
    fjob = o; o += N_FJOB * J;
    ijob = o; o += N_IJOB * J;
    acc_jb = o; o += J;
    enter = o; o += J;
    pbytes = o; o += J;
    jnumer = o; o += J;
    jtab = o; o += 2 * J * P;       // compute, comm_bytes
    cas = o; o += 2 * J;            // cassini offset, period
    total = o;
  }
};

// The armed kernel's words after Layout::total: per flow the blackholed
// bytes and F * spj_inv; per job the snapshot phase 5 takes for thread 0
// (in_comm, iter_idx, activity) and the padded-jobs mask; the pair EWMAs
// (both, then either), the histogram and the per-event arrays.
struct ArmedLayout {
  int lost, fjob, snap_in, snap_iter, snap_act, ja, ewma, hist, ev, total;
  __host__ __device__ ArmedLayout(int base, int N, int J, int P2, int B,
                                  int E) {
    int o = base;
    lost = o; o += N;
    fjob = o; o += N;
    snap_in = o; o += J;
    snap_iter = o; o += J;
    snap_act = o; o += J;
    ja = o; o += J;
    ewma = o; o += 2 * P2;
    hist = o; o += J * B;
    ev = o; o += N_TELEV * E;
    total = o;
  }
};

// The armed launch's pair count (0 without the interleave detector).
__host__ __device__ inline int n_pairs(const int* dims) {
  const int J = dims[D_J];
  return dims[D_INTERLEAVE] ? J * (J - 1) / 2 : 0;
}

// The armed launch's layout after `base` words (its sizes from the dims).
__host__ __device__ inline ArmedLayout armed_layout(const int* dims,
                                                    int base) {
  const bool tel = (dims[D_ARMED] & ARM_TEL) != 0;
  return ArmedLayout(base, dims[D_N], dims[D_J], tel ? n_pairs(dims) : 0,
                     tel && dims[D_SKETCH] ? dims[D_BINS] : 0,
                     tel && dims[D_REINTERLEAVE] ? dims[D_EVENTS] : 0);
}

// The iteration-time sketch's bin of `x` seconds (telemetry.tick_update:
// clamp, log, scale, clamp, truncate).
__device__ __forceinline__ int sketch_bin(float x, float lo, float hi,
                                          float log_lo, float inv_w,
                                          int bins) {
  const float c = clamp_f(x, lo, hi);
  return (int)clamp_f((logf(c) - log_lo) * inv_w, 0.0f, (float)(bins - 1));
}

// Advance point k by D_TICKS ticks.  Called by all `nt` threads of the
// point's CTA with the same arguments; `smem` holds Layout::total words.
template <int ALGO, int VARIANT, bool AGG, bool FACTORS, int ARMED>
__device__ void run_point(const Args& a, int k, int tid, int nt,
                          float* smem) {
  constexpr bool TEL = (ARMED & ARM_TEL) != 0;
  constexpr bool FLT = (ARMED & ARM_FAULTS) != 0;
  const int K = a.dim[D_K], M = a.dim[D_M], N = a.dim[D_N], J = a.dim[D_J];
  const int S = a.dim[D_S], D = a.dim[D_D], P = a.dim[D_P];
  const int max_iters = a.dim[D_MAX_ITERS], T = a.dim[D_TICKS];
  const long long us = a.dim[D_U_STRIDE];
  const bool ecn = a.dim[D_ECN] != 0, cassini = a.dim[D_CASSINI] != 0;
  const bool cubic_reset =
      ALGO == ALGO_CUBIC && a.dim[D_CUBIC_RESET] != 0;
  const float dt = a.sc[S_DT], mss = a.sc[S_MSS];
  const float half_mss = a.sc[S_HALF_MSS], buffer = a.sc[S_BUFFER];
  const Consts& c = a.c;
  const int L = M + 1, LN = L * N;
  const Layout lay(M, N, J, S, D, P);
  int* const ismem = reinterpret_cast<int*>(smem);

  float* const sf = smem + lay.fflow;
  int* const si = ismem + lay.iflow;
  float* const sx = smem + lay.fx;
  int* const sxi = ismem + lay.ix;
  float* const backlog = smem + lay.link;
  float* const transit = backlog + LN;
  float* const dropped = transit + LN;
  float* const marked = dropped + LN;
  float* const dep = marked + LN;
  float* const p_red = smem + lay.row;
  float* const overflow = p_red + L;
  float* const serve = overflow + L;
  float* const acc_util = smem + lay.acc_util;
  float* const ring_del = smem + lay.ring_del;
  int* const ring_flags = ismem + lay.ring_flags;
  const int* const f2j = ismem + lay.sints;
  const int* const last_link = f2j + N;
  const int* const members = last_link + N;
  const int* const last_phase = members + J * S;
  const int* const prev_link = last_phase + J;
  const float* const spj_inv = smem + lay.sfloats;
  const float* const cap_dt = spj_inv + N;
  const float* const first_hot = cap_dt + M;
  const float* const keep = first_hot + LN;
  const float* const flows_per_job = keep + LN;
  float* const sjf = smem + lay.fjob;
  int* const sji = ismem + lay.ijob;
  float* const acc_jb = smem + lay.acc_jb;
  int* const s_enter = ismem + lay.enter;
  float* const s_pbytes = smem + lay.pbytes;
  float* const s_jnumer = smem + lay.jnumer;
  const float* const s_compute = smem + lay.jtab;
  const float* const s_comm = s_compute + J * P;
  const float* const s_cas = smem + lay.cas;

  const float* const g_params = static_cast<const float*>(a.op[O_PARAMS]);
  const float* const t_in = static_cast<const float*>(a.op[O_T]);
  const bool* const started_in = static_cast<const bool*>(a.op[O_STARTED]);
  const float* const loss_u = static_cast<const float*>(a.op[O_LOSS_U]);
  const float* const cnp_u = static_cast<const float*>(a.op[O_CNP_U]);
  const bool* const straggles = static_cast<const bool*>(a.op[O_STRAGGLES]);
  const float* const strag_amt = static_cast<const float*>(a.op[O_STRAG_AMT]);
  float* const iter_times =
      static_cast<float*>(a.op[O_ITER_TIMES]) + (long long)k * J * max_iters;

  // ---------------- load the point's state (once per chunk) ----------------
  // State operands are field-major, [F, K, ...]: field f of point k starts
  // at (f * K + k) * (the point's size of one field).
  {
    const float* g = static_cast<const float*>(a.op[O_FFLOW]);
    for (int i = tid; i < N_FFLOW * N; i += nt)
      sf[i] = g[((long long)(i / N) * K + k) * N + i % N];
    const int* gi = static_cast<const int*>(a.op[O_IFLOW]);
    for (int i = tid; i < N_IFLOW * N; i += nt)
      si[i] = gi[((long long)(i / N) * K + k) * N + i % N];
    const float* gl = static_cast<const float*>(a.op[O_LINK]);
    for (int i = tid; i < N_LINK * LN; i += nt)
      backlog[i] = gl[((long long)(i / LN) * K + k) * LN + i % LN];
    const float* gr = static_cast<const float*>(a.op[O_RING_DEL]) +
                      (long long)k * D * N;
    const bool* gb = static_cast<const bool*>(a.op[O_RING_FLAGS]);
    const long long ring_k = (long long)k * D * N;
    const long long ring_f = (long long)K * D * N;
    for (int i = tid; i < D * N; i += nt) {
      ring_del[i] = gr[i];
      ring_flags[i] = (gb[R_LOSS * ring_f + ring_k + i] ? 1 : 0) |
                      (gb[R_CNP * ring_f + ring_k + i] ? 2 : 0);
    }
    const float* gt = static_cast<const float*>(a.op[O_FLOW_TOTAL]) +
                      (long long)k * N;
    const float* gfac = static_cast<const float*>(a.op[O_FACTORS]);
    for (int n = tid; n < N; n += nt) {
      sx[X_TOTAL * N + n] = gt[n];
      sx[X_FACTOR * N + n] = FACTORS ? gfac[(long long)k * N + n] : 0.0f;
    }
    const int* gsi = static_cast<const int*>(a.op[O_STATIC_INTS]);
    for (int i = tid; i < 2 * N + J * S + J + LN; i += nt)
      ismem[lay.sints + i] = gsi[i];
    const float* gsf = static_cast<const float*>(a.op[O_STATIC_FLOATS]);
    for (int i = tid; i < N + M + 2 * LN + J; i += nt)
      smem[lay.sfloats + i] = gsf[i];
    const float* gj = static_cast<const float*>(a.op[O_FJOB]);
    for (int i = tid; i < N_FJOB * J; i += nt)
      sjf[i] = gj[((long long)(i / J) * K + k) * J + i % J];
    const int* gji = static_cast<const int*>(a.op[O_IJOB]);
    for (int i = tid; i < N_IJOB * J; i += nt)
      sji[i] = gji[((long long)(i / J) * K + k) * J + i % J];
    const float* gtab = static_cast<const float*>(a.op[O_JOB_TABLES]) +
                        (long long)k * 2 * J * P;
    for (int i = tid; i < 2 * J * P; i += nt) smem[lay.jtab + i] = gtab[i];
    if (cassini) {
      const float* gc = static_cast<const float*>(a.op[O_CASSINI]) +
                        (long long)k * 2 * J;
      for (int i = tid; i < 2 * J; i += nt) smem[lay.cas + i] = gc[i];
    }
    for (int j = tid; j < J; j += nt) acc_jb[j] = 0.0f;
    for (int l = tid; l < M; l += nt) acc_util[l] = 0.0f;
    // the trash row M: no RED, no overflow, no service
    if (tid == 0) p_red[M] = overflow[M] = serve[M] = 0.0f;
  }
  const float* const q = g_params + (long long)k * N_PARAM;
  const Dyn dyn{q[Q_SLOPE], q[Q_INTERCEPT], q[Q_G], q[Q_GAMMA], q[Q_INIT_GAP]};
  const float qmin = q[Q_RED_QMIN], qmax = q[Q_RED_QMAX];
  const float pmax = q[Q_RED_PMAX], eps = q[Q_CASSINI_EPS];
  const float span = qmax - qmin, rest = 1.0f - pmax;
  const int* const gpoint = static_cast<const int*>(a.op[O_POINT]);
  int ptr = gpoint[P_RING_PTR * K + k], tick = gpoint[P_TICK * K + k];
  float acc_drops = 0.0f, acc_marks = 0.0f;  // thread 0's

  // ---------------- the armed kernel's flags, operands and state ----------
  // (all constant and dead in the unarmed kernel)
  const bool churn = FLT && a.dim[D_CHURN] != 0;
  const bool bhole = FLT && a.dim[D_BLACKHOLE] != 0;
  const bool flaps = FLT && a.dim[D_FLAPS] != 0;
  const bool interleave = TEL && a.dim[D_INTERLEAVE] != 0;
  const bool sketch = TEL && a.dim[D_SKETCH] != 0;
  const bool reint = TEL && FLT && a.dim[D_REINTERLEAVE] != 0;
  const int stride = TEL ? a.dim[D_STRIDE] : 1;
  const int cap = TEL ? a.dim[D_CAP] : 1;
  const int W = TEL ? a.dim[D_SERIES_W] : 0;
  const int bins = TEL ? a.dim[D_BINS] : 0;
  const int E = TEL ? a.dim[D_EVENTS] : 0;
  const int P2 = TEL ? n_pairs(a.dim) : 0;
  const int tail_start = TEL ? a.dim[D_TAIL_START] : 0;
  const int off_cwnd = TEL ? a.dim[D_OFF_FLOW_CWND] : -1;
  const int off_rate = TEL ? a.dim[D_OFF_FLOW_RATE] : -1;
  const int off_ratio = TEL ? a.dim[D_OFF_FLOW_RATIO] : -1;
  const int off_queue = TEL ? a.dim[D_OFF_LINK_QUEUE] : -1;
  const int off_mark = TEL ? a.dim[D_OFF_LINK_MARK_RATE] : -1;
  const int off_incomm = TEL ? a.dim[D_OFF_JOB_INCOMM] : -1;
  const int off_phase = TEL ? a.dim[D_OFF_JOB_PHASE] : -1;
  const int off_iter = TEL ? a.dim[D_OFF_JOB_ITER] : -1;
  const int off_f = TEL ? a.dim[D_OFF_JOB_F] : -1;
  const int off_overlap = TEL ? a.dim[D_OFF_INTERLEAVE_OVERLAP] : -1;
  const bool jobf = off_f >= 0;
  const float alpha = TEL ? a.sc[S_ALPHA] : 0.0f;
  const float threshold = TEL ? a.sc[S_THRESHOLD] : 0.0f;
  const float s_lo = TEL ? a.sc[S_SKETCH_LO] : 0.0f;
  const float s_hi = TEL ? a.sc[S_SKETCH_HI] : 0.0f;
  const float log_lo = TEL ? a.sc[S_LOG_LO] : 0.0f;
  const float inv_w = TEL ? a.sc[S_INV_W] : 0.0f;
  const ArmedLayout alay =
      ARMED != 0 ? armed_layout(a.dim, lay.total) : ArmedLayout(0, 0, 0, 0, 0, 0);
  float* const x_lost = smem + alay.lost;
  float* const x_fjob = smem + alay.fjob;
  int* const snap_in = ismem + alay.snap_in;
  int* const snap_iter = ismem + alay.snap_iter;
  int* const snap_act = ismem + alay.snap_act;
  int* const s_ja = ismem + alay.ja;
  float* const ewma = smem + alay.ewma;
  int* const hist = ismem + alay.hist;
  int* const ev = ismem + alay.ev;
  const int* const fidx_in = static_cast<const int*>(a.op[O_FAULT_IDX]);
  const bool* const churn_in = static_cast<const bool*>(a.op[O_CHURN]);
  const bool* const bh_in = static_cast<const bool*>(a.op[O_BLACKHOLE]);
  const float* const capdt_in = static_cast<const float*>(a.op[O_CAP_DT]);
  float* const series = static_cast<float*>(a.op[O_SERIES]) +
                        (TEL ? (long long)k * cap * W : 0);
  int* const sample_tick =
      static_cast<int*>(a.op[O_SAMPLE_TICK]) + (TEL ? (long long)k * cap : 0);
  // thread 0's detector scalars (TelI)
  int last_bad = 0, iters_at_bad = 0, tail_bad = 0, tail_ticks = 0;
  int n_samples = 0;
  if constexpr (TEL) {
    const bool* gja = static_cast<const bool*>(a.op[O_JOB_ACTIVE]);
    const bool has_ja = a.dim[D_JOB_ACTIVE] != 0;
    for (int j = tid; j < J; j += nt)
      s_ja[j] = (!has_ja || gja[(long long)k * J + j]) ? 1 : 0;
    const float* gtf = static_cast<const float*>(a.op[O_TEL_F]) +
                       (long long)k * 2 * P2;
    for (int i = tid; i < 2 * P2; i += nt) ewma[i] = gtf[i];
    const int* gh = static_cast<const int*>(a.op[O_TEL_HIST]) +
                    (long long)k * J * bins;
    for (int i = tid; i < J * bins; i += nt) hist[i] = gh[i];
    const int* gev = static_cast<const int*>(a.op[O_TEL_EV]);
    for (int i = tid; i < N_TELEV * E; i += nt)
      ev[i] = gev[((long long)(i / E) * K + k) * E + i % E];
    const int* gti = static_cast<const int*>(a.op[O_TEL_I]);
    last_bad = gti[T_LAST_BAD * K + k];
    iters_at_bad = gti[T_ITERS_AT_BAD * K + k];
    tail_bad = gti[T_TAIL_BAD * K + k];
    tail_ticks = gti[T_TAIL_TICKS * K + k];
    n_samples = gti[T_N_SAMPLES * K + k];
  }
  __syncthreads();

  for (int it = 0; it < T; ++it) {
    const long long row = (long long)it * K + k;
    const float tc = t_in[row];
    // this tick's ring sample: its slot's row of the point's ring
    bool take = false;
    long long srow = 0;
    if constexpr (TEL) {
      take = tick % stride == 0;
      srow = (long long)((tick / stride) % cap) * W;
    }

    // 1. job phase machine: compute countdown -> comm-phase entry
    for (int j = tid; j < J; j += nt) {
      bool in_comm = sji[J_IN_COMM * J + j] != 0;
      const bool running = !in_comm && started_in[row * J + j];
      float t_rem = sjf[J_T_REM * J + j];
      t_rem = running ? t_rem - dt : t_rem;
      sjf[J_T_REM * J + j] = t_rem;
      const bool compute_done = running && (t_rem <= 0.0f);
      bool enter = compute_done;
      if (cassini) {
        // comm may only start on the slot grid (+/- eps); period <= 0
        // disables the agent for that job
        const float off = s_cas[j], period = s_cas[J + j];
        const float hold_until = sjf[J_HOLD_UNTIL * J + j];
        const bool on = period > 0.0f;
        const float per = clamp_min_f(period, (float)1e-6);
        const float k_slot = ceilf((tc - off) / per);
        const float next_slot = off + k_slot * per;
        const bool near =
            fabsf(nearbyintf((tc - off) / per) * per + off - tc) <= eps;
        const float hold =
            (compute_done && on && !near && (hold_until <= tc)) ? next_slot
                                                                : hold_until;
        enter = compute_done && (!on || near || (tc >= hold));
        sjf[J_HOLD_UNTIL * J + j] = hold;
      }
      in_comm = in_comm || enter;
      if constexpr (FLT) {
        // churn: a departed job's comm phase is force-exited
        if (churn) in_comm = in_comm && churn_in[row * J + j];
      }
      sji[J_IN_COMM * J + j] = in_comm ? 1 : 0;
      s_enter[j] = enter ? 1 : 0;
      s_pbytes[j] = s_comm[j * P + sji[J_PHASE_IDX * J + j]];
    }
    __syncthreads();

    // 2. entering flows pick up their quota; injection at the CC rate;
    //    this tick's feedback leaves the ring
    for (int n = tid; n < N; n += nt) {
      const int j = f2j[n];
      const bool enter_f = s_enter[j] != 0;
      const float quota = s_pbytes[j] * spj_inv[n];
      float to_send = sf[F_TO_SEND * N + n];
      to_send = enter_f ? quota : to_send;
      if (enter_f) {
        sf[F_TO_DELIVER * N + n] = quota;
        sf[F_COMM_START * N + n] = tc;
      }
      const float rate = ALGO == ALGO_DCQCN
                             ? sf[F_RATE_CUR * N + n]
                             : sf[F_CWND * N + n] * c.v[C_MSS_OVER_RTT];
      const bool active = sji[J_IN_COMM * J + j] != 0 && (to_send > 0.0f);
      float inj = active ? minimum_f(rate * dt, to_send) : 0.0f;
      sf[F_TO_SEND * N + n] = to_send - inj;
      if constexpr (FLT) {
        // a blackholed flow's injected bytes vanish at the first hop, as
        // drops (folded into dropped_f in 3c)
        if (bhole) {
          const float lost = bh_in[row * N + n] ? inj : 0.0f;
          inj = inj - lost;
          x_lost[n] = lost;
        }
      }
      if constexpr (TEL) {
        if (take && off_rate >= 0) series[srow + off_rate + n] = rate;
      }
      sx[X_INJ * N + n] = inj;
      sxi[X_ENTER * N + n] = enter_f ? 1 : 0;
      sx[X_FB_DEL * N + n] = ring_del[ptr * N + n];
      sxi[X_FB_FLAGS * N + n] = ring_flags[ptr * N + n];
    }
    // 3a. RED probability and taildrop from the queues before enqueue
    for (int l = tid; l < M; l += nt) {
      float q_len = backlog[l * N];
      for (int n = 1; n < N; ++n) q_len = q_len + backlog[l * N + n];
      const float ramp1 = clamp_f((q_len - qmin) / span, 0.0f, 1.0f) * pmax;
      const float ramp2 = clamp_f((q_len - qmax) / qmax, 0.0f, 1.0f) * rest;
      p_red[l] = ramp1 + ramp2;
      overflow[l] = q_len >= buffer ? 1.0f : 0.0f;
      if constexpr (TEL) {
        if (take) {
          if (off_queue >= 0) series[srow + off_queue + l] = q_len;
          if (off_mark >= 0) series[srow + off_mark + l] = ramp1 + ramp2;
        }
      }
    }
    __syncthreads();

    // 3b. enqueue with RED marks / drops (row M stays 0)
    for (int e = tid; e < LN; e += nt) {
      const int l = e / N, n = e - l * N;
      const float incoming = transit[e] + first_hot[e] * sx[X_INJ * N + n];
      float drop_frac;
      if (ecn) {
        marked[e] = incoming * p_red[l];
        drop_frac = overflow[l];
      } else {
        drop_frac = clamp_max_f(p_red[l] + overflow[l], 1.0f);
      }
      const float d = incoming * drop_frac;
      dropped[e] = d;
      backlog[e] = backlog[e] + (incoming - d);
    }
    __syncthreads();

    // 3c. service ratio per link; per-flow drops -> loss / CNP events
    for (int l = tid; l < M; l += nt) {
      float tot = backlog[l * N];
      for (int n = 1; n < N; ++n) tot = tot + backlog[l * N + n];
      // a flap scales the service capacity only (acc_util keeps cap_dt)
      const float cdt = FLT && flaps ? capdt_in[row * M + l] : cap_dt[l];
      serve[l] = tot > 0.0f
                     ? clamp_max_f(cdt / clamp_min_f(tot, (float)1e-9), 1.0f)
                     : 0.0f;
    }
    for (int n = tid; n < N; n += nt) {
      float dropped_f = dropped[n];
      for (int l = 1; l < M; ++l) dropped_f = dropped_f + dropped[l * N + n];
      if constexpr (FLT) {
        if (bhole) dropped_f = dropped_f + x_lost[n];
      }
      const bool loss_evt = loss_u[row * us + n] < -expm1f(-dropped_f / mss);
      bool cnp_evt = false;
      float marked_f = 0.0f;
      if (ecn) {
        marked_f = marked[n];
        for (int l = 1; l < M; ++l) marked_f = marked_f + marked[l * N + n];
        cnp_evt = cnp_u[row * us + n] < -expm1f(-marked_f / mss);
      }
      // dropped bytes must be retransmitted
      sf[F_TO_SEND * N + n] = sf[F_TO_SEND * N + n] + dropped_f;
      ring_flags[ptr * N + n] = (loss_evt ? 1 : 0) | (cnp_evt ? 2 : 0);
      sx[X_DROPPED * N + n] = dropped_f;
      sx[X_MARKED * N + n] = marked_f;
    }
    __syncthreads();

    // 3d. serve
    for (int e = tid; e < LN; e += nt) {
      const float d = backlog[e] * serve[e / N];
      dep[e] = d;
      backlog[e] = backlog[e] - d;
    }
    if (tid == 0) {
      float drops = sx[X_DROPPED * N];
      for (int n = 1; n < N; ++n) drops = drops + sx[X_DROPPED * N + n];
      acc_drops = acc_drops + drops / mss;
      if (ecn) {
        float marks = sx[X_MARKED * N];
        for (int n = 1; n < N; ++n) marks = marks + sx[X_MARKED * N + n];
        acc_marks = acc_marks + marks / mss;
      }
    }
    __syncthreads();

    // 3e. route departures: delivered at the last link, forwarded to the
    //     next; 4. delivered bytes into the ring; 5. byte accounting
    for (int e = tid; e < LN; e += nt) {
      const int l = e / N, n = e - l * N;
      const int src = prev_link[e] * N + n;
      transit[e] = dep[src] * keep[src];
    }
    for (int n = tid; n < N; n += nt) {
      const float delivered = dep[last_link[n] * N + n];
      ring_del[ptr * N + n] = delivered;
      sx[X_DELIVERED * N + n] = delivered;
      const float to_deliver =
          clamp_min_f(sf[F_TO_DELIVER * N + n] - delivered, 0.0f);
      sf[F_TO_DELIVER * N + n] = to_deliver;
      sxi[X_DONE * N + n] = to_deliver <= half_mss ? 1 : 0;
      if (AGG) {
        const float acks = sx[X_FB_DEL * N + n] / mss;
        sx[X_NUMER * N + n] = sf[F_BYTES_SENT * N + n] + acks * mss;
      }
    }
    for (int l = tid; l < M; l += nt) {
      float util = dep[l * N];
      for (int n = 1; n < N; ++n) util = util + dep[l * N + n];
      acc_util[l] = acc_util[l] + util / cap_dt[l];
    }
    __syncthreads();

    // 5. comm-phase completion, iteration bookkeeping, stragglers; the
    //    per-job folds in member order
    for (int j = tid; j < J; j += nt) {
      const int* mem = members + j * S;
      bool all_done = true;
      for (int s = 0; s < S; ++s)
        if (mem[s] >= 0) all_done = all_done && sxi[X_DONE * N + mem[s]] != 0;
      bool in_comm = sji[J_IN_COMM * J + j] != 0;
      const bool comm_done = in_comm && all_done;
      const int phase_idx = sji[J_PHASE_IDX * J + j];
      const bool last = phase_idx >= last_phase[j];
      const bool iter_done = comm_done && last;
      const int new_phase =
          comm_done ? (last ? 0 : phase_idx + 1) : phase_idx;
      sji[J_PHASE_IDX * J + j] = new_phase;
      sji[J_IN_COMM * J + j] = (in_comm && !comm_done) ? 1 : 0;
      const float iter_start = sjf[J_ITER_START * J + j];
      const int iter_idx = sji[J_ITER_IDX * J + j];
      if (iter_done) {
        const int slot = iter_idx < max_iters - 1 ? iter_idx : max_iters - 1;
        iter_times[j * max_iters + slot] = tc - iter_start;
        sji[J_ITER_IDX * J + j] = iter_idx + 1;
        sjf[J_ITER_START * J + j] = tc;
        sjf[J_STRAGGLE_EXTRA * J + j] =
            straggles[row * J + j] ? strag_amt[row * J + j] : 0.0f;
      }
      if (comm_done) {
        const float extra = iter_done ? sjf[J_STRAGGLE_EXTRA * J + j] : 0.0f;
        sjf[J_T_REM * J + j] = s_compute[j * P + new_phase] + extra;
      }
      if constexpr (TEL) {
        // the iteration-time sketch (the job's row is its owner's), the
        // job probes, and the snapshot thread 0's detectors read
        const bool in_post = in_comm && !comm_done;
        const int iter_post = iter_done ? iter_idx + 1 : iter_idx;
        if (sketch && iter_done)
          hist[j * bins + sketch_bin(tc - iter_start, s_lo, s_hi, log_lo,
                                     inv_w, bins)] += 1;
        bool act = s_ja[j] != 0;
        if constexpr (FLT) {
          if (churn) act = act && churn_in[row * J + j];
        }
        snap_in[j] = in_post ? 1 : 0;
        snap_iter[j] = iter_post;
        snap_act[j] = act ? 1 : 0;
        if (take) {
          if (off_incomm >= 0)
            series[srow + off_incomm + j] = in_post ? 1.0f : 0.0f;
          if (off_phase >= 0) series[srow + off_phase + j] = (float)new_phase;
          if (off_iter >= 0) series[srow + off_iter + j] = (float)iter_post;
        }
      }
      // a member slot past the job's last flow adds 0.0, as the gather's
      // fill does
      const float* del = sx + X_DELIVERED * N;
      float jb = acc_jb[j] + (mem[0] >= 0 ? del[mem[0]] : 0.0f);
      for (int s = 1; s < S; ++s) jb = jb + (mem[s] >= 0 ? del[mem[s]] : 0.0f);
      acc_jb[j] = jb;
      if (AGG) {
        const float* nx = sx + X_NUMER * N;
        float nu = mem[0] >= 0 ? nx[mem[0]] : 0.0f;
        for (int s = 1; s < S; ++s) nu = nu + (mem[s] >= 0 ? nx[mem[s]] : 0.0f);
        s_jnumer[j] = nu;
      }
    }
    __syncthreads();

    // 6. protocol update on the delayed feedback; CUBIC epoch reset
    for (int n = tid; n < N; n += nt) {
      Flow s;
      s.bytes_sent = sf[F_BYTES_SENT * N + n];
      s.ratio = sf[F_RATIO * N + n];
      s.prev_ack = sf[F_PREV_ACK * N + n];
      s.iter_gap = sf[F_ITER_GAP * N + n];
      s.max_gap = sf[F_MAX_GAP * N + n];
      s.cwnd = sf[F_CWND * N + n];
      s.ssthresh = sf[F_SSTHRESH * N + n];
      s.cooldown = sf[F_COOLDOWN * N + n];
      s.w_max = sf[F_W_MAX * N + n];
      s.epoch = sf[F_EPOCH * N + n];
      s.rate_cur = sf[F_RATE_CUR * N + n];
      s.rate_tgt = sf[F_RATE_TGT * N + n];
      s.alpha = sf[F_ALPHA * N + n];
      s.t_cnp = sf[F_T_CNP * N + n];
      s.t_inc = sf[F_T_INC * N + n];
      s.t_alpha = sf[F_T_ALPHA * N + n];
      s.stage = si[I_STAGE * N + n];
      Signals x;
      x.acks = sx[X_FB_DEL * N + n] / mss;
      x.ack_bytes = x.acks * mss;
      const int flags = sxi[X_FB_FLAGS * N + n];
      x.loss = (flags & 1) != 0;
      x.cnp = (flags & 2) != 0;
      x.total_bytes = sx[X_TOTAL * N + n];
      x.job_numer = AGG ? s_jnumer[f2j[n]] : 0.0f;
      x.factor = sx[X_FACTOR * N + n];
      const bool boundary =
          cc_update<ALGO, VARIANT, AGG, FACTORS>(s, x, dyn, tc, c);
      si[I_N_BOUNDARIES * N + n] += boundary ? 1 : 0;
      if (cubic_reset && sxi[X_ENTER * N + n] != 0) {
        s.epoch = tc;
        s.w_max = s.cwnd;
      }
      if constexpr (TEL) {
        if (jobf) {
          // F of the post-update detection state (core.f_values)
          float f = 1.0f;
          if (VARIANT != VAR_OFF) f = dyn.slope * s.ratio + dyn.intercept;
          if (FACTORS) f = x.factor >= 0.0f ? x.factor : f;
          x_fjob[n] = f * spj_inv[n];
        }
        if (take) {
          if (off_cwnd >= 0) series[srow + off_cwnd + n] = s.cwnd;
          if (off_ratio >= 0) series[srow + off_ratio + n] = s.ratio;
        }
      }
      sf[F_BYTES_SENT * N + n] = s.bytes_sent;
      sf[F_RATIO * N + n] = s.ratio;
      sf[F_PREV_ACK * N + n] = s.prev_ack;
      sf[F_ITER_GAP * N + n] = s.iter_gap;
      sf[F_MAX_GAP * N + n] = s.max_gap;
      sf[F_CWND * N + n] = s.cwnd;
      sf[F_SSTHRESH * N + n] = s.ssthresh;
      sf[F_COOLDOWN * N + n] = s.cooldown;
      sf[F_W_MAX * N + n] = s.w_max;
      sf[F_EPOCH * N + n] = s.epoch;
      sf[F_RATE_CUR * N + n] = s.rate_cur;
      sf[F_RATE_TGT * N + n] = s.rate_tgt;
      sf[F_ALPHA * N + n] = s.alpha;
      sf[F_T_CNP * N + n] = s.t_cnp;
      sf[F_T_INC * N + n] = s.t_inc;
      sf[F_T_ALPHA * N + n] = s.t_alpha;
      si[I_STAGE * N + n] = s.stage;
    }
    if constexpr (TEL) {
      if (tid == 0) {
        if (interleave) {
          // the pair EWMAs and the overlap, folded in pair order
          // (telemetry.tick_update)
          float acc_pw = 0.0f, acc_w = 0.0f;
          int p = 0;
          for (int ja = 0; ja < J; ++ja)
            for (int jb = ja + 1; jb < J; ++jb, ++p) {
              const bool in_a = snap_in[ja] != 0, in_b = snap_in[jb] != 0;
              const float w =
                  (snap_act[ja] != 0 && snap_act[jb] != 0) ? 1.0f : 0.0f;
              const float both = w * ((in_a && in_b) ? 1.0f : 0.0f);
              const float either = w * ((in_a || in_b) ? 1.0f : 0.0f);
              float eb = ewma[p], ee = ewma[P2 + p];
              eb = eb + alpha * (both - eb);
              ee = ee + alpha * (either - ee);
              ewma[p] = eb;
              ewma[P2 + p] = ee;
              const float pw = (eb / clamp_min_f(ee, (float)1e-6)) * w;
              acc_pw = p == 0 ? pw : acc_pw + pw;
              acc_w = p == 0 ? w : acc_w + w;
            }
          const float overlap =
              P2 > 0 ? acc_pw / clamp_min_f(acc_w, 1.0f) : 0.0f;
          const bool bad = overlap > threshold;
          int cur_iters = 0;
          for (int j = 0; j < J; ++j) {
            const int v = snap_act[j] != 0 ? snap_iter[j] : 0;
            cur_iters = j == 0 ? v : (v > cur_iters ? v : cur_iters);
          }
          const bool in_tail = tick >= tail_start;
          if (bad) {
            last_bad = tick;
            iters_at_bad = cur_iters;
          }
          tail_bad += (bad && in_tail) ? 1 : 0;
          tail_ticks += in_tail ? 1 : 0;
          if (reint) {
            // segment by the current fault row
            const int e = fidx_in[row];
            if (ev[E_START_TICK * E + e] < 0) {
              ev[E_START_TICK * E + e] = tick;
              ev[E_START_ITER * E + e] = cur_iters;
            }
            ev[E_END_TICK * E + e] = tick;
            if (bad) {
              ev[E_LAST_BAD * E + e] = tick;
              ev[E_ITERS_AT_BAD * E + e] = cur_iters;
            }
          }
          if (take && off_overlap >= 0) series[srow + off_overlap] = overlap;
        }
        if (take) {
          sample_tick[(tick / stride) % cap] = tick;
          n_samples += 1;
        }
      }
      if (jobf) {
        // the per-job mean F: each job folds its flows' F * spj_inv in
        // member order (JobGroups.sum)
        __syncthreads();
        for (int j = tid; j < J; j += nt) {
          const int* mem = members + j * S;
          float v = mem[0] >= 0 ? x_fjob[mem[0]] : 0.0f;
          for (int s2 = 1; s2 < S; ++s2)
            v = v + (mem[s2] >= 0 ? x_fjob[mem[s2]] : 0.0f);
          if (take) series[srow + off_f + j] = v;
        }
      }
    }
    ptr = ptr + 1 == D ? 0 : ptr + 1;
    tick += 1;
    // the next tick's first phase touches nothing this phase reads or
    // writes (its flow scratch is per thread), so no barrier here
  }
  __syncthreads();

  // ---------------- write the point's state back ----------------
  {
    float* g = static_cast<float*>(a.op[O_FFLOW]);
    for (int i = tid; i < N_FFLOW * N; i += nt)
      g[((long long)(i / N) * K + k) * N + i % N] = sf[i];
    int* gi = static_cast<int*>(a.op[O_IFLOW]);
    for (int i = tid; i < N_IFLOW * N; i += nt)
      gi[((long long)(i / N) * K + k) * N + i % N] = si[i];
    float* gl = static_cast<float*>(a.op[O_LINK]);
    for (int i = tid; i < N_LINK * LN; i += nt)
      gl[((long long)(i / LN) * K + k) * LN + i % LN] = backlog[i];
    float* gr = static_cast<float*>(a.op[O_RING_DEL]) + (long long)k * D * N;
    bool* gb = static_cast<bool*>(a.op[O_RING_FLAGS]);
    const long long ring_k = (long long)k * D * N;
    const long long ring_f = (long long)K * D * N;
    for (int i = tid; i < D * N; i += nt) {
      gr[i] = ring_del[i];
      gb[R_LOSS * ring_f + ring_k + i] = (ring_flags[i] & 1) != 0;
      gb[R_CNP * ring_f + ring_k + i] = (ring_flags[i] & 2) != 0;
    }
    float* gj = static_cast<float*>(a.op[O_FJOB]);
    for (int i = tid; i < N_FJOB * J; i += nt)
      gj[((long long)(i / J) * K + k) * J + i % J] = sjf[i];
    int* gji = static_cast<int*>(a.op[O_IJOB]);
    for (int i = tid; i < N_IJOB * J; i += nt)
      gji[((long long)(i / J) * K + k) * J + i % J] = sji[i];
    // ACC layout: acc_util [K, M], acc_drops [K], acc_marks [K],
    // acc_jobbytes [K, J], one after the other
    float* gacc = static_cast<float*>(a.op[O_ACC]);
    for (int l = tid; l < M; l += nt) gacc[(long long)k * M + l] = acc_util[l];
    float* gjb = gacc + (long long)K * (M + 2);
    for (int j = tid; j < J; j += nt) gjb[(long long)k * J + j] = acc_jb[j];
    if (tid == 0) {
      gacc[(long long)K * M + k] = acc_drops;
      gacc[(long long)K * (M + 1) + k] = acc_marks;
      int* gp = static_cast<int*>(a.op[O_POINT]);
      gp[P_RING_PTR * K + k] = ptr;
      gp[P_TICK * K + k] = tick;
    }
    if constexpr (TEL) {
      float* gtf = static_cast<float*>(a.op[O_TEL_F]) + (long long)k * 2 * P2;
      for (int i = tid; i < 2 * P2; i += nt) gtf[i] = ewma[i];
      int* gh = static_cast<int*>(a.op[O_TEL_HIST]) +
                (long long)k * J * bins;
      for (int i = tid; i < J * bins; i += nt) gh[i] = hist[i];
      int* gev = static_cast<int*>(a.op[O_TEL_EV]);
      for (int i = tid; i < N_TELEV * E; i += nt)
        gev[((long long)(i / E) * K + k) * E + i % E] = ev[i];
      if (tid == 0) {
        int* gti = static_cast<int*>(a.op[O_TEL_I]);
        gti[T_LAST_BAD * K + k] = last_bad;
        gti[T_ITERS_AT_BAD * K + k] = iters_at_bad;
        gti[T_TAIL_BAD * K + k] = tail_bad;
        gti[T_TAIL_TICKS * K + k] = tail_ticks;
        gti[T_N_SAMPLES * K + k] = n_samples;
      }
    }
  }

  // ---------------- the chunk's probes (engine._chunk_probes) ----------------
  {
    const long long col = (long long)k * a.dim[D_N_CHUNKS] + a.dim[D_CHUNK];
    float* util = static_cast<float*>(a.op[O_TRACE_UTIL]) + col * M;
    for (int l = tid; l < M; l += nt) util[l] = acc_util[l] / a.sc[S_TPC];
    bool* incomm = static_cast<bool*>(a.op[O_TRACE_INCOMM]) + col * J;
    float* jobtput = static_cast<float*>(a.op[O_TRACE_JOBTPUT]) + col * J;
    float* ratio = static_cast<float*>(a.op[O_TRACE_RATIO]) + col * J;
    const float* r = sf + F_RATIO * N;
    for (int j = tid; j < J; j += nt) {
      incomm[j] = sji[J_IN_COMM * J + j] != 0;
      jobtput[j] = acc_jb[j] / a.sc[S_SPAN];
      const int* mem = members + j * S;
      float sum = mem[0] >= 0 ? r[mem[0]] : 0.0f;
      for (int s = 1; s < S; ++s) sum = sum + (mem[s] >= 0 ? r[mem[s]] : 0.0f);
      ratio[j] = sum / flows_per_job[j];
    }
    if (tid == 0) {
      static_cast<float*>(a.op[O_TRACE_DROPS])[col] = acc_drops;
      static_cast<float*>(a.op[O_TRACE_MARKS])[col] = acc_marks;
      static_cast<float*>(a.op[O_TRACE_T])[col] = (float)tick * dt;
    }
  }
}

inline void fill_args(Args& a, void* const* operands, const int* dims,
                      const float* scalars, const float* consts,
                      int fast_recovery_stages) {
  for (int i = 0; i < N_OPERAND; ++i) a.op[i] = operands[i];
  for (int i = 0; i < N_DIM; ++i) a.dim[i] = dims[i];
  for (int i = 0; i < N_SCALAR; ++i) a.sc[i] = scalars[i];
  for (int i = 0; i < N_CONST; ++i) a.c.v[i] = consts[i];
  a.c.fast_recovery_stages = fast_recovery_stages;
}

inline long long smem_bytes(const int* dims) {
  const Layout lay(dims[D_M], dims[D_N], dims[D_J], dims[D_S], dims[D_D],
                   dims[D_P]);
  return 4LL * (dims[D_ARMED] ? armed_layout(dims, lay.total).total
                              : lay.total);
}

// Host-side dispatch over the chunk kernel's specializations: the CC
// specializations of mltcp::dispatch unarmed (ARMED = 0), and for each
// ARMED in 1..3 the ones the telemetry and fault plans run (Reno, CUBIC,
// DCQCN; OFF and WI; job-aggregated statistics; no Static factors,
// netsim_chunk.py::ARMED_SPECIALIZATIONS).  Returns -1 for one it does
// not instantiate.
template <class F>
struct Unarmed {
  template <int ALGO, int VARIANT, bool AGG, bool FACTORS, class... A>
  static int run(A&&... a) {
    return F::template run<ALGO, VARIANT, AGG, FACTORS, 0>(a...);
  }
};
template <class F, int ALGO, int ARMED, class... A>
int dispatch_armed_variant(int variant, A&&... a) {
  if (variant == VAR_OFF)
    return F::template run<ALGO, VAR_OFF, true, false, ARMED>(a...);
  if (variant == VAR_WI)
    return F::template run<ALGO, VAR_WI, true, false, ARMED>(a...);
  return -1;
}
template <class F, int ARMED, class... A>
int dispatch_armed_algo(int algo, int variant, A&&... a) {
  switch (algo) {
    case ALGO_RENO:
      return dispatch_armed_variant<F, ALGO_RENO, ARMED>(variant, a...);
    case ALGO_CUBIC:
      return dispatch_armed_variant<F, ALGO_CUBIC, ARMED>(variant, a...);
    case ALGO_DCQCN:
      return dispatch_armed_variant<F, ALGO_DCQCN, ARMED>(variant, a...);
  }
  return -1;
}
template <class F, class... A>
int dispatch_chunk(int armed, int algo, int variant, bool agg, bool fac,
                   A&&... a) {
  if (armed == 0)
    return mltcp::dispatch<Unarmed<F>>(algo, variant, agg, fac, a...);
  if (!agg || fac) return -1;
  switch (armed) {
    case ARM_TEL:
      return dispatch_armed_algo<F, ARM_TEL>(algo, variant, a...);
    case ARM_FAULTS:
      return dispatch_armed_algo<F, ARM_FAULTS>(algo, variant, a...);
    case ARM_TEL | ARM_FAULTS:
      return dispatch_armed_algo<F, ARM_TEL | ARM_FAULTS>(algo, variant,
                                                          a...);
  }
  return -1;
}

}  // namespace netsim_chunk

// Shared-memory bytes of one point (the kernel's budget is the card's
// 232,448 bytes a block).
extern "C" long long netsim_chunk_smem_bytes(const int* dims) {
  return netsim_chunk::smem_bytes(dims);
}

// ---------------------------------------------------------------------------
// The chunk's random draws, on the host: repro_torch/netsim/random.py's
// chunk_draws (jax's threefry2x32 key chain and split, the murmur3 lane
// hash) in C, bit for bit, for the card's runs, where the numpy version's
// per-tick python loop over the key chain would set the pace.
// ---------------------------------------------------------------------------

namespace host_draws {

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32, 20 rounds, on the block (x0, x1) under key (k0, k1)
inline void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                         uint32_t& x1) {
  static const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// lanes [0, n) of the uniform draw under subkey (s0, s1), into out[n]
inline void lane_uniform(uint32_t s0, uint32_t s1, int n, float* out) {
  for (int i = 0; i < n; ++i) {
    const uint32_t h = mix32(mix32((uint32_t)i ^ s0) ^ s1);
    out[i] = (float)(h >> 8) * (1.0f / 16777216.0f);
  }
}

}  // namespace host_draws

// The draws of `T` ticks from keys[K][2]: keys_out[T][K][2] is the key
// after each tick, u_out[T][K][2N + 2J] each tick's loss and CNP uniforms
// ([N] each) then its straggle and straggle-amount uniforms ([J] each),
// the layout chunk_inputs ships to the card.
extern "C" void netsim_chunk_draws(const uint32_t* keys, int K, int T,
                                   int N, int J, uint32_t* keys_out,
                                   float* u_out) {
  const long long width = 2LL * N + 2LL * J;
  for (int k = 0; k < K; ++k) {
    uint32_t k0 = keys[2 * k], k1 = keys[2 * k + 1];
    for (int t = 0; t < T; ++t) {
      float* row = u_out + ((long long)t * K + k) * width;
      uint32_t sub[5][2];
      for (int i = 0; i < 5; ++i) {   // jax.random.split(key, 5)
        uint32_t x0 = 0, x1 = (uint32_t)i;
        host_draws::threefry2x32(k0, k1, x0, x1);
        sub[i][0] = x0;
        sub[i][1] = x1;
      }
      host_draws::lane_uniform(sub[1][0], sub[1][1], N, row);
      host_draws::lane_uniform(sub[2][0], sub[2][1], N, row + N);
      host_draws::lane_uniform(sub[3][0], sub[3][1], J, row + 2 * N);
      host_draws::lane_uniform(sub[4][0], sub[4][1], J, row + 2 * N + J);
      k0 = sub[0][0];
      k1 = sub[0][1];
      keys_out[((long long)t * K + k) * 2] = k0;
      keys_out[((long long)t * K + k) * 2 + 1] = k1;
    }
  }
}

#ifdef __CUDACC__

namespace netsim_chunk {

template <int ALGO, int VARIANT, bool AGG, bool FACTORS, int ARMED>
__global__ void __launch_bounds__(256) netsim_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  run_point<ALGO, VARIANT, AGG, FACTORS, ARMED>(a, blockIdx.x, threadIdx.x,
                                                blockDim.x, smem);
}

struct Launch {
  template <int ALGO, int VARIANT, bool AGG, bool FACTORS, int ARMED>
  static int run(const Args& a, int threads, cudaStream_t stream) {
    auto kernel = netsim_chunk_kernel<ALGO, VARIANT, AGG, FACTORS, ARMED>;
    const long long bytes = smem_bytes(a.dim);
    if (bytes > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<a.dim[D_K], threads, bytes, stream>>>(a);
    return 0;
  }
};

struct Attributes {
  template <int ALGO, int VARIANT, bool AGG, bool FACTORS, int ARMED>
  static int run(int* out) {
    cudaFuncAttributes attr;
    const cudaError_t rc = cudaFuncGetAttributes(
        &attr, netsim_chunk_kernel<ALGO, VARIANT, AGG, FACTORS, ARMED>);
    if (rc != cudaSuccess) return (int)rc;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = attr.maxThreadsPerBlock;
    return 0;
  }
};

// The sketch's bins (and the logf under them) of n floats, by the chunk
// kernel's own device function: the card check that the kernel's logf is
// torch.log's on CUDA.  scalars: lo, hi, log_lo, inv_w.
__global__ void sketch_check_kernel(const float* x, long long n,
                                    float* log_out, int* bin_out, float lo,
                                    float hi, float log_lo, float inv_w,
                                    int bins) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  log_out[i] = logf(x[i]);
  bin_out[i] = sketch_bin(x[i], lo, hi, log_lo, inv_w, bins);
}

}  // namespace netsim_chunk

extern "C" int netsim_chunk_sketch_check(const float* x, long long n,
                                         float* log_out, int* bin_out,
                                         const float* scalars, int bins,
                                         void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  netsim_chunk::sketch_check_kernel<<<(unsigned)blocks, threads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      x, n, log_out, bin_out, scalars[0], scalars[1], scalars[2], scalars[3],
      bins);
  return (int)cudaGetLastError();
}

// Launch one chunk on `stream`: one CTA of `threads` threads per sweep
// point.  `operands` holds device pointers in OPERANDS order, `dims` the
// DIMS (the specialization's ARMED among them), `scalars` the SCALARS and
// `consts` the CC constants (CONST_FIELDS of mltcp_step.py).  Returns 0, a
// CUDA error code, or -1 for a specialization the library does not
// instantiate.
extern "C" int netsim_chunk_launch(int algo, int variant, int aggregate,
                                   int use_factors, void* const* operands,
                                   const int* dims, const float* scalars,
                                   const float* consts,
                                   int fast_recovery_stages, int threads,
                                   void* stream) {
  netsim_chunk::Args a;
  netsim_chunk::fill_args(a, operands, dims, scalars, consts,
                          fast_recovery_stages);
  const int rc = netsim_chunk::dispatch_chunk<netsim_chunk::Launch>(
      dims[netsim_chunk::D_ARMED], algo, variant, aggregate != 0,
      use_factors != 0, a, threads, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes and the most threads
// a block of one specialization, from cudaFuncGetAttributes, into out[4].
extern "C" int netsim_chunk_attributes(int algo, int variant, int aggregate,
                                       int use_factors, int armed, int* out) {
  return netsim_chunk::dispatch_chunk<netsim_chunk::Attributes>(
      armed, algo, variant, aggregate != 0, use_factors != 0, out);
}

#else  // a host compiler: the CPU check of the kernel's logic

#include <thread>
#include <vector>

namespace netsim_chunk {

struct HostRun {
  template <int ALGO, int VARIANT, bool AGG, bool FACTORS, int ARMED>
  static int run(const Args& a, int threads) {
    std::vector<float> smem(smem_bytes(a.dim) / 4);
    for (int k = 0; k < a.dim[D_K]; ++k) {
      std::barrier<> bar(threads);
      std::vector<std::thread> pool;
      for (int tid = 0; tid < threads; ++tid)
        pool.emplace_back([&, tid] {
          host_compat::cta_barrier = threads > 1 ? &bar : nullptr;
          run_point<ALGO, VARIANT, AGG, FACTORS, ARMED>(a, k, tid, threads,
                                                        smem.data());
        });
      for (auto& t : pool) t.join();
    }
    return 0;
  }
};

}  // namespace netsim_chunk

// The kernel's body on the CPU: each point's CTA as `threads` host threads
// meeting at a barrier; operands are host pointers.
extern "C" int netsim_chunk_host(int algo, int variant, int aggregate,
                                 int use_factors, void* const* operands,
                                 const int* dims, const float* scalars,
                                 const float* consts,
                                 int fast_recovery_stages, int threads) {
  netsim_chunk::Args a;
  netsim_chunk::fill_args(a, operands, dims, scalars, consts,
                          fast_recovery_stages);
  return netsim_chunk::dispatch_chunk<netsim_chunk::HostRun>(
      dims[netsim_chunk::D_ARMED], algo, variant, aggregate != 0,
      use_factors != 0, a, threads);
}

#endif
