// The MLTCP congestion-control arithmetic of one flow for one tick, shared
// by the per-tick kernel (mltcp_step.cu) and the chunk kernel
// (netsim_chunk.cu), so it exists once.
//
// Algorithm 1 (boundary test, iter_gap EWMA, max_gap, per-flow or
// job-aggregated bytes_ratio), F (the linear slope*ratio + intercept or one
// of the paper's F1..F6, `f_value`) with optional Static factors (>= 0
// replaces F, < 0 keeps it), WI/MD routing, and the
// Reno, CUBIC or DCQCN update, op for op as the plain PyTorch version
// (repro_torch/kernels/mltcp_step.py::mltcp_tick_reference).  Built with
// --fmad=false and IEEE division; the min/max/clamp helpers follow torch's
// CUDA semantics (NaN propagates) and the cube root is
// repro_torch/core/cc/cubic.py::cbrt, so the results are bitwise those of
// the plain version.
//
// Without nvcc (a host C++ compiler) host_compat.cuh stands in for the CUDA
// keywords, so the arithmetic and the chunk kernel's body compile for the
// CPU check in tests/test_torch_chunk.py.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include "host_compat.cuh"
#endif
#include <math.h>
#include <stdint.h>

namespace mltcp {

// CONST_FIELDS order of mltcp_step.py
enum Const {
  C_MSS_OVER_RTT, C_RTT, C_TICK_DT, C_MIN_CWND, C_BETA, C_CUBIC_C,
  C_CUBIC_K_SCALE, C_LINE_RATE, C_RATE_AI, C_RATE_MIN, C_DCQCN_G,
  C_ONE_MINUS_G, C_ALPHA_TIMER, C_INC_TIMER, C_CNP_INTERVAL, N_CONST
};
struct Consts {
  float v[N_CONST];
  int fast_recovery_stages;
};

constexpr int ALGO_RENO = 0, ALGO_CUBIC = 1, ALGO_DCQCN = 2;
constexpr int VAR_OFF = 0, VAR_WI = 1, VAR_MD = 2, VAR_BOTH = 3;
// The VARIANT of a specialization whose variant, job aggregation and
// Static factors are the launch's (`Dyn`) rather than template arguments:
// the armed chunk kernel's.
constexpr int VAR_LAUNCH = -1;

// torch's CUDA min/max/clamp: NaN in, NaN out
__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_f(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_f(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum_f(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minimum_f(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

// core/cc/cubic.py::cbrt, op for op
constexpr int CBRT_MAGIC = 0x2A51067F;
__device__ __forceinline__ float cbrt_ref(float x) {
  const float third = (float)(1.0 / 3.0);
  float a = fabsf(x);
  const bool small = a < 1.1754943508222875e-38f;
  a = small ? a * 16777216.0f : a;
  float y = __int_as_float(__float_as_int(a) / 3 + CBRT_MAGIC);
#pragma unroll
  for (int s = 0; s < 4; ++s) y = y + (a / (y * y) - y) * third;
  y = small ? y * 0.00390625f : y;
  y = (a == 0.0f || isinf(a)) ? a : y;
  return copysignf(y, x);
}

// One flow's protocol state: Algorithm 1's detector, then the CC fields
// of all three algorithms (one of them runs).
struct Flow {
  float bytes_sent, ratio, prev_ack, iter_gap, max_gap;
  float cwnd, ssthresh, cooldown, w_max, epoch, rate_cur, rate_tgt, alpha,
      t_cnp, t_inc, t_alpha;
  int stage;
};

// The RTT-delayed feedback of this tick and the per-flow operands.
struct Signals {
  float acks;         // delivered bytes / mss
  float ack_bytes;    // acks * mss, rounded once
  bool loss, cnp;
  float total_bytes;  // Algorithm 1's total_bytes
  float job_numer;    // job-aggregated bytes (read when AGG)
  float factor;       // Static factor (read when FACTORS)
};

// A sweep point's protocol scalars, the DynamicParams field order, the
// launch's F family (F_IDS of mltcp_step.py: 0 the linear F, 1..6 F1..F6)
// and the launch's CC selections, read where VARIANT is VAR_LAUNCH.
struct Dyn {
  float slope, intercept, g, gamma, init_gap;
  int f_id;
  int variant;
  bool aggregate, factors;
};

// The variant, job aggregation and Static factors a specialization runs:
// its template arguments, or, where VARIANT is VAR_LAUNCH, the launch's
// (uniform across it).  They only select operands, so the arithmetic and
// its order are the same either way; in every other specialization they
// are constants and fold away.
struct Selects {
  int variant;
  bool agg, fac;
};
template <int VARIANT, bool AGG, bool FACTORS>
__device__ __forceinline__ Selects selects(int variant, bool aggregate,
                                           bool factors) {
  if (VARIANT == VAR_LAUNCH) return Selects{variant, aggregate, factors};
  return Selects{VARIANT, AGG, FACTORS};
}

// F(x) of the F family `f_id` (uniform across the launch): the linear
// slope*x + intercept, or the paper's F1..F6 as
// repro_torch/core/aggressiveness.py writes them, in the same association
// (each product and sum rounded on its own under --fmad=false, F3's
// division IEEE, as torch's reciprocal), so the per-tick kernel, the chunk
// kernel and the plain version agree bit for bit.
__device__ __forceinline__ float f_value(int f_id, float x, float slope,
                                         float intercept) {
  switch (f_id) {
    case 1: return 1.75f * x + 0.25f;                        // F1
    case 2: return 1.75f * (x * x) + 0.25f;                  // F2
    case 3: return 1.0f / (-3.5f * x + 4.0f);                // F3
    case 4: return (-1.75f * (x * x) + 3.5f * x) + 0.25f;    // F4
    case 5: return -1.75f * x + 2.0f;                        // F5
    case 6: return -1.75f * (x * x) + 2.0f;                  // F6
    default: return slope * x + intercept;                   // linear
  }
}

// Advance `s` one tick at time `now`; returns whether the tick's ack opens
// a new training iteration (Algorithm 1 line 16, the n_boundaries count).
template <int ALGO, int VARIANT, bool AGG, bool FACTORS>
__device__ __forceinline__ bool cc_update(Flow& s, const Signals& x,
                                          const Dyn& d, float now,
                                          const Consts& c) {
  const Selects sel =
      selects<VARIANT, AGG, FACTORS>(d.variant, d.aggregate, d.factors);
  const float acks = x.acks;
  const bool has_ack = acks > 0.0f;
  const float bs_in = s.bytes_sent, prev_ack = s.prev_ack;
  const float ig_in = s.iter_gap, mg_in = s.max_gap;

  // ---------------- Algorithm 1 ----------------
  const float bytes_sent = bs_in + x.ack_bytes;
  const float curr_gap = now - prev_ack;
  const float max_gap = maximum_f(mg_in, curr_gap);
  const bool new_iter = curr_gap > d.g * ig_in;
  const float iter_gap_upd = (1.0f - d.gamma) * ig_in + d.gamma * max_gap;
  const float numer = sel.agg ? x.job_numer : bytes_sent;
  const float ratio_mid =
      clamp_max_f(numer * (1.0f / clamp_min_f(x.total_bytes, 1.0f)), 1.0f);
  const bool boundary = has_ack && new_iter;
  s.bytes_sent = boundary ? 0.0f : (has_ack ? bytes_sent : bs_in);
  const float ratio = boundary ? 0.0f : (has_ack ? ratio_mid : s.ratio);
  s.ratio = ratio;
  s.prev_ack = has_ack ? now : prev_ack;
  s.iter_gap = boundary ? iter_gap_upd : ig_in;
  s.max_gap = boundary ? d.init_gap : (has_ack ? max_gap : mg_in);

  // ---------------- F(bytes_ratio), variant routing ----------------
  float adaptive = 1.0f;
  if (sel.variant != VAR_OFF)
    adaptive = f_value(d.f_id, ratio, d.slope, d.intercept);
  float f_vals = adaptive;
  if (sel.fac) f_vals = x.factor >= 0.0f ? x.factor : adaptive;
  const float f_wi =
      (sel.variant == VAR_WI || sel.variant == VAR_BOTH) ? f_vals : 1.0f;
  const float f_md =
      (sel.variant == VAR_MD || sel.variant == VAR_BOTH) ? f_vals : 1.0f;

  if (ALGO == ALGO_RENO || ALGO == ALGO_CUBIC) {
    const float cwnd = s.cwnd, cooldown = s.cooldown, w_max = s.w_max;
    const bool in_ss = cwnd < s.ssthresh;
    float grow_ca;
    if (ALGO == ALGO_RENO) {
      grow_ca = f_wi * acks / clamp_min_f(cwnd, (float)1e-6);  // Eq. 5
    } else {
      const float tt = clamp_min_f(now - s.epoch, 0.0f);
      const float kk = cbrt_ref(w_max * c.v[C_CUBIC_K_SCALE]);
      const float dd = f_wi * tt - kk;
      const float target = c.v[C_CUBIC_C] * (dd * dd * dd) + w_max;  // Eq. 9
      const float grow = acks * clamp_min_f(target - cwnd, 0.0f) /
                         clamp_min_f(cwnd, (float)1e-6);
      grow_ca = minimum_f(grow, 0.5f * cwnd + 1.0f);
    }
    const float cwnd_inc = cwnd + (in_ss ? acks : grow_ca);
    const bool do_cut = x.loss && (cooldown <= 0.0f);
    const float cwnd_cut = clamp_min_f(
        clamp_max_f(f_md * c.v[C_BETA], 1.0f) * cwnd, c.v[C_MIN_CWND]);
    s.cwnd = do_cut ? cwnd_cut : cwnd_inc;
    s.ssthresh = do_cut ? clamp_min_f(cwnd_cut, 2.0f) : s.ssthresh;
    s.cooldown =
        do_cut ? c.v[C_RTT] : clamp_min_f(cooldown - c.v[C_TICK_DT], 0.0f);
    if (ALGO == ALGO_CUBIC) {
      s.w_max = do_cut ? cwnd : w_max;
      s.epoch = do_cut ? now : s.epoch;
    }
  } else {  // ---------------- DCQCN ----------------
    const float rate_cur = s.rate_cur, rate_tgt = s.rate_tgt, alpha = s.alpha;
    const float t_cnp = s.t_cnp, t_inc = s.t_inc, t_alpha = s.t_alpha;
    const bool cnp = x.cnp && ((now - t_cnp) >= c.v[C_CNP_INTERVAL]);
    const float alpha_on_cnp = c.v[C_ONE_MINUS_G] * alpha + c.v[C_DCQCN_G];
    const float md_mult = clamp_max_f(f_md * (1.0f - alpha / 2.0f), 1.0f);
    const float rate_cut =
        clamp_f(md_mult * rate_cur, c.v[C_RATE_MIN], c.v[C_LINE_RATE]);
    const bool alpha_fired = (now - t_alpha) >= c.v[C_ALPHA_TIMER];
    const float alpha_dec = alpha_fired ? c.v[C_ONE_MINUS_G] * alpha : alpha;
    const bool inc_fired = (now - t_inc) >= c.v[C_INC_TIMER];
    const int stage = s.stage + (inc_fired ? 1 : 0);
    const bool in_ai = stage > c.fast_recovery_stages;
    float tgt_inc = (inc_fired && in_ai)
                        ? rate_tgt + f_wi * c.v[C_RATE_AI]  // Eq. 13
                        : rate_tgt;
    tgt_inc = clamp_max_f(tgt_inc, c.v[C_LINE_RATE]);
    const float step_up = clamp_max_f(f_wi, 2.0f) * 0.5f * (tgt_inc - rate_cur);
    const float rate_inc = inc_fired ? rate_cur + step_up : rate_cur;
    s.rate_cur =
        clamp_f(cnp ? rate_cut : rate_inc, c.v[C_RATE_MIN], c.v[C_LINE_RATE]);
    s.rate_tgt =
        clamp_f(cnp ? rate_cur : tgt_inc, c.v[C_RATE_MIN], c.v[C_LINE_RATE]);
    s.alpha = clamp_f(cnp ? alpha_on_cnp : alpha_dec, 0.0f, 1.0f);
    s.stage = cnp ? 0 : stage;
    s.t_cnp = cnp ? now : t_cnp;
    s.t_inc = (cnp || inc_fired) ? now : t_inc;
    s.t_alpha = (cnp || alpha_fired) ? now : t_alpha;
  }
  return boundary;
}

// The send rate the state implies (core.send_rate): bytes/s.
template <int ALGO>
__device__ __forceinline__ float send_rate(const Flow& s, const Consts& c) {
  return ALGO == ALGO_DCQCN ? s.rate_cur : s.cwnd * c.v[C_MSS_OVER_RTT];
}

// Host-side dispatch of a template over the CC specializations: calls
// F::template run<ALGO, VARIANT, AGG, FACTORS>(args...) for the runtime
// values; returns -1 for an unknown algo or variant.
template <class F, int ALGO, int VARIANT, bool AGG, class... A>
int dispatch_factors(bool fac, A&&... a) {
  if (fac) return F::template run<ALGO, VARIANT, AGG, true>(a...);
  return F::template run<ALGO, VARIANT, AGG, false>(a...);
}
template <class F, int ALGO, int VARIANT, class... A>
int dispatch_agg(bool agg, bool fac, A&&... a) {
  if (agg) return dispatch_factors<F, ALGO, VARIANT, true>(fac, a...);
  return dispatch_factors<F, ALGO, VARIANT, false>(fac, a...);
}
template <class F, int ALGO, class... A>
int dispatch_variant(int variant, bool agg, bool fac, A&&... a) {
  switch (variant) {
    case VAR_OFF: return dispatch_agg<F, ALGO, VAR_OFF>(agg, fac, a...);
    case VAR_WI: return dispatch_agg<F, ALGO, VAR_WI>(agg, fac, a...);
    case VAR_MD: return dispatch_agg<F, ALGO, VAR_MD>(agg, fac, a...);
    case VAR_BOTH: return dispatch_agg<F, ALGO, VAR_BOTH>(agg, fac, a...);
  }
  return -1;
}
template <class F, class... A>
int dispatch(int algo, int variant, bool agg, bool fac, A&&... a) {
  switch (algo) {
    case ALGO_RENO:
      return dispatch_variant<F, ALGO_RENO>(variant, agg, fac, a...);
    case ALGO_CUBIC:
      return dispatch_variant<F, ALGO_CUBIC>(variant, agg, fac, a...);
    case ALGO_DCQCN:
      return dispatch_variant<F, ALGO_DCQCN>(variant, agg, fac, a...);
  }
  return -1;
}

}  // namespace mltcp
