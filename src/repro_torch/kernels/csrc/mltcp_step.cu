// Fused MLTCP congestion-control tick for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mltcp_step.py::_kernel
// (launched by mltcp_tick_arrays).  One thread advances one flow of one
// sweep point: Algorithm 1 (boundary test, iter_gap EWMA, max_gap, per-flow
// or job-aggregated bytes_ratio), F = slope*ratio + intercept with optional
// Static factors (>= 0 replaces F, < 0 keeps it), WI/MD routing, and the
// Reno, CUBIC or DCQCN update.  State is [K, N] contiguous; the grid covers
// K*N with the ragged edge masked; dyn is [K, 5] and now is [K].
//
// What bounds it: a pure byte-mover, ~86 B read and 72 B written per flow
// (~160 B, ~50 ps per flow at 3.35 TB/s).  At the paper's shapes (K*N of a
// few to a few hundred) one launch is far below a microsecond of memory
// traffic, so it is bound by the launch itself.
//
// Bitwise parity with the plain PyTorch version
// (repro_torch/kernels/mltcp_step.py::mltcp_tick_reference): build with
// --fmad=false (no a*b+c contraction; torch runs each op as its own kernel)
// and IEEE division, mirror the plain version op for op, and take the cube
// root with the same formula (repro_torch/core/cc/cubic.py::cbrt).  The
// min/max/clamp helpers follow torch's CUDA semantics (NaN propagates).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_IN = 23;   // IN_ORDER
constexpr int N_OUT = 18;  // OUT_ORDER

// IN_ORDER positions
enum In {
  I_BYTES_SENT, I_PREV_ACK, I_ITER_GAP, I_MAX_GAP,
  I_CWND, I_SSTHRESH, I_COOLDOWN, I_W_MAX, I_EPOCH,
  I_RATE_CUR, I_RATE_TGT, I_ALPHA, I_T_CNP, I_T_INC, I_T_ALPHA,
  I_STAGE, I_PREV_RATIO, I_ACKS, I_ACK_BYTES, I_LOSS, I_CNP,
  I_TOTAL_BYTES, I_JOB_NUMER
};
// OUT_ORDER positions
enum Out {
  O_BYTES_SENT, O_PREV_ACK, O_ITER_GAP, O_MAX_GAP,
  O_CWND, O_SSTHRESH, O_COOLDOWN, O_W_MAX, O_EPOCH,
  O_RATE_CUR, O_RATE_TGT, O_ALPHA, O_T_CNP, O_T_INC, O_T_ALPHA,
  O_STAGE, O_RATIO, O_RATE
};

struct Ptrs {
  const void* in[N_IN];
  void* out[N_OUT];
};

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

template <int ALGO, int VARIANT, bool AGG, bool FACTORS>
__global__ void __launch_bounds__(256)
mltcp_step_kernel(Ptrs p, Consts c, const float* __restrict__ dyn,
                  const float* __restrict__ now_k,
                  const float* __restrict__ factors, long long K,
                  long long N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * N) return;
  const long long k = i / N;

#define IN_F(idx) (static_cast<const float*>(p.in[idx])[i])
#define OUT_F(idx) (static_cast<float*>(p.out[idx])[i])
  const float slope = dyn[k * 5 + 0], intercept = dyn[k * 5 + 1];
  const float g = dyn[k * 5 + 2], gamma = dyn[k * 5 + 3];
  const float init_gap = dyn[k * 5 + 4];
  const float now = now_k[k];

  const float acks = IN_F(I_ACKS);
  const bool has_ack = acks > 0.0f;
  const float bs_in = IN_F(I_BYTES_SENT), prev_ack = IN_F(I_PREV_ACK);
  const float ig_in = IN_F(I_ITER_GAP), mg_in = IN_F(I_MAX_GAP);

  // ---------------- Algorithm 1 ----------------
  const float bytes_sent = bs_in + IN_F(I_ACK_BYTES);
  const float curr_gap = now - prev_ack;
  const float max_gap = maximum_f(mg_in, curr_gap);
  const bool new_iter = curr_gap > g * ig_in;
  const float iter_gap_upd = (1.0f - gamma) * ig_in + gamma * max_gap;
  const float numer = AGG ? IN_F(I_JOB_NUMER) : bytes_sent;
  const float ratio_mid =
      clamp_max_f(numer * (1.0f / clamp_min_f(IN_F(I_TOTAL_BYTES), 1.0f)),
                  1.0f);
  const bool boundary = has_ack && new_iter;
  OUT_F(O_BYTES_SENT) = boundary ? 0.0f : (has_ack ? bytes_sent : bs_in);
  const float ratio =
      boundary ? 0.0f : (has_ack ? ratio_mid : IN_F(I_PREV_RATIO));
  OUT_F(O_RATIO) = ratio;
  OUT_F(O_PREV_ACK) = has_ack ? now : prev_ack;
  OUT_F(O_ITER_GAP) = boundary ? iter_gap_upd : ig_in;
  OUT_F(O_MAX_GAP) = boundary ? init_gap : (has_ack ? max_gap : mg_in);

  // ---------------- F(bytes_ratio), variant routing ----------------
  float adaptive = 1.0f;
  if (VARIANT != VAR_OFF) adaptive = slope * ratio + intercept;
  float f_vals = adaptive;
  if (FACTORS) {
    const float fac = factors[i];
    f_vals = fac >= 0.0f ? fac : adaptive;
  }
  const float f_wi = (VARIANT == VAR_WI || VARIANT == VAR_BOTH) ? f_vals : 1.0f;
  const float f_md = (VARIANT == VAR_MD || VARIANT == VAR_BOTH) ? f_vals : 1.0f;

  const bool loss = static_cast<const bool*>(p.in[I_LOSS])[i];
  const bool cnp_sig = static_cast<const bool*>(p.in[I_CNP])[i];
  const float cwnd = IN_F(I_CWND), ssthresh = IN_F(I_SSTHRESH);
  const float cooldown = IN_F(I_COOLDOWN), w_max = IN_F(I_W_MAX);
  const float epoch = IN_F(I_EPOCH), rate_cur = IN_F(I_RATE_CUR);
  const float rate_tgt = IN_F(I_RATE_TGT), alpha = IN_F(I_ALPHA);
  const float t_cnp = IN_F(I_T_CNP), t_inc = IN_F(I_T_INC);
  const float t_alpha = IN_F(I_T_ALPHA);
  const int stage_in = static_cast<const int*>(p.in[I_STAGE])[i];
  int* stage_out = static_cast<int*>(p.out[O_STAGE]);

  if (ALGO == ALGO_RENO || ALGO == ALGO_CUBIC) {
    const bool in_ss = cwnd < ssthresh;
    float grow_ca;
    if (ALGO == ALGO_RENO) {
      grow_ca = f_wi * acks / clamp_min_f(cwnd, (float)1e-6);  // Eq. 5
    } else {
      const float tt = clamp_min_f(now - epoch, 0.0f);
      const float kk = cbrt_ref(w_max * c.v[C_CUBIC_K_SCALE]);
      const float d = f_wi * tt - kk;
      const float target = c.v[C_CUBIC_C] * (d * d * d) + w_max;  // Eq. 9
      const float grow = acks * clamp_min_f(target - cwnd, 0.0f) /
                         clamp_min_f(cwnd, (float)1e-6);
      grow_ca = minimum_f(grow, 0.5f * cwnd + 1.0f);
    }
    const float cwnd_inc = cwnd + (in_ss ? acks : grow_ca);
    const bool do_cut = loss && (cooldown <= 0.0f);
    const float cwnd_cut = clamp_min_f(
        clamp_max_f(f_md * c.v[C_BETA], 1.0f) * cwnd, c.v[C_MIN_CWND]);
    const float new_cwnd = do_cut ? cwnd_cut : cwnd_inc;
    OUT_F(O_CWND) = new_cwnd;
    OUT_F(O_SSTHRESH) = do_cut ? clamp_min_f(cwnd_cut, 2.0f) : ssthresh;
    OUT_F(O_COOLDOWN) =
        do_cut ? c.v[C_RTT] : clamp_min_f(cooldown - c.v[C_TICK_DT], 0.0f);
    if (ALGO == ALGO_CUBIC) {
      OUT_F(O_W_MAX) = do_cut ? cwnd : w_max;
      OUT_F(O_EPOCH) = do_cut ? now : epoch;
    } else {
      OUT_F(O_W_MAX) = w_max;
      OUT_F(O_EPOCH) = epoch;
    }
    OUT_F(O_RATE_CUR) = rate_cur;
    OUT_F(O_RATE_TGT) = rate_tgt;
    OUT_F(O_ALPHA) = alpha;
    OUT_F(O_T_CNP) = t_cnp;
    OUT_F(O_T_INC) = t_inc;
    OUT_F(O_T_ALPHA) = t_alpha;
    stage_out[i] = stage_in;
    OUT_F(O_RATE) = new_cwnd * c.v[C_MSS_OVER_RTT];
  } else {  // ---------------- DCQCN ----------------
    const bool cnp = cnp_sig && ((now - t_cnp) >= c.v[C_CNP_INTERVAL]);
    const float alpha_on_cnp = c.v[C_ONE_MINUS_G] * alpha + c.v[C_DCQCN_G];
    const float md_mult = clamp_max_f(f_md * (1.0f - alpha / 2.0f), 1.0f);
    const float rate_cut =
        clamp_f(md_mult * rate_cur, c.v[C_RATE_MIN], c.v[C_LINE_RATE]);
    const bool alpha_fired = (now - t_alpha) >= c.v[C_ALPHA_TIMER];
    const float alpha_dec = alpha_fired ? c.v[C_ONE_MINUS_G] * alpha : alpha;
    const bool inc_fired = (now - t_inc) >= c.v[C_INC_TIMER];
    const int stage = stage_in + (inc_fired ? 1 : 0);
    const bool in_ai = stage > c.fast_recovery_stages;
    float tgt_inc = (inc_fired && in_ai)
                        ? rate_tgt + f_wi * c.v[C_RATE_AI]  // Eq. 13
                        : rate_tgt;
    tgt_inc = clamp_max_f(tgt_inc, c.v[C_LINE_RATE]);
    const float step_up = clamp_max_f(f_wi, 2.0f) * 0.5f * (tgt_inc - rate_cur);
    const float rate_inc = inc_fired ? rate_cur + step_up : rate_cur;
    const float new_rate =
        clamp_f(cnp ? rate_cut : rate_inc, c.v[C_RATE_MIN], c.v[C_LINE_RATE]);
    OUT_F(O_RATE_CUR) = new_rate;
    OUT_F(O_RATE_TGT) =
        clamp_f(cnp ? rate_cur : tgt_inc, c.v[C_RATE_MIN], c.v[C_LINE_RATE]);
    OUT_F(O_ALPHA) = clamp_f(cnp ? alpha_on_cnp : alpha_dec, 0.0f, 1.0f);
    stage_out[i] = cnp ? 0 : stage;
    OUT_F(O_T_CNP) = cnp ? now : t_cnp;
    OUT_F(O_T_INC) = (cnp || inc_fired) ? now : t_inc;
    OUT_F(O_T_ALPHA) = (cnp || alpha_fired) ? now : t_alpha;
    OUT_F(O_CWND) = cwnd;
    OUT_F(O_SSTHRESH) = ssthresh;
    OUT_F(O_COOLDOWN) = cooldown;
    OUT_F(O_W_MAX) = w_max;
    OUT_F(O_EPOCH) = epoch;
    OUT_F(O_RATE) = new_rate;
  }
#undef IN_F
#undef OUT_F
}

constexpr int BLOCK = 256;

template <int ALGO, int VARIANT, bool AGG, bool FACTORS>
void launch(const Ptrs& p, const Consts& c, const float* dyn,
            const float* now, const float* factors, long long K, long long N,
            cudaStream_t stream) {
  const long long total = K * N;
  const unsigned grid = (unsigned)((total + BLOCK - 1) / BLOCK);
  mltcp_step_kernel<ALGO, VARIANT, AGG, FACTORS>
      <<<grid, BLOCK, 0, stream>>>(p, c, dyn, now, factors, K, N);
}

template <int ALGO, int VARIANT, bool AGG>
void dispatch_factors(bool use_factors, const Ptrs& p, const Consts& c,
                      const float* dyn, const float* now, const float* factors,
                      long long K, long long N, cudaStream_t s) {
  if (use_factors)
    launch<ALGO, VARIANT, AGG, true>(p, c, dyn, now, factors, K, N, s);
  else
    launch<ALGO, VARIANT, AGG, false>(p, c, dyn, now, factors, K, N, s);
}

template <int ALGO, int VARIANT>
void dispatch_agg(bool agg, bool use_factors, const Ptrs& p, const Consts& c,
                  const float* dyn, const float* now, const float* factors,
                  long long K, long long N, cudaStream_t s) {
  if (agg)
    dispatch_factors<ALGO, VARIANT, true>(use_factors, p, c, dyn, now,
                                          factors, K, N, s);
  else
    dispatch_factors<ALGO, VARIANT, false>(use_factors, p, c, dyn, now,
                                           factors, K, N, s);
}

template <int ALGO>
int dispatch_variant(int variant, bool agg, bool use_factors, const Ptrs& p,
                     const Consts& c, const float* dyn, const float* now,
                     const float* factors, long long K, long long N,
                     cudaStream_t s) {
  switch (variant) {
    case VAR_OFF:
      dispatch_agg<ALGO, VAR_OFF>(agg, use_factors, p, c, dyn, now, factors,
                                  K, N, s);
      return 0;
    case VAR_WI:
      dispatch_agg<ALGO, VAR_WI>(agg, use_factors, p, c, dyn, now, factors,
                                 K, N, s);
      return 0;
    case VAR_MD:
      dispatch_agg<ALGO, VAR_MD>(agg, use_factors, p, c, dyn, now, factors,
                                 K, N, s);
      return 0;
    case VAR_BOTH:
      dispatch_agg<ALGO, VAR_BOTH>(agg, use_factors, p, c, dyn, now, factors,
                                   K, N, s);
      return 0;
  }
  return -1;
}

}  // namespace

// Launch the fused tick on `stream`.  `ins`/`outs` are host arrays of device
// pointers in IN_ORDER / OUT_ORDER; `consts` a host array of CONST_FIELDS.
// Returns cudaGetLastError() (0 on success), or -1 for an unknown
// specialization.
extern "C" int mltcp_step_launch(int algo, int variant, int aggregate,
                                 int use_factors, const void* const* ins,
                                 void* const* outs, const float* consts,
                                 int fast_recovery_stages, const void* dyn,
                                 const void* now, const void* factors,
                                 long long K, long long N, void* stream) {
  Ptrs p;
  for (int j = 0; j < N_IN; ++j) p.in[j] = ins[j];
  for (int j = 0; j < N_OUT; ++j) p.out[j] = outs[j];
  Consts c;
  for (int j = 0; j < N_CONST; ++j) c.v[j] = consts[j];
  c.fast_recovery_stages = fast_recovery_stages;
  const float* d = static_cast<const float*>(dyn);
  const float* t = static_cast<const float*>(now);
  const float* f = static_cast<const float*>(factors);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool agg = aggregate != 0, fac = use_factors != 0;
  int rc = -1;
  switch (algo) {
    case ALGO_RENO:
      rc = dispatch_variant<ALGO_RENO>(variant, agg, fac, p, c, d, t, f, K,
                                       N, s);
      break;
    case ALGO_CUBIC:
      rc = dispatch_variant<ALGO_CUBIC>(variant, agg, fac, p, c, d, t, f, K,
                                        N, s);
      break;
    case ALGO_DCQCN:
      rc = dispatch_variant<ALGO_DCQCN>(variant, agg, fac, p, c, d, t, f, K,
                                        N, s);
      break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
