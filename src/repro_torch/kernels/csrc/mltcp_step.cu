// Fused MLTCP congestion-control tick for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mltcp_step.py::_kernel
// (launched by mltcp_tick_arrays).  One thread advances one flow of one
// sweep point: Algorithm 1 (boundary test, iter_gap EWMA, max_gap, per-flow
// or job-aggregated bytes_ratio), F (linear, slope*ratio + intercept, or one
// of F1..F6, the launch's `f_id`) with optional Static factors (>= 0
// replaces F, < 0 keeps it), WI/MD routing, and the Reno, CUBIC or DCQCN
// update.  State is [K, N] contiguous; the grid covers K*N with the ragged
// edge masked; dyn is [K, 5] and now is [K].
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
// arithmetic is mltcp_cc.cuh's, shared with the chunk kernel
// (netsim_chunk.cu); its min/max/clamp helpers follow torch's CUDA
// semantics (NaN propagates).
#include "mltcp_cc.cuh"

namespace {

using namespace mltcp;

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

// The flow's operands go through the shared CC arithmetic (mltcp_cc.cuh).
template <int ALGO, int VARIANT, bool AGG, bool FACTORS>
__global__ void __launch_bounds__(256)
mltcp_step_kernel(Ptrs p, Consts c, const float* __restrict__ dyn,
                  const float* __restrict__ now_k,
                  const float* __restrict__ factors, int f_id, long long K,
                  long long N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * N) return;
  const long long k = i / N;

#define IN_F(idx) (static_cast<const float*>(p.in[idx])[i])
#define OUT_F(idx) (static_cast<float*>(p.out[idx])[i])
  const Dyn d{dyn[k * 5 + 0], dyn[k * 5 + 1], dyn[k * 5 + 2],
              dyn[k * 5 + 3], dyn[k * 5 + 4], f_id};
  const float now = now_k[k];

  Flow s;
  s.bytes_sent = IN_F(I_BYTES_SENT);
  s.ratio = IN_F(I_PREV_RATIO);
  s.prev_ack = IN_F(I_PREV_ACK);
  s.iter_gap = IN_F(I_ITER_GAP);
  s.max_gap = IN_F(I_MAX_GAP);
  s.cwnd = IN_F(I_CWND);
  s.ssthresh = IN_F(I_SSTHRESH);
  s.cooldown = IN_F(I_COOLDOWN);
  s.w_max = IN_F(I_W_MAX);
  s.epoch = IN_F(I_EPOCH);
  s.rate_cur = IN_F(I_RATE_CUR);
  s.rate_tgt = IN_F(I_RATE_TGT);
  s.alpha = IN_F(I_ALPHA);
  s.t_cnp = IN_F(I_T_CNP);
  s.t_inc = IN_F(I_T_INC);
  s.t_alpha = IN_F(I_T_ALPHA);
  s.stage = static_cast<const int*>(p.in[I_STAGE])[i];

  Signals x;
  x.acks = IN_F(I_ACKS);
  x.ack_bytes = IN_F(I_ACK_BYTES);
  x.loss = static_cast<const bool*>(p.in[I_LOSS])[i];
  x.cnp = static_cast<const bool*>(p.in[I_CNP])[i];
  x.total_bytes = IN_F(I_TOTAL_BYTES);
  x.job_numer = AGG ? IN_F(I_JOB_NUMER) : 0.0f;
  x.factor = FACTORS ? factors[i] : 0.0f;

  cc_update<ALGO, VARIANT, AGG, FACTORS>(s, x, d, now, c);

  OUT_F(O_BYTES_SENT) = s.bytes_sent;
  OUT_F(O_PREV_ACK) = s.prev_ack;
  OUT_F(O_ITER_GAP) = s.iter_gap;
  OUT_F(O_MAX_GAP) = s.max_gap;
  OUT_F(O_CWND) = s.cwnd;
  OUT_F(O_SSTHRESH) = s.ssthresh;
  OUT_F(O_COOLDOWN) = s.cooldown;
  OUT_F(O_W_MAX) = s.w_max;
  OUT_F(O_EPOCH) = s.epoch;
  OUT_F(O_RATE_CUR) = s.rate_cur;
  OUT_F(O_RATE_TGT) = s.rate_tgt;
  OUT_F(O_ALPHA) = s.alpha;
  OUT_F(O_T_CNP) = s.t_cnp;
  OUT_F(O_T_INC) = s.t_inc;
  OUT_F(O_T_ALPHA) = s.t_alpha;
  static_cast<int*>(p.out[O_STAGE])[i] = s.stage;
  OUT_F(O_RATIO) = s.ratio;
  OUT_F(O_RATE) = send_rate<ALGO>(s, c);
#undef IN_F
#undef OUT_F
}

constexpr int BLOCK = 256;

struct Launch {
  template <int ALGO, int VARIANT, bool AGG, bool FACTORS>
  static int run(const Ptrs& p, const Consts& c, const float* dyn,
                 const float* now, const float* factors, int f_id,
                 long long K, long long N, cudaStream_t stream) {
    const long long total = K * N;
    const unsigned grid = (unsigned)((total + BLOCK - 1) / BLOCK);
    mltcp_step_kernel<ALGO, VARIANT, AGG, FACTORS>
        <<<grid, BLOCK, 0, stream>>>(p, c, dyn, now, factors, f_id, K, N);
    return 0;
  }
};

}  // namespace

// Launch the fused tick on `stream`.  `ins`/`outs` are host arrays of device
// pointers in IN_ORDER / OUT_ORDER; `consts` a host array of CONST_FIELDS;
// `f_id` the F family (F_IDS).  Returns cudaGetLastError() (0 on success),
// or -1 for an unknown specialization.
extern "C" int mltcp_step_launch(int algo, int variant, int aggregate,
                                 int use_factors, const void* const* ins,
                                 void* const* outs, const float* consts,
                                 int fast_recovery_stages, const void* dyn,
                                 const void* now, const void* factors,
                                 int f_id, long long K, long long N,
                                 void* stream) {
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
  const int rc = dispatch<Launch>(algo, variant, aggregate != 0,
                                  use_factors != 0, p, c, d, t, f, f_id, K,
                                  N, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
