// Flash attention, forward, for Hopper (sm_90a): online softmax with a
// float32 accumulator, grouped KV heads, causal and sliding-window masks and
// the Gemma-2 tanh logit softcap.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (launched by
// flash_attention_fwd).  The TPU form walks a sequential grid axis over
// 512-key blocks with the running max, normaliser and accumulator in VMEM
// scratch, on 512x512 MXU tiles with D padded to 128 lanes.  Here one CTA
// owns one (batch, query head, 64-query tile) and loops over 32-key tiles
// itself; the running max m, normaliser l and the [64, D] accumulator stay
// in registers for the whole loop, so nothing carries across CTAs.
//
//   * Threads: 256 as a 16 x 16 grid (ty, tx).  A thread owns query rows
//     ty + 16a (a < 4).  For the scores it computes columns tx + 16c
//     (c < 2) of the key tile; for the accumulator it owns the D/16
//     columns tx + 16e, so D is split across the 16 threads of a row and a
//     row's 256-wide f32 accumulator never sits in one thread.
//   * The 16 threads of a row are one half-warp: the row max and the row
//     sum of p are butterfly shuffles within it.
//   * Shared memory: the Q tile [64][D+1], K tile [32][D+1], V tile [32][D]
//     and the probabilities [64][33], in f32 (bf16 inputs are widened on
//     the load).  The +1 pads keep the column reads of Q and K free of bank
//     conflicts.  At D = 256 that is 139,904 bytes, so the kernel takes
//     dynamic shared memory above the 48 KB default.
//   * GQA: query head h reads KV head h / (H / K); KV heads are never
//     repeated in memory.  q, k, v and the output keep the model's
//     [B, T, H, D] / [B, S, K, D] layout, so the wrapper copies nothing.
//   * Key tiles that the causal or window mask empties for every row of the
//     query tile are skipped: such a tile changes nothing in the online
//     softmax (corr = 1, p = 0).
//
// Semantics follow the TPU kernel: s = (q.k) * scale, then the softcap,
// then masked entries set to -1e30 and their p forced to 0; output
// acc / max(l, 1e-30).  Products accumulate with explicit fmaf (the library
// is built with --fmad=false for the bitwise kernels), so sums differ from
// the dense plain version (kernels/ref.py::ref_attention) by rounding only;
// chip_smoke.py holds the two within 2e-5 (f32) / 2e-2 (bf16 inputs).
//
// What bounds it at the serve shape (B=4, T=S=4096, H=10, K=1, D=256,
// causal, window 2048): operations, about 2.6e11 FLOP over the unmasked
// (query, key) pairs, against 0.37 GB of operands.  This first version runs
// on the CUDA cores in f32 from shared memory (no wgmma, no TMA) and is
// bound by shared-memory loads, well above the 67 TFLOP/s f32 bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int RQ = BQ / 16;   // query rows per thread
constexpr int CK = BK / 16;   // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, T, S, H, K;
  float scale;
  int causal;
  int window;
  int has_softcap;
  float softcap;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int smem_floats(int d) {
  return BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int QS = D + 1;
  constexpr int KS = D + 1;
  constexpr int VS = D;
  constexpr int PS = BK + 1;
  constexpr int DE = D / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * VS;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.K);
  const int q0 = blockIdx.x * BQ;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int t = q0 + r;
    float val = 0.0f;
    if (t < p.T) {
      val = to_float(q[(((long long)b * p.T + t) * p.H + h) * D + d]);
    }
    Qs[r * QS + d] = val;
  }

  float m[RQ], l[RQ], acc[RQ][DE];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[a][e] = 0.0f;
  }

  // key tiles that hold at least one unmasked (query, key) pair
  const int q_last = min(q0 + BQ, p.T) - 1;
  int k_begin = 0;
  int k_end = p.S;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();              // the last tile's reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D;
      const int d = e % D;
      const int s = k0 + j;
      float kv = 0.0f;
      float vv = 0.0f;
      if (s < p.S) {
        const long long idx = (((long long)b * p.S + s) * p.K + kh) * D + d;
        kv = to_float(k[idx]);
        vv = to_float(v[idx]);
      }
      Ks[j * KS + d] = kv;
      Vs[j * VS + d] = vv;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int c = 0; c < CK; ++c) sc[a][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int a = 0; a < RQ; ++a) qv[a] = Qs[(ty + 16 * a) * QS + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = Ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int c = 0; c < CK; ++c)
          sc[a][c] = __fmaf_rn(qv[a], kv[c], sc[a][c]);
    }

    float corr[RQ];
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int qpos = q0 + ty + 16 * a;
      bool ok[CK];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = sc[a][c] * p.scale;
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        ok[c] = kpos < p.S;
        if (p.causal) ok[c] = ok[c] && kpos <= qpos;
        if (p.window > 0) ok[c] = ok[c] && kpos > qpos - p.window;
        sc[a][c] = ok[c] ? x : NEG_INF;
        mx = fmaxf(mx, sc[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float pv = ok[c] ? expf(sc[a][c] - m_new) : 0.0f;
        Ps[(ty + 16 * a) * PS + tx + 16 * c] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      corr[a] = expf(m[a] - m_new);
      l[a] = corr[a] * l[a] + rs;
      m[a] = m_new;
    }
    __syncthreads();              // p of the whole tile is in Ps

#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[a][e] *= corr[a];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RQ];
#pragma unroll
      for (int a = 0; a < RQ; ++a) pv[a] = Ps[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const float vv = Vs[j * VS + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
          acc[a][e] = __fmaf_rn(pv[a], vv, acc[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int t = q0 + ty + 16 * a;
    if (t >= p.T) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    const long long row = (((long long)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int e = 0; e < DE; ++e)
      o[row + tx + 16 * e] = from_float<T>(acc[a][e] / denom);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int bytes = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((p.T + BQ - 1) / BQ), (unsigned)(p.B * p.H));
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 192: return launch<T, 192>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, T, H, D], k/v [B, S, K, D], o [B, T, H, D], contiguous, all of one
// dtype (0 float32, 1 bfloat16); D one of 32, 64, 128, 192, 256; H a
// multiple of K.  Launches on `stream` without synchronizing; returns the
// CUDA error code (0 on success).
extern "C" int flash_attention_launch(int dtype, int d, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int T, int S, int H, int K,
                                      float scale, int causal, int window,
                                      int has_softcap, float softcap,
                                      void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  Params p{q, k, v, o, B, T, S, H, K, scale, causal, window, has_softcap,
           softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(d, p, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(d, p, s);
  return (int)cudaErrorInvalidValue;
}
