// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along time, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru.py::_rg_lru_kernel
// (launched by rg_lru_scan).  The TPU form blocks (batch, 128 channels) with
// the whole time axis resident in VMEM and walks time in a fori_loop.  Here
// one thread owns one (b, d) channel and walks T sequentially; the channels
// of a warp are adjacent in d, so every step's loads and store are
// coalesced.  D needs to be a multiple of nothing: the ragged edge is
// masked.  Each thread loads UNROLL steps of a and b into registers before
// it runs their dependent chain, so loads of later steps are in flight while
// the chain runs.
//
// What bounds it: bytes.  a and b are read once and h written once (12 B per
// element in f32, 6 in bf16): 0.50 GB at [4, 4096, 2560] f32, 0.15 ms at
// 3.35 TB/s.  Only B*D threads exist (10,240 at that shape), so the design
// relies on the unrolled loads for memory-level parallelism.
//
// Arithmetic: built with --fmad=false, h = a*h and h = h + b are a separate
// multiply and add, each rounded once; for bf16 each is computed in float
// and rounded to bf16, as torch's bf16 mul and add do.  The plain version
// (kernels/ref.py::ref_rg_lru, the same sequential loop in torch) is then
// equal bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BLOCK = 64;
constexpr int UNROLL = 16;

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

template <typename T>
__global__ void __launch_bounds__(BLOCK)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ h0, T* __restrict__ out, long long T_len,
              long long D) {
  const long long d = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long bi = blockIdx.y;
  if (d >= D) return;
  // h is carried in the tensors' own type: for bf16 every op rounds to bf16
  T h = h0 ? h0[bi * D + d] : from_float<T>(0.0f);
  const long long base = bi * T_len * D + d;
  for (long long t0 = 0; t0 < T_len; t0 += UNROLL) {
    T av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < T_len) {
        const long long idx = base + (t0 + u) * D;
        av[u] = a[idx];
        bv[u] = b[idx];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < T_len) {
        h = from_float<T>(__fmul_rn(to_float(av[u]), to_float(h)));
        h = from_float<T>(__fadd_rn(to_float(h), to_float(bv[u])));
        out[base + (t0 + u) * D] = h;
      }
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  h0 may be null (zeros).  Launches on
// `stream` without synchronizing; returns cudaGetLastError().
extern "C" int rg_lru_launch(int dtype, const void* a, const void* b,
                             const void* h0, void* out, long long B,
                             long long T_len, long long D, void* stream) {
  if (B == 0 || T_len == 0 || D == 0) return 0;
  dim3 grid((unsigned)((D + BLOCK - 1) / BLOCK), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rg_lru_kernel<float><<<grid, BLOCK, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<float*>(out), T_len, D);
  } else if (dtype == 1) {
    rg_lru_kernel<__nv_bfloat16><<<grid, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(h0),
        static_cast<__nv_bfloat16*>(out), T_len, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
