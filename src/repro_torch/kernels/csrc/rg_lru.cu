// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along time, for
// Hopper (sm_90a): a streamed scan through a ring in shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru.py::_rg_lru_kernel
// (launched by rg_lru_scan).  The TPU form blocks (batch, 128 channels) with
// the whole time axis resident in VMEM and walks time in a fori_loop.
//
// What bounds it: bytes.  a and b are read once and h written once (12 B per
// element in f32, 6 in bf16): 0.503 GB at [4, 4096, 2560] f32, 0.150 ms at
// 3.35 TB/s.  The chain itself is one multiply and one add per step, about 8
// cycles of dependent latency: 4,096 steps are ~17 us, a tenth of that.  So
// the walk over T stays sequential for every channel (a chunked or
// associative scan would round differently), and the design is about
// keeping enough bytes in flight.
//
// Work unit: UNIT_BYTES = 64 bytes of adjacent channels of one batch row
// (16 channels in f32, 32 in bf16), walked over all of T by one warp, one
// warp per CTA, one CTA per unit; lane l owns channel c0 + l.  At [4, 4096,
// 2560] f32 that is 640 units on 132 SMs, all resident at once: the busiest
// SM holds 5 against a mean of 4.85, so it sets the pace at 97% of ideal
// (32-channel units would give 3 against 2.42, 81%; measured, they ran no
// slower, since the card's bytes and not the busiest SM set the pace).
//
// Ring: STAGES = 4 slots of TILE_ROWS = 16 rows of the unit's a and of its
// b (16 x 64 B each), 8 KB of static shared memory per CTA.  Loads of tiles
// i+1 ... i+3 are in flight while the chain runs on tile i: 6 KB per unit,
// ~29 KB per SM and 3.9 MB across the card at the serve shape.  That size
// was measured, not derived: on an H100 (chip_smoke.py --probe rg_lru over
// variants of this file) 6 KB per unit ran fastest, and both less (3-4 KB:
// too little in flight) and more (8-28 KB: the card delivered fewer bytes
// per second from the same scattered 64-byte rows) ran 9-35% slower.  The
// copies ask L2 to fetch the whole 128-byte line (.L2::128B), so the
// neighbouring unit's half of a line is often there when it asks.  One CTA
// barrier per tile releases a slot only after every lane has read it (the
// slot refilled at tile i is the one read at tile i-1).
//
// Two specializations of the one kernel, chosen in rg_lru_launch by
// rg_lru_route (mirrored for the CPU by kernels/rg_lru.py::route, which the
// wrapper checks against it at every launch):
//   ALIGNED (route 1): 16-byte cp.async with commit/wait groups.  Needs
//     every row of a and b to start on a 16-byte boundary: the pointers
//     16-byte aligned and D * sizeof(T) a multiple of 16.  A ragged last
//     unit (D not a multiple of the unit's channels) then still ends on a
//     whole 16-byte chunk; rows past T are not loaded.
//   GENERAL (route 0): plain loads of single elements into the same ring,
//     for any D and any element-aligned pointer (a 4-byte storage offset,
//     D = 130).  Each tile's loads are waited for before the chain runs on
//     the oldest tile, so it keeps less in flight; it is not on the serve
//     path.
// The consumer reads a and b from the slot, runs the chain in registers and
// stores h straight from them: one 64-byte row of a unit per step, coalesced.
//
// Arithmetic: built with --fmad=false, h = a*h and h = h + b are a separate
// multiply and add, each rounded once; for bf16 each is computed in float
// and rounded to bf16, as torch's bf16 mul and add do.  The plain version
// (kernels/ref.py::ref_rg_lru, the same sequential loop in torch) is then
// equal bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int UNIT_BYTES = 64;
constexpr int TILE_ROWS = 16;
constexpr int STAGES = 4;
constexpr int WARP = 32;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T>
struct Unit {
  static constexpr int C = UNIT_BYTES / (int)sizeof(T);   // channels
  static constexpr int EPC = 16 / (int)sizeof(T);         // per 16-B chunk
  static constexpr int CHUNKS = TILE_ROWS * UNIT_BYTES / 16;
  static_assert(CHUNKS % WARP == 0 && TILE_ROWS * C % WARP == 0,
                "every lane copies the same number of chunks and elements");
};

// rows [t0, t0 + TILE_ROWS) of the unit's columns [c0, c0 + C) of one
// operand (row stride D) into `dst` ([TILE_ROWS][C]); rows at or past T and
// columns at or past D are left as they are (the chain reads none of them)
template <typename T, bool ALIGNED>
__device__ __forceinline__ void fill(T* dst, const T* __restrict__ src,
                                     long long row0, long long t0,
                                     long long T_len, long long D,
                                     long long c0, int lane) {
  using U = Unit<T>;
  if constexpr (ALIGNED) {
    constexpr int PER_ROW = U::C / U::EPC;     // 16-byte chunks in a row
#pragma unroll
    for (int j = 0; j < U::CHUNKS / WARP; ++j) {
      const int k = lane + j * WARP;
      const int r = k / PER_ROW;
      const int c = (k % PER_ROW) * U::EPC;
      if (t0 + r < T_len && c0 + c < D)
        cp_async16(dst + r * U::C + c, src + (row0 + t0 + r) * D + c0 + c);
    }
  } else {
#pragma unroll
    for (int j = 0; j < TILE_ROWS * U::C / WARP; ++j) {
      const int k = lane + j * WARP;
      const int r = k / U::C;
      const int c = k % U::C;
      if (t0 + r < T_len && c0 + c < D)
        dst[r * U::C + c] = src[(row0 + t0 + r) * D + c0 + c];
    }
  }
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(WARP)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ h0, T* __restrict__ out, long long T_len,
              long long D) {
  using U = Unit<T>;
  constexpr int SLOT = TILE_ROWS * U::C;        // elements of one tile
  __shared__ __align__(16) unsigned char ring[2 * STAGES * SLOT * sizeof(T)];
  T* const sa = reinterpret_cast<T*>(ring);    // [STAGES][SLOT] of a
  T* const sb = sa + STAGES * SLOT;            // [STAGES][SLOT] of b

  const int lane = threadIdx.x;
  const long long per_row = (D + U::C - 1) / U::C;
  const long long bi = blockIdx.x / per_row;
  const long long c0 = (blockIdx.x % per_row) * U::C;
  const long long d = c0 + lane;
  const bool mine = lane < U::C && d < D;
  const long long row0 = bi * T_len;     // the batch row's first time step
  const long long n_tiles = (T_len + TILE_ROWS - 1) / TILE_ROWS;

  // h is carried in the tensors' own type: for bf16 every op rounds to bf16
  T h = from_float<T>(0.0f);
  if (mine && h0) h = h0[bi * D + d];

  // prologue: tiles 0 .. STAGES-2, one commit group each (empty past T)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      fill<T, ALIGNED>(sa + s * SLOT, a, row0, (long long)s * TILE_ROWS,
                       T_len, D, c0, lane);
      fill<T, ALIGNED>(sb + s * SLOT, b, row0, (long long)s * TILE_ROWS,
                       T_len, D, c0, lane);
    }
    if constexpr (ALIGNED) cp_async_commit();
  }

  for (long long i = 0; i < n_tiles; ++i) {
    // tile i has landed for this thread's copies ...
    if constexpr (ALIGNED) cp_async_wait<STAGES - 2>();
    // ... and for every lane's; every lane has also finished tile i-1, so
    // its slot may be refilled
    __syncthreads();
    const long long next = i + STAGES - 1;
    if (next < n_tiles) {
      const int slot = (int)(next % STAGES);
      fill<T, ALIGNED>(sa + slot * SLOT, a, row0, next * TILE_ROWS, T_len,
                       D, c0, lane);
      fill<T, ALIGNED>(sb + slot * SLOT, b, row0, next * TILE_ROWS, T_len,
                       D, c0, lane);
    }
    if constexpr (ALIGNED) cp_async_commit();

    const int slot = (int)(i % STAGES);
    const long long t0 = i * TILE_ROWS;
    const int rows = (int)(T_len - t0 < TILE_ROWS ? T_len - t0 : TILE_ROWS);
    if (mine) {
      const T* ta = sa + slot * SLOT + lane;
      const T* tb = sb + slot * SLOT + lane;
      T* o = out + (row0 + t0) * D + d;
      if (rows == TILE_ROWS) {
#pragma unroll
        for (int r = 0; r < TILE_ROWS; ++r) {
          h = from_float<T>(__fmul_rn(to_float(ta[r * U::C]), to_float(h)));
          h = from_float<T>(__fadd_rn(to_float(h), to_float(tb[r * U::C])));
          o[r * D] = h;
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          h = from_float<T>(__fmul_rn(to_float(ta[r * U::C]), to_float(h)));
          h = from_float<T>(__fadd_rn(to_float(h), to_float(tb[r * U::C])));
          o[r * D] = h;
        }
      }
    }
  }
  if constexpr (ALIGNED) cp_async_wait<0>();
}

template <typename T, bool ALIGNED>
int launch(const void* a, const void* b, const void* h0, void* out,
           long long B, long long T_len, long long D, cudaStream_t s) {
  auto kernel = rg_lru_kernel<T, ALIGNED>;
  // all units of the serve shape resident at once: the most shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long units = B * ((D + Unit<T>::C - 1) / Unit<T>::C);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)units, WARP, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(h0), static_cast<T*>(out), T_len, D);
  return (int)cudaGetLastError();
}

template <typename T, bool ALIGNED>
int attributes(int* regs, int* local_bytes, int* static_smem,
               int* dynamic_smem) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, rg_lru_kernel<T, ALIGNED>);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  *static_smem = (int)at.sharedSizeBytes;
  *dynamic_smem = 0;    // the launch asks for none
  return 0;
}

}  // namespace

// The specialization rg_lru_launch takes for these operands: 1 the aligned
// one (16-byte cp.async: a and b 16-byte aligned and D * sizeof(T) a
// multiple of 16), 0 the general one; -1 for an unknown dtype.  h0 and out
// are read and written an element at a time, so their alignment is moot.
extern "C" int rg_lru_route(int dtype, const void* a, const void* b,
                            long long D) {
  if (dtype != 0 && dtype != 1) return -1;
  const long long elt = dtype == 0 ? 4 : 2;
  return ((((uintptr_t)a | (uintptr_t)b) & 15) || (D * elt) % 16) ? 0 : 1;
}

// dtype: 0 float32, 1 bfloat16.  h0 may be null (zeros).  Launches the
// specialization rg_lru_route picks on `stream` without synchronizing;
// returns the CUDA error code.
extern "C" int rg_lru_launch(int dtype, const void* a, const void* b,
                             const void* h0, void* out, long long B,
                             long long T_len, long long D, void* stream) {
  if (B == 0 || T_len == 0 || D == 0) return 0;
  const int route = rg_lru_route(dtype, a, b, D);
  if (route < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return dtype == 0
               ? launch<float, true>(a, b, h0, out, B, T_len, D, s)
               : launch<__nv_bfloat16, true>(a, b, h0, out, B, T_len, D, s);
  return dtype == 0
             ? launch<float, false>(a, b, h0, out, B, T_len, D, s)
             : launch<__nv_bfloat16, false>(a, b, h0, out, B, T_len, D, s);
}

// One specialization's registers per thread, local memory per thread
// (spills), and static and dynamic shared memory per CTA, as the runtime
// reports them; returns the CUDA error code.
extern "C" int rg_lru_attributes(int dtype, int route, int* regs,
                                 int* local_bytes, int* static_smem,
                                 int* dynamic_smem) {
  if (dtype == 0)
    return route ? attributes<float, true>(regs, local_bytes, static_smem,
                                           dynamic_smem)
                 : attributes<float, false>(regs, local_bytes, static_smem,
                                            dynamic_smem);
  if (dtype == 1)
    return route ? attributes<__nv_bfloat16, true>(regs, local_bytes,
                                                   static_smem, dynamic_smem)
                 : attributes<__nv_bfloat16, false>(regs, local_bytes,
                                                    static_smem, dynamic_smem);
  return (int)cudaErrorInvalidValue;
}
