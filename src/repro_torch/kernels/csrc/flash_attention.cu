// Flash attention, forward, for Hopper (sm_90a): online softmax with float32
// accumulators on the tensor cores, grouped KV heads, causal and
// sliding-window masks and the Gemma-2 tanh logit softcap.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (launched by
// flash_attention_fwd), which walks a sequential grid axis over 512-key
// blocks with the running max, normaliser and accumulator in VMEM scratch.
// Here one CTA owns one (batch, query head, 64-query tile) and loops over
// 32-key tiles itself; the running max m, normaliser l and the [64, D]
// accumulator stay in registers for the whole loop.
//
// What bounds it.  At the serve shape (B=4, T=S=4096, H=10, K=1, D=256,
// causal, window 2048) the unmasked pairs need 2.58e11 FLOP against
// 0.37 GB of operands: operations.  In float32 on the CUDA cores that is
// 3.85 ms at 67 TFLOP/s; TF32 alone (495 TFLOP/s) keeps ~3 decimal digits
// and misses the 2e-5 bound, so float32 inputs go through split TF32: each
// operand x is split into hi = x with its 13 low mantissa bits cleared and
// lo = x - hi (exact in f32), and each product is taken as
// hi*hi + hi*lo + lo*hi in f32 accumulators (lo*lo, below 2^-20 of the
// product, is dropped; the tensor core reads only the top 19 bits of lo).
// Three TF32 products per f32 product: 3 x 2.58e11 FLOP over 495 TFLOP/s
// = 1.56 ms is the floor of this scheme.  bfloat16 inputs take bf16 MMA
// (m16n8k16) for Q.K^T, exact since bf16 products fit f32, and for P.V with
// p rounded to bf16 (the row sum l takes the unrounded f32 p): 2^-9
// relative on each p keeps the output well inside the 2e-2 bound.
// tests/test_torch_flash_numerics.py emulates both schemes on the CPU.
//
// Design.
//   * mma.sync with the work split two ways: 8 warps, 4 row groups of 16
//     query rows x 2 halves of D (warp w: rows 16 (w & 3), columns
//     (w >> 2) D/2).  Per 32-key tile a warp computes the partial scores of
//     its rows over its half of d as 4 accumulator tiles of 16x8 (hi*hi in
//     one set, the two cross products in another), the two warps of a row
//     group swap them through shared memory behind a named barrier of 64
//     threads and both add them in the same order, so both hold the same S
//     and run the same online softmax in the accumulators' own layout (a
//     thread holds 2 rows x 8 keys; row max by two quad shuffles; exp2f; the
//     row sum stays per thread until the end).  Then each warp adds P.V for
//     its half of the output columns into D/16 accumulator tiles.  Splitting
//     D halves the accumulator (64 floats a thread at D=256), which is what
//     lets 8 warps, two per scheduler, fit the register file.  P goes from
//     the S accumulators to the A operand without shared memory: for f32
//     the 8 keys of a k-step are permuted (A column t <-> key 2t, t+4 <->
//     2t+1) and V's rows are read in the same order; for bf16 two S tiles
//     are one m16n8k16 A operand as they are.
//   * Fragment loads are 16-byte shared loads.  Q.K^T contracts over d, so
//     d is permuted within each 16 (f32) or 32 (bf16) columns so that a
//     thread's operands for two k-steps are 4 (8) adjacent elements.  For
//     f32 P.V the output columns are permuted the same way (n-tile j, lane
//     column c <-> 32*(j/4) + 4c + j%4 within the warp's half), and the
//     store undoes it; bf16 V goes through ldmatrix.trans.  Rows are padded
//     (Q and K by 64 bytes mod 128, V by 16 bytes) so every such load is
//     free of bank conflicts.
//   * Asynchronous K/V: a ring of two stages in shared memory, filled with
//     16-byte cp.async by all threads (zero-fill past the sequence's end).
//     One __syncthreads per tile: after it, tile j is visible and tile j-1
//     is no longer read, so tile j+1 goes into j-1's stage and loads while
//     tile j computes.  The Q tile is loaded once, the same way.
//   * Budget at D = 256, f32: Q 64x272, K 2x32x272, V 2x32x260 floats and
//     the 16 KB score exchange: 222,208 B of shared memory, one 256-thread
//     CTA per SM; 188 registers a thread and no spills (ptxas -v, and
//     chip_smoke.py reads both from the runtime for every instantiation).
//   * Less wasted work: key tiles that the masks empty for the whole CTA are
//     never loaded; a row group skips a tile empty for its 16 rows; the mask
//     is computed only on edge tiles; the O rescale is skipped when no
//     row's max moved.  The grid is (B*H, T/64) with the last query tiles
//     (the heaviest under a causal mask) first, and the CTAs of one KV head
//     adjacent, so their K/V tiles are shared in L2.
//   * GQA: query head h reads KV head h / (H / K) in the model's own
//     [B, S, K, D] layout; q, k, v and the output are never copied.
//   * The kernel's times on the card, its gap to both bounds and the
//     variants that did not help are in PERF.md.
//
// Semantics follow the TPU kernel: s = (q.k) * scale, then the softcap,
// then masked entries excluded (p = 0); output acc / max(l, 1e-30).
// chip_smoke.py holds the kernel within 2e-5 (f32) / 2e-2 (bf16 inputs) of
// the dense plain version, kernels/ref.py::ref_attention.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 32;            // keys per tile
constexpr int WARPS = 8;          // 4 row groups x 2 halves of D
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;         // K/V ring depth
constexpr int NT = BK / 8;        // 16x8 score tiles per warp and tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

template <typename T, int D>
struct Layout {
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  // a padded K row starts 64 bytes (mod 128) after the one before it, a
  // padded V row 16 bytes (mod 32): see the note on bank conflicts
  static constexpr int K_PAD = (64 - ROW_BYTES % 128 + 128) % 128;
  static constexpr int K_STRIDE = (ROW_BYTES + K_PAD) / (int)sizeof(T);
  static constexpr int V_STRIDE = (ROW_BYTES + 16) / (int)sizeof(T);
  static constexpr int Q_ELEMS = BQ * K_STRIDE;
  static constexpr int K_ELEMS = BK * K_STRIDE;
  static constexpr int V_ELEMS = BK * V_STRIDE;
  static constexpr int KV_BYTES =
      STAGES * (K_ELEMS + V_ELEMS) * (int)sizeof(T);
  // each warp's partial scores, [WARPS][4 * NT][32] floats
  static constexpr int XCH_BYTES = WARPS * 4 * NT * 32 * 4;
  static constexpr int Q_BYTES = Q_ELEMS * (int)sizeof(T);
  static constexpr int BYTES = KV_BYTES + XCH_BYTES + Q_BYTES;
};

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a [*, D] operand whose rows are `gstride`
// elements apart, into shared memory rows `sstride` apart; rows at or past
// `n_rows` are zero-filled
template <typename T, int D, int ROWS = BK>
__device__ __forceinline__ void load_tile(T* dst, int sstride, const T* src,
                                          long long gstride, int row0,
                                          int n_rows, int tid) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  constexpr int EPC = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = row0 + r < n_rows;
    const T* g = ok ? src + (long long)(row0 + r) * gstride + c * EPC : src;
    cp_async16(dst + r * sstride + c * EPC, g, ok);
  }
}

// a named barrier for the two warps that share a row group
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

// ---------------------------------------------------------------------------
// tensor-core products
// ---------------------------------------------------------------------------

// x = hi + lo with hi = x with its 13 low mantissa bits cleared (a TF32
// value) and lo = x - hi, exact in f32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k8 / m16n8k16), lane = 4*g + t:
// the accumulator c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, same).
//
// Partial S[16 x 32] = Q[16 rows, DH columns] . K_tile[:, same]^T, f32 by
// split TF32.  Within each 16 columns of d, k-step 0 reads columns 4t,
// 4t+1 as its A/B columns t, t+4 and k-step 1 columns 4t+2, 4t+3.
template <int DH, int LD>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* Qw,
                                       const float* Kt, int g, int t) {
  float sx[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = sx[n][e] = 0.0f;
#pragma unroll
  for (int kp = 0; kp < DH / 16; ++kp) {
    const float4 qa = *reinterpret_cast<const float4*>(
        Qw + g * LD + 16 * kp + 4 * t);
    const float4 qb = *reinterpret_cast<const float4*>(
        Qw + (g + 8) * LD + 16 * kp + 4 * t);
    uint32_t ah[2][4], al[2][4];
    split(qa.x, ah[0][0], al[0][0]);
    split(qb.x, ah[0][1], al[0][1]);
    split(qa.y, ah[0][2], al[0][2]);
    split(qb.y, ah[0][3], al[0][3]);
    split(qa.z, ah[1][0], al[1][0]);
    split(qb.z, ah[1][1], al[1][1]);
    split(qa.w, ah[1][2], al[1][2]);
    split(qb.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 kb = *reinterpret_cast<const float4*>(
          Kt + (8 * n + g) * LD + 16 * kp + 4 * t);
      uint32_t bh[2][2], bl[2][2];
      split(kb.x, bh[0][0], bl[0][0]);
      split(kb.y, bh[0][1], bl[0][1]);
      split(kb.z, bh[1][0], bl[1][0]);
      split(kb.w, bh[1][1], bl[1][1]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        mma_tf32(s[n], ah[ks], bh[ks]);
        mma_tf32(sx[n], ah[ks], bl[ks]);
        mma_tf32(sx[n], al[ks], bh[ks]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += sx[n][e];
}

// The same in bf16 MMA: within each 32 columns of d, k-step 0 reads
// columns 8t..8t+3 as its k 2t, 2t+1, 2t+8, 2t+9 and k-step 1 8t+4..8t+7
// (DH = 16: one k-step on columns 4t..4t+3).
template <int DH, int LD>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                       const __nv_bfloat16* Qw,
                                       const __nv_bfloat16* Kt, int g,
                                       int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
  if constexpr (DH < 32) {
    const uint2 qa = *reinterpret_cast<const uint2*>(Qw + g * LD + 4 * t);
    const uint2 qb = *reinterpret_cast<const uint2*>(
        Qw + (g + 8) * LD + 4 * t);
    const uint32_t a[4] = {qa.x, qb.x, qa.y, qb.y};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint2 kb = *reinterpret_cast<const uint2*>(
          Kt + (8 * n + g) * LD + 4 * t);
      mma_bf16(s[n], a, kb.x, kb.y);
    }
  } else {
#pragma unroll
    for (int kp = 0; kp < DH / 32; ++kp) {
      const uint4 qa = *reinterpret_cast<const uint4*>(
          Qw + g * LD + 32 * kp + 8 * t);
      const uint4 qb = *reinterpret_cast<const uint4*>(
          Qw + (g + 8) * LD + 32 * kp + 8 * t);
      const uint32_t a0[4] = {qa.x, qb.x, qa.y, qb.y};
      const uint32_t a1[4] = {qa.z, qb.z, qa.w, qb.w};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4 kb = *reinterpret_cast<const uint4*>(
            Kt + (8 * n + g) * LD + 32 * kp + 8 * t);
        mma_bf16(s[n], a0, kb.x, kb.y);
        mma_bf16(s[n], a1, kb.z, kb.w);
      }
    }
  }
}

// n-tiles whose B operands one f32 V load brings in
template <int DH>
struct VGroup {
  static constexpr int NJ = DH / 8 >= 4 ? 4 : DH / 8;
};

// O[16 x DH] += P[16 x 32] . V_tile[:, DH columns], f32 by split TF32.  A
// column t of the k-step over keys 8n..8n+7 is key 8n+2t, column t+4 key
// 8n+2t+1; output n-tile j, lane column c is column
// 8*NJ*(j/NJ) + NJ*c + j%NJ of the warp's DH.
template <int DH, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4],
                                           const float (&p)[NT][4],
                                           const float* Vt, int g, int t) {
  constexpr int NJ = VGroup<DH>::NJ;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ah[4], al[4];
    split(p[n][0], ah[0], al[0]);
    split(p[n][2], ah[1], al[1]);
    split(p[n][1], ah[2], al[2]);
    split(p[n][3], ah[3], al[3]);
    const float* v0 = Vt + (8 * n + 2 * t) * LD + NJ * g;
    const float* v1 = v0 + LD;
#pragma unroll
    for (int jb = 0; jb < DH / (8 * NJ); ++jb) {
      float b0[4], b1[4];
      if constexpr (NJ == 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * jb);
        const float4 x1 = *reinterpret_cast<const float4*>(v1 + 32 * jb);
        b0[0] = x0.x; b0[1] = x0.y; b0[2] = x0.z; b0[3] = x0.w;
        b1[0] = x1.x; b1[1] = x1.y; b1[2] = x1.z; b1[3] = x1.w;
      } else {                     // DH = 16: two n-tiles per load
        const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * jb);
        const float2 x1 = *reinterpret_cast<const float2*>(v1 + 16 * jb);
        b0[0] = x0.x; b0[1] = x0.y; b0[2] = b0[3] = 0.0f;
        b1[0] = x1.x; b1[1] = x1.y; b1[2] = b1[3] = 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        uint32_t bh[2], bl[2];
        split(b0[jj], bh[0], bl[0]);
        split(b1[jj], bh[1], bl[1]);
        mma_tf32(acc[NJ * jb + jj], ah, bh);
        mma_tf32(acc[NJ * jb + jj], ah, bl);
        mma_tf32(acc[NJ * jb + jj], al, bh);
      }
    }
  }
}

// O += P.V in bf16 MMA: two score tiles are one m16n8k16 A operand; V's
// B operands come from ldmatrix.trans, two output n-tiles per load.
template <int DH, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4],
                                           const float (&p)[NT][4],
                                           const __nv_bfloat16* Vt, int g,
                                           int t) {
  const int lane = 4 * g + t;
  const int mi = lane >> 3;
  const int row = ((mi & 1) << 3) + (lane & 7);
  const int col = (mi >> 1) << 3;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]),
                           pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
    const unsigned base = (unsigned)__cvta_generic_to_shared(
        Vt + (16 * i + row) * LD + col);
#pragma unroll
    for (int jp = 0; jp < DH / 16; ++jp) {
      uint32_t r0, r1, r2, r3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0,%1,%2,%3}, [%4];\n"
          : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
          : "r"(base + 32u * jp));
      mma_bf16(acc[2 * jp], a, r0, r1);
      mma_bf16(acc[2 * jp + 1], a, r2, r3);
    }
  }
}

// the thread's part of an output row: f32 undoes the column permutation of
// `accumulate` (2 * NJ adjacent columns per 8 * NJ), bf16 stores pairs
template <int DH>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&acc)[DH / 8][4],
                                          int half, float inv, int t) {
  constexpr int NJ = VGroup<DH>::NJ;
#pragma unroll
  for (int jb = 0; jb < DH / (8 * NJ); ++jb)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float* d = dst + 8 * NJ * jb + 2 * NJ * t + jj;
      d[0] = acc[NJ * jb + jj][2 * half] * inv;
      d[NJ] = acc[NJ * jb + jj][2 * half + 1] * inv;
    }
}

template <int DH>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&acc)[DH / 8][4],
                                          int half, float inv, int t) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
        pack_bf16(acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(Params p) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int DH = D / 2;               // columns of d a warp owns
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + STAGES * L::K_ELEMS;
  float* xch = reinterpret_cast<float*>(smem_raw + L::KV_BYTES);
  T* Qs = reinterpret_cast<T*>(smem_raw + L::KV_BYTES + L::XCH_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = warp & 3;                // row group: rows 16 rg .. +15
  const int half = warp >> 2;             // columns half*DH .. +DH-1
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first

  const long long q_stride = (long long)p.H * D;
  const long long kv_stride = (long long)p.K * D;
  const T* qg = static_cast<const T*>(p.q) +
                ((long long)b * p.T * p.H + h) * D;
  const T* kg = static_cast<const T*>(p.k) +
                ((long long)b * p.S * p.K + kh) * D;
  const T* vg = static_cast<const T*>(p.v) +
                ((long long)b * p.S * p.K + kh) * D;

  // key tiles that hold at least one unmasked (query, key) pair
  const int q_last = min(q0 + BQ, p.T) - 1;
  int k_begin = 0;
  int k_end = p.S;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // q, then the ring's first STAGES - 1 tiles, one commit group each (q
  // rides with the first)
  load_tile<T, D, BQ>(Qs, L::K_STRIDE, qg, q_stride, q0, p.T, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile<T, D>(Ks + st * L::K_ELEMS, L::K_STRIDE, kg, kv_stride,
                      k_begin + st * BK, p.S, tid);
      load_tile<T, D>(Vs + st * L::V_ELEMS, L::V_STRIDE, vg, kv_stride,
                      k_begin + st * BK, p.S, tid);
    }
    cp_async_commit();
  }

  const int wq0 = q0 + 16 * rg;           // the warp's first query row
  const int wq1 = wq0 + 15;
  const int row_q[2] = {wq0 + g, wq0 + g + 8};
  const T* Qw = Qs + 16 * rg * L::K_STRIDE + half * DH;
  float* x_mine = xch + warp * (4 * NT * 32) + lane;
  const float* x_pair = xch + (warp ^ 4) * (4 * NT * 32) + lane;

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};              // this thread's part of the row sum
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    cp_async_wait<STAGES - 2>();          // tile it has landed (this thread)
    __syncthreads();                      // ... for every thread; tile
                                          // it - 1 is no longer read
    {
      const int nx = it + STAGES - 1;     // refill the stage of tile it - 1
      const int st = nx % STAGES;
      if (nx < n_tiles) {
        load_tile<T, D>(Ks + st * L::K_ELEMS, L::K_STRIDE, kg, kv_stride,
                        k_begin + nx * BK, p.S, tid);
        load_tile<T, D>(Vs + st * L::V_ELEMS, L::V_STRIDE, vg, kv_stride,
                        k_begin + nx * BK, p.S, tid);
      }
      cp_async_commit();
    }

    const bool empty = (p.causal && k0 > wq1) ||
                       (p.window > 0 && k0 + BK - 1 <= wq0 - p.window);
    if (empty) continue;                  // the same for both warps of a pair
    const T* Kt = Ks + (it % STAGES) * L::K_ELEMS + half * DH;
    const T* Vt = Vs + (it % STAGES) * L::V_ELEMS + half * DH;

    // S over the warp's half of d, then the pair's sum (the same float sum
    // in both warps, so both run the same softmax)
    float s[NT][4];
    scores<DH, L::K_STRIDE>(s, Qw, Kt, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_mine[(4 * n + e) * 32] = s[n][e];
    pair_sync(1 + rg);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += x_pair[(4 * n + e) * 32];

    // the mask, only on tiles where some pair of the warp is masked
    const bool interior = k0 + BK <= p.S &&
                          (!p.causal || k0 + BK - 1 <= wq0) &&
                          (p.window <= 0 || k0 > wq1 - p.window);
    uint32_t valid = 0xffffu;             // bit 4n + e: s[n][e] unmasked
    if (!interior) {
      valid = 0u;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          const int qpos = row_q[e >> 1];
          bool ok = kpos < p.S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          valid |= (uint32_t)ok << (4 * n + e);
        }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        x = (valid >> (4 * n + e)) & 1u ? x : NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = (valid >> (4 * n + e)) & 1u
                             ? exp2f((s[n][e] - m[e >> 1]) * LOG2E)
                             : 0.0f;
        s[n][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + rs[r];
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
    }
    accumulate<DH, L::V_STRIDE>(acc, s, Vt, g, t);
  }
  cp_async_wait<0>();

  T* og = static_cast<T*>(p.o) + ((long long)b * p.T * p.H + h) * D +
          half * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (row_q[r] < p.T)
      store_row<DH>(og + (long long)row_q[r] * q_stride, acc, r,
                    1.0f / fmaxf(lr, 1e-30f), t);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Layout<T, D>::BYTES;
  static_assert(bytes <= 232448, "tiles exceed the SM's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.T + BQ - 1) / BQ));
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

template <typename T, int D>
int attributes(int* regs, int* local_bytes, int* smem_bytes) {
  // the same opt-in as `launch`, so the runtime reports the dynamic shared
  // memory a launch gets
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<T, D>::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, flash_kernel<T, D>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes + a.maxDynamicSharedSizeBytes;
  return 0;
}

template <typename T>
int attributes_d(int d, int* regs, int* local_bytes, int* smem_bytes) {
  switch (d) {
    case 32: return attributes<T, 32>(regs, local_bytes, smem_bytes);
    case 64: return attributes<T, 64>(regs, local_bytes, smem_bytes);
    case 128: return attributes<T, 128>(regs, local_bytes, smem_bytes);
    case 192: return attributes<T, 192>(regs, local_bytes, smem_bytes);
    case 256: return attributes<T, 256>(regs, local_bytes, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The compiled kernel's registers per thread, local memory per thread
// (spills) and shared memory per CTA (static plus the dynamic size a launch
// is allowed), as the runtime reports them, for one (dtype, D)
// instantiation; returns the CUDA error code.
extern "C" int flash_attention_attributes(int dtype, int d, int* regs,
                                          int* local_bytes, int* smem_bytes) {
  if (dtype == 0) return attributes_d<float>(d, regs, local_bytes, smem_bytes);
  if (dtype == 1)
    return attributes_d<__nv_bfloat16>(d, regs, local_bytes, smem_bytes);
  return (int)cudaErrorInvalidValue;
}

// q [B, T, H, D], k/v [B, S, K, D], o [B, T, H, D], contiguous, 16-byte
// aligned, all of one dtype (0 float32, 1 bfloat16); D one of 32, 64, 128,
// 192, 256; H a multiple of K.  Launches on `stream` without synchronizing;
// returns the CUDA error code (0 on success).
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
