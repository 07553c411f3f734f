// Stand-ins for the CUDA keywords and intrinsics that mltcp_cc.cuh and the
// chunk kernel's body use, so that a host C++ compiler (g++ -std=c++20
// -ffp-contract=off) builds them for the CPU check of the kernel's logic
// (tests/test_torch_chunk.py).  Not used by nvcc.
//
// A CTA becomes `blockDim` host threads that meet at a std::barrier in
// place of __syncthreads; each thread's threadIdx is thread-local.
#pragma once

#include <barrier>
#include <cmath>
#include <cstring>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)

using std::isinf;
using std::isnan;

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}

namespace host_compat {
inline thread_local std::barrier<>* cta_barrier = nullptr;
}  // namespace host_compat

inline void __syncthreads() {
  if (host_compat::cta_barrier) host_compat::cta_barrier->arrive_and_wait();
}
