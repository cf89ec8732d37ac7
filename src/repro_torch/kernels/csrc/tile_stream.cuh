// Streaming helpers shared by the port's hand-written kernels for Hopper
// (sm_90a): asynchronous global -> shared copies (cp.async) and vector loads
// of 16, 8 or 4 bytes.  Used by pairwise_dist/csrc/pairwise_gram.cu
// (kernel 6), robust_stats/csrc/indexed_phase0.cuh (kernels 1 and 2),
// robust_stats/csrc/robust_stats.cu (kernels 4 and 5) and
// weighted_agg/csrc/*.cu (kernels 3 and 7).
//
// A copy or a vector is VEC floats: 16 bytes where D % 4 == 0 and every
// matrix is 16-byte aligned, else 8 bytes where D % 2 == 0 and 8-byte
// aligned, else 4 (the paper's d = 44,426 has D % 4 = 2).  With D % VEC == 0
// a copy is either all inside a row or all past its end, and a copy past the
// end is zero-filled through cp.async's src-size operand: nothing is padded
// in device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace tile_stream {

// VEC floats global -> shared; zero-filled when !in (src is then not read)
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool in) {
  const int n = in ? 4 * VEC : 0;
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(4 * VEC), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest `Pending` has landed (this thread's copies)
template <int Pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// every group but the newest n has landed, for a ring depth known only at
// run time (cp.async.wait_group takes an immediate): exact for n = 0 .. 6,
// and for n > 6 it waits for more than it must
__device__ __forceinline__ void wait_pending(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: wait<0>(); break;
    case 1: wait<1>(); break;
    case 2: wait<2>(); break;
    case 3: wait<3>(); break;
    case 4: wait<4>(); break;
    case 5: wait<5>(); break;
    default: wait<6>(); break;
  }
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC consecutive floats from global memory (read-only path)
template <int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    p[0] = x[0];
}

// the widest copy (4, 2 or 1 floats) that rows of length D at these bases
// allow; null pointers are skipped
inline int copy_width(long long D, std::initializer_list<const void*> bases) {
  bool a16 = D % 4 == 0, a8 = D % 2 == 0;
  for (const void* p : bases) {
    if (p == nullptr) continue;
    a16 = a16 && (uintptr_t)p % 16 == 0;
    a8 = a8 && (uintptr_t)p % 8 == 0;
  }
  return a16 ? 4 : a8 ? 2 : 1;
}

}  // namespace tile_stream
