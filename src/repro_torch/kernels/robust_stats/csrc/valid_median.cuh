// Valid-masked coordinate-wise median of up to 32 candidate values, the
// sorting network it runs on, and the upper-triangle pair order; shared by
// wfagg_round.cu (kernel 1) and robust_stats_indexed.cu (kernel 2) through
// indexed_phase0.cuh, so the two cannot drift apart.
//
// The median mirrors _valid_median of the Pallas kernels
// (src/repro/kernels/robust_stats/kernel.py) and ref.valid_median of the port:
// invalid slots and the padding up to the template width KP in {8, 16, 32}
// sort as +inf, and the median is 0.5 * (s[lo] + s[hi]) at the dynamic middles
// lo = (v-1)/2, hi = v/2 of the valid count v; the empty median (v = 0) is 0.
// The compare-exchange is fminf / fmaxf: the gossip round sanitizes its rows
// first (a non-finite row is zeroed and its edges demoted), so no NaN reaches
// the network on the paths that call it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wfagg_common {

template <int KP>
__device__ __forceinline__ void bitonic_sort(float (&a)[KP]) {
#pragma unroll
  for (int size = 2; size <= KP; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const float lo = fminf(a[i], a[j]);
          const float hi = fmaxf(a[i], a[j]);
          const bool up = (i & size) == 0;
          a[i] = up ? lo : hi;
          a[j] = up ? hi : lo;
        }
      }
    }
  }
}

// median of u[k] over the slots k whose bit is set in vbits (v of them)
template <int KP>
__device__ __forceinline__ float valid_median(const float (&u)[KP], unsigned vbits,
                                              int v) {
  float s[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) s[k] = ((vbits >> k) & 1u) ? u[k] : INFINITY;
  bitonic_sort<KP>(s);
  const int lo = (v - 1) >> 1, hi = v >> 1;
  float mlo = 0.f, mhi = 0.f;
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    if (i == lo) mlo = s[i];
    if (i == hi) mhi = s[i];
  }
  return v > 0 ? 0.5f * (mlo + mhi) : 0.f;
}

// valid_median when every one of the KP slots is valid (v == KP): the middles
// are fixed, so the network needs no masks and the compiler drops the
// compare-exchanges whose outputs no middle reads; bit-identical to
// valid_median<KP>(u, all ones, KP)
template <int KP>
__device__ __forceinline__ float full_median(const float (&u)[KP]) {
  float s[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) s[k] = u[k];
  bitonic_sort<KP>(s);
  return 0.5f * (s[KP / 2 - 1] + s[KP / 2]);
}

// pair p of the row-major upper triangle (i <= j) of an n x n matrix
__device__ __forceinline__ void pair_of(int p, int n, int& i, int& j) {
  i = 0;
  while (p >= n - i) {
    p -= n - i;
    ++i;
  }
  j = i + p;
}

}  // namespace wfagg_common
