// Valid-masked coordinate-wise median of up to 32 candidate values, and the
// Gram work split; shared by wfagg_round.cu (kernel 1) and
// robust_stats_indexed.cu (kernel 2), so the two cannot drift apart.
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

constexpr int kThreads = 256;          // threads per CTA = coordinates per tile
constexpr int kStride = kThreads + 1;  // shared row stride of a staged tile

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

// ---- the (K, K) Gram over a staged tile --------------------------------
//
// The P = K(K+1)/2 pairs i <= j of the row-major upper triangle are split
// into P * S work items, S = max(1, kThreads / P) parts of the tile's
// coordinates each: item w is pair w / S over coordinates [s*L, (s+1)*L) of
// the tile, s = w % S, L = ceil(kThreads / S).  A thread keeps the running
// sum of its items (at most kGramItems) over the tiles it walks, adding the
// products in coordinate order with fmaf.  The parts of a pair are added in
// part order at the end.  Every pair is split and ordered the same way, so
// two bit-identical rows a, b give bit-identical sums for (a, x) and (b, x):
// Multi-Krum's and Clustering's index tie-breaks rely on it.

template <int KP>
constexpr int kGramItems = (KP * (KP + 1) / 2 + kThreads - 1) / kThreads;

// pair p of the row-major upper triangle (i <= j)
__device__ __forceinline__ void pair_of(int p, int K, int& i, int& j) {
  i = 0;
  while (p >= K - i) {
    p -= K - i;
    ++i;
  }
  j = i + p;
}

struct GramSplit {
  int P, S, L;
  __device__ __forceinline__ explicit GramSplit(int K)
      : P(K * (K + 1) / 2),
        S(P >= kThreads ? 1 : kThreads / P),
        L((kThreads + S - 1) / S) {}
};

template <int KP>
struct GramItems {
  int a[kGramItems<KP>], b[kGramItems<KP>], c0[kGramItems<KP>], c1[kGramItems<KP>];
  float acc[kGramItems<KP>];

  __device__ __forceinline__ void init(const GramSplit& g, int K, int tid) {
#pragma unroll
    for (int r = 0; r < kGramItems<KP>; ++r) {
      const int w = tid + r * kThreads;
      a[r] = b[r] = 0;
      c0[r] = c1[r] = 0;
      acc[r] = 0.f;
      if (w < g.P * g.S) {
        int i, j;
        pair_of(w / g.S, K, i, j);
        a[r] = i * kStride;
        b[r] = j * kStride;
        c0[r] = (w % g.S) * g.L;
        c1[r] = min(c0[r] + g.L, kThreads);
      }
    }
  }

  // add this tile's products; `tile` holds K rows of kThreads coordinates
  __device__ __forceinline__ void add(const float* tile) {
#pragma unroll
    for (int r = 0; r < kGramItems<KP>; ++r) {
      const float* x = tile + a[r];
      const float* y = tile + b[r];
      float t = acc[r];
#pragma unroll 8
      for (int c = c0[r]; c < c1[r]; ++c) t = fmaf(x[c], y[c], t);
      acc[r] = t;
    }
  }

  // this thread's item sums into part[w] (P * S floats)
  __device__ __forceinline__ void store(const GramSplit& g, float* part, int tid) const {
#pragma unroll
    for (int r = 0; r < kGramItems<KP>; ++r) {
      const int w = tid + r * kThreads;
      if (w < g.P * g.S) part[w] = acc[r];
    }
  }
};

// sum of pair p's parts, in part order
__device__ __forceinline__ float gram_pair_sum(const GramSplit& g, const float* part,
                                               int p) {
  float t = 0.f;
  for (int s = 0; s < g.S; ++s) t += part[p * g.S + s];
  return t;
}

}  // namespace wfagg_common
