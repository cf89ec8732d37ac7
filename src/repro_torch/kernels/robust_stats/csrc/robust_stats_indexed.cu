// Gather-free robust statistics of a gossip round, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _robust_stats_indexed_kernel
// (src/repro/kernels/robust_stats/kernel.py:191), launched by
// robust_stats_indexed_pallas (kernel.py:271): phase 0 of the round kernel
// alone, the statistics launch of the two-launch backend.  For every
// receiving node n with neighbour rows u_k = models[idx[n, k]] (k < K <= 32),
// read through the index table (the (N, K, D) gossip tensor never exists),
// it computes the valid-masked coordinate-wise median med and
//   dist2[n, k]  sum_d (u_k - med)^2     dotmed[n, k]  sum_d u_k * med
//   norm2[n, k]  sum_d u_k^2             mednorm2[n]   sum_d med^2
// with prev (the previous round's model matrix, read through the same table,
// or through its own (N, K) table prev_idx in the prev_idx variant: the chaos
// transport's last served payload of each edge) the WFAgg-T tail prev_dist2 /
// prev_dot / prev_norm2, and with need_gram the (K, K) candidate Gram of every
// node (Alt-WFAgg).
//
// Bound on this card: bytes without the Gram.  It must read each node's K
// rows (and prev rows) once: 4 * N * K * D bytes, twice with prev, at 3.35
// TB/s.  The Gram adds K(K+1) flops per node coordinate; at K = 16 with the
// median network and the statistics that is about as much as the byte time
// at 67 TFLOP/s float32.
//
// Design, simple first:
//   * A grid of (D-chunk, node) CTAs of 256 threads.  Nothing needs a
//     grid-wide barrier, so the chunks per node are chosen to put about 4
//     CTAs on each of the card's SMs.  A CTA walks the 256-coordinate tiles
//     c, c + n_chunks, ... of its node.
//   * Thread t loads coordinate t of each of the node's K rows (coalesced
//     across the warp), stages it in shared memory (row stride 257) and takes
//     the valid-masked median of its column in registers (valid_median.cuh,
//     shared with the round kernel).
//   * The per-candidate sums come from shared memory: warp w adds the
//     candidates k = w, w + 8, ...; lane i adds the tile's coordinates i,
//     i + 32, ... in that order for every candidate, so two bit-identical rows
//     get bit-identical sums whichever warp owns them.  The Gram's pairs
//     i <= j are split into fixed (pair, coordinate range) items
//     (valid_median.cuh) and mirrored, so it is exactly symmetric and two
//     identical rows get identical Gram rows.
//   * No atomics.  Each CTA writes its partials to its own row of an
//     (N, n_chunks, 6K + 1 + K(K+1)/2) buffer; a second launch (one CTA per
//     node) adds the rows in chunk order.  Results repeat run to run.
// What it leaves on the table: loads are 4 bytes a thread and wait on a
// barrier per tile (no cp.async / TMA pipeline); the Gram reads shared memory
// twice per multiply-add (no register blocking).
//
// prev may be models itself (the chaos round's stacked matrix): both are only
// read, so the two __restrict__ pointers may alias.
//
// No fast-math: invalid slots sort as +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "valid_median.cuh"

namespace {

using wfagg_common::GramItems;
using wfagg_common::GramSplit;
using wfagg_common::kStride;
using wfagg_common::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// fields of a partial / output row: F_COUNT blocks of K, then mednorm2, then
// the Gram's pairs (need_gram)
enum { F_D2 = 0, F_DM, F_N2, F_PD2, F_PDT, F_PN2, F_COUNT };

__host__ __device__ __forceinline__ int n_fields(int K, bool gram) {
  return F_COUNT * K + 1 + (gram ? K * (K + 1) / 2 : 0);
}

// xor butterfly: every lane ends with the same, bit-identical sum
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int KP, bool kGram>
__global__ void __launch_bounds__(kThreads)
indexed_partials_kernel(const float* __restrict__ models, const int32_t* __restrict__ idx,
                        const uint8_t* __restrict__ valid, const float* __restrict__ prev,
                        const int32_t* __restrict__ prev_idx, float* __restrict__ partials,
                        int K, long long D) {
  constexpr int S = KP / kWarps;  // candidates per warp
  extern __shared__ float smem[];
  const bool has_prev = prev != nullptr;
  float* sU = smem;                                              // K * kStride
  float* sP = sU + (size_t)K * kStride;                          // with prev
  float* sMed = sP + (has_prev ? (size_t)K * kStride : 0);       // kThreads
  __shared__ const float* rows[KP];
  __shared__ const float* prows[KP];
  __shared__ unsigned vbits_s;
  __shared__ float red[kWarps];

  const int chunk = blockIdx.x, n_chunks = gridDim.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nk = (size_t)n * K;
  if (tid < K) {
    const long long r = idx[nk + tid];
    const long long pr = prev_idx != nullptr ? prev_idx[nk + tid] : r;
    rows[tid] = models + r * D;
    prows[tid] = has_prev ? prev + pr * D : nullptr;
  }
  if (warp == 0) {
    const bool vk = lane < K && valid[nk + lane] != 0;
    const unsigned b = __ballot_sync(kFull, vk);
    if (lane == 0) vbits_s = b;
  }
  __syncthreads();
  const unsigned vbits = vbits_s;
  const int v = __popc(vbits);

  float acc[S][F_COUNT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < F_COUNT; ++q) acc[s][q] = 0.f;
  float mn2 = 0.f;
  const GramSplit gs(K);
  GramItems<KP> gi;
  if constexpr (kGram) gi.init(gs, K, tid);

  const long long n_tiles = (D + kThreads - 1) / kThreads;
  for (long long tile = chunk; tile < n_tiles; tile += n_chunks) {
    const long long j = tile * kThreads + tid;
    const bool in = j < D;
    float u[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      u[k] = 0.f;
      if (k < K) {
        u[k] = in ? __ldg(rows[k] + j) : 0.f;
        sU[k * kStride + tid] = u[k];
        if (has_prev) sP[k * kStride + tid] = in ? __ldg(prows[k] + j) : 0.f;
      }
    }
    // a coordinate past D holds zeros: its median is 0 and it adds +0 to
    // every sum
    const float med = wfagg_common::valid_median<KP>(u, vbits, v);
    sMed[tid] = med;
    mn2 += med * med;
    __syncthreads();

#pragma unroll
    for (int si = 0; si < S; ++si) {
      const int k = warp + kWarps * si;
      if (k < K) {
        const float* row = sU + k * kStride;
        const float* prow = sP + k * kStride;
        for (int i = lane; i < kThreads; i += 32) {
          const float x = row[i], m = sMed[i], dd = x - m;
          acc[si][F_D2] += dd * dd;
          acc[si][F_DM] += x * m;
          acc[si][F_N2] += x * x;
          if (has_prev) {
            const float p = prow[i], dp = x - p;
            acc[si][F_PD2] += dp * dp;
            acc[si][F_PDT] += x * p;
            acc[si][F_PN2] += p * p;
          }
        }
      }
    }
    if constexpr (kGram) gi.add(sU);
    __syncthreads();
  }

  const int nf = n_fields(K, kGram);
  float* row = partials + ((size_t)n * n_chunks + chunk) * nf;
#pragma unroll
  for (int si = 0; si < S; ++si) {
    const int k = warp + kWarps * si;
    if (k < K) {
#pragma unroll
      for (int q = 0; q < F_COUNT; ++q) {
        const float x = warp_sum(acc[si][q]);
        if (lane == 0) row[q * K + k] = x;
      }
    }
  }
  const float m = warp_sum(mn2);
  if (lane == 0) red[warp] = m;
  // the staged tile is dead (the loop ended on a barrier): it takes the
  // Gram's parts
  if constexpr (kGram) gi.store(gs, sU, tid);
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w];
    row[F_COUNT * K] = t;
  }
  if constexpr (kGram) {
    for (int p = tid; p < gs.P; p += kThreads)
      row[F_COUNT * K + 1 + p] = wfagg_common::gram_pair_sum(gs, sU, p);
  }
}

// one CTA per node: each field's sum over the node's chunks, in chunk order;
// the Gram's pairs go to both triangles of gram (N, K, K)
__global__ void __launch_bounds__(kThreads)
indexed_finish_kernel(const float* __restrict__ partials, float* __restrict__ out,
                      float* __restrict__ gram, int K, int n_chunks) {
  const int n = blockIdx.x;
  const int nf = n_fields(K, gram != nullptr), ns = F_COUNT * K + 1;
  const float* base = partials + (size_t)n * n_chunks * nf;
  for (int q = threadIdx.x; q < nf; q += blockDim.x) {
    float t = 0.f;
    for (int c = 0; c < n_chunks; ++c) t += base[(size_t)c * nf + q];
    if (q < ns) {
      out[(size_t)n * ns + q] = t;
    } else {
      int i, j;
      wfagg_common::pair_of(q - ns, K, i, j);
      float* g = gram + (size_t)n * K * K;
      g[i * K + j] = t;
      g[j * K + i] = t;
    }
  }
}

template <int KP, bool kGram>
cudaError_t launch(const float* models, const int32_t* idx, const uint8_t* valid,
                   const float* prev, const int32_t* prev_idx, float* partials, float* out,
                   float* gram, int N, int K, long long D, int n_chunks,
                   cudaStream_t stream) {
  const size_t smem =
      ((size_t)K * kStride * (prev != nullptr ? 2 : 1) + kThreads) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(indexed_partials_kernel<KP, kGram>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  indexed_partials_kernel<KP, kGram><<<dim3(n_chunks, N), kThreads, smem, stream>>>(
      models, idx, valid, prev, prev_idx, partials, K, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  indexed_finish_kernel<<<N, kThreads, 0, stream>>>(partials, out, gram, K, n_chunks);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_width(const float* models, const int32_t* idx, const uint8_t* valid,
                         const float* prev, const int32_t* prev_idx, float* partials,
                         float* out, float* gram, int N, int K, long long D, int n_chunks,
                         cudaStream_t s) {
  return gram != nullptr ? launch<KP, true>(models, idx, valid, prev, prev_idx, partials, out,
                                            gram, N, K, D, n_chunks, s)
                         : launch<KP, false>(models, idx, valid, prev, prev_idx, partials, out,
                                             gram, N, K, D, n_chunks, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launches.
// prev, prev_idx and gram may be null (prev_idx needs prev; null reads prev
// through idx).  partials is (N, n_chunks, 6K + 1 [+ K(K+1)/2]),
// out is (N, 6K + 1): [dist2 | dotmed | norm2 | prev_dist2 | prev_dot |
// prev_norm2 | mednorm2] per node (the prev fields are 0 without prev); gram
// is (N, K, K).
extern "C" int robust_stats_indexed_launch(const float* models, const int32_t* idx,
                                           const uint8_t* valid, const float* prev,
                                           const int32_t* prev_idx, float* partials,
                                           float* out, float* gram, int N, int K,
                                           long long D, int n_chunks, void* stream) {
  if (N <= 0 || N > 65535 || K <= 0 || K > 32 || D <= 0 || n_chunks <= 0 ||
      (prev_idx != nullptr && prev == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 8)
    return (int)launch_width<8>(models, idx, valid, prev, prev_idx, partials, out, gram, N, K,
                                D, n_chunks, s);
  if (K <= 16)
    return (int)launch_width<16>(models, idx, valid, prev, prev_idx, partials, out, gram, N,
                                 K, D, n_chunks, s);
  return (int)launch_width<32>(models, idx, valid, prev, prev_idx, partials, out, gram, N, K,
                               D, n_chunks, s);
}
