// Gather-free robust statistics of a gossip round, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _robust_stats_indexed_kernel
// (src/repro/kernels/robust_stats/kernel.py:191), launched by
// robust_stats_indexed_pallas (kernel.py:271): phase 0 of the round kernel
// alone, the statistics launch of the two-launch backend.  For every
// receiving node n with neighbour rows u_k = models[idx[n, k]] (k < K <= 1024),
// read through the index table (the (N, K, D) gossip tensor never exists),
// it computes the valid-masked coordinate-wise median med and
//   dist2[n, k]  sum_d (u_k - med)^2     dotmed[n, k]  sum_d u_k * med
//   norm2[n, k]  sum_d u_k^2             mednorm2[n]   sum_d med^2
// with prev (the previous round's model matrix, read through the same table,
// or through its own (N, K) table prev_idx in the prev_idx variant: the chaos
// transport's last served payload of each edge; or a per-edge (N, K, D)
// tensor viewed as (N K, D) behind the table n K + k) the WFAgg-T tail
// prev_dist2 / prev_dot / prev_norm2, and with need_gram the (K, K) candidate
// Gram of every node (Alt-WFAgg).
//
// Bound on this card: bytes.  It must read each node's K rows (and prev
// rows) once: 4 N K D bytes per stream at 3.35 TB/s, less what L2 serves to
// nodes that share a neighbour (the floor counts each distinct row once).
// The Gram adds K (K + 1) flops per node coordinate; with the median network
// and the sums that is about the byte time at 67 TFLOP/s float32.
//
// Design: the phase-0 body of indexed_phase0.cuh, shared with the round
// kernel: one cluster of C <= 8 CTAs per node, each CTA a cp.async stream of
// its tiles of the node's rows (3 stages, 16-, 8- or 4-byte copies), the
// median one coordinate per thread, the per-slot sums one slot per warp from
// float4 reads (the plain version's float32 terms, summed in double), the
// Gram in 4 x 4 register blocks; each CTA's totals in a
// fixed order, then rank 0 adds the ranks' totals in rank order through
// distributed shared memory and writes the node's outputs.  One launch: the
// cluster replaces the earlier per-CTA partials buffer and the second,
// finishing launch.  Identical rows get bit-identical sums and Gram rows.
// Above K = 32 the body is indexed_wide.cuh's (the same cluster, columns
// sorted in shared memory, the Gram by output tiles), still one launch.
// What it still leaves on the table: each node reads its rows itself, and
// only L2 serves a row to the other nodes that read it; the median network
// sorts every padded wire; every term of the sums is converted to double.
//
// prev may be models itself (the chaos round's stacked matrix): both are only
// read.
//
// No fast-math: invalid slots sort as +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "indexed_phase0.cuh"
#include "indexed_wide.cuh"

namespace {

using phase0::F_COUNT;
using phase0::kThreads;

template <int KP, bool kGram>
__global__ void __launch_bounds__(kThreads, KP > 16 ? 1 : 2)
robust_stats_indexed_kernel(const phase0::Inputs in, float* __restrict__ out,
                            float* __restrict__ gram) {
  extern __shared__ __align__(16) float smem[];
  __shared__ phase0::Node<KP> sh;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const phase0::Layout L(in.K, KP, in.prev != nullptr, kGram);
  phase0::node_totals<KP, kGram>(in, sh, smem, L, cluster);

  if (cluster.block_rank() == 0) {
    __syncthreads();
    const float* tot = smem + L.tot;
    const int K = in.K, n = blockIdx.y, ns = F_COUNT * K + 1;
    // [dist2 | dotmed | norm2 | prev_dist2 | prev_dot | prev_norm2 | mednorm2]
    for (int q = threadIdx.x; q < ns; q += kThreads)
      out[(size_t)n * ns + q] = q < F_COUNT * K ? tot[(q / K) * KP + q % K] : tot[F_COUNT * KP];
    if constexpr (kGram) {
      float* g = gram + (size_t)n * K * K;
      for (int p = threadIdx.x; p < K * (K + 1) / 2; p += kThreads) {
        int i, j;
        wfagg_common::pair_of(p, K, i, j);
        const float t = tot[phase0::n_stats<KP>() + p];
        g[i * K + j] = t;
        g[j * K + i] = t;
      }
    }
  }
  cluster.sync();  // rank 0 has read every rank's totals
}

template <int KP, bool kGram>
cudaError_t launch(const phase0::Inputs& in, float* out, float* gram, int N,
                   cudaStream_t stream) {
  const phase0::Layout L(in.K, KP, in.prev != nullptr, kGram);
  return phase0::cluster_launch(robust_stats_indexed_kernel<KP, kGram>, L.bytes(), N, in.D,
                                stream, in, out, gram);
}

template <int KP>
cudaError_t launch_width(const phase0::Inputs& in, float* out, float* gram, int N,
                         cudaStream_t stream) {
  return gram != nullptr ? launch<KP, true>(in, out, gram, N, stream)
                         : launch<KP, false>(in, out, gram, N, stream);
}

// K = 33 .. 1024: the wide route of indexed_wide.cuh (its Gram written to the
// output by the cluster), then rank 0 writes the node's statistics
template <bool kGram>
__global__ void __launch_bounds__(kThreads, 1)
robust_stats_indexed_wide_kernel(const phase0::Inputs in, float* __restrict__ out,
                                 float* __restrict__ gram) {
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int K = in.K, n = blockIdx.y, ns = F_COUNT * K + 1;
  const phase0w::Layout L(K);
  const phase0w::Smem sm(smem, L, K);
  phase0w::node_totals<kGram>(in, sm, cluster, kGram ? gram + (size_t)n * K * K : nullptr);
  if (cluster.block_rank() == 0) {
    __syncthreads();
    // [dist2 | dotmed | norm2 | prev_dist2 | prev_dot | prev_norm2 | mednorm2]
    for (int q = threadIdx.x; q < ns; q += kThreads) out[(size_t)n * ns + q] = sm.tot[q];
  }
  cluster.sync();  // rank 0 has read every rank's totals
}

template <bool kGram>
cudaError_t launch_wide(const phase0::Inputs& in, float* out, float* gram, int N,
                        cudaStream_t stream) {
  return phase0::cluster_launch(robust_stats_indexed_wide_kernel<kGram>,
                                phase0w::smem_bytes(in.K), N, in.D, stream, in, out, gram);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one kernel on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch.  prev, prev_idx and gram may be null (prev_idx needs prev; null
// reads prev through idx).  out is (N, 6K + 1): [dist2 | dotmed | norm2 |
// prev_dist2 | prev_dot | prev_norm2 | mednorm2] per node (the prev fields are
// 0 without prev); gram is (N, K, K).  K <= 32 takes the register route, 33
// .. 1024 the wide route.
extern "C" int robust_stats_indexed_launch(const float* models, const int32_t* idx,
                                           const uint8_t* valid, const float* prev,
                                           const int32_t* prev_idx, float* out, float* gram,
                                           int N, int K, long long D, void* stream) {
  if (N <= 0 || N > 65535 || K <= 0 || K > phase0w::kMaxK || D <= 0 ||
      (prev_idx != nullptr && prev == nullptr))
    return (int)cudaErrorInvalidValue;
  const phase0::Inputs in{models, idx, valid, prev, prev_idx, K, D,
                          tile_stream::copy_width(D, {models, prev})};
  const cudaStream_t s = (cudaStream_t)stream;
  if (K > phase0w::kNarrowK)
    return (int)(gram != nullptr ? launch_wide<true>(in, out, gram, N, s)
                                 : launch_wide<false>(in, out, gram, N, s));
  if (K <= 8) return (int)launch_width<8>(in, out, gram, N, s);
  if (K <= 16) return (int)launch_width<16>(in, out, gram, N, s);
  return (int)launch_width<32>(in, out, gram, N, s);
}

// CTAs per node (the cluster size) that kernels 1 and 2 take over D
// coordinates.
extern "C" int indexed_cluster_size(long long D) { return phase0::cluster_size(D); }
