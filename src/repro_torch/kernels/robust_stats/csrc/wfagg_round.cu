// Single-launch WFAgg gossip round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _wfagg_round_indexed_kernel
// (src/repro/kernels/robust_stats/kernel.py:367), launched by
// wfagg_round_indexed_pallas (kernel.py:511).  For every receiving node n
// with neighbour rows u_k = models[idx[n, k]] (k < K <= 32) it computes, in
// one launch:
//   phase 0   the valid-masked coordinate-wise median of the u_k and the
//             sufficient statistics dist2, dotmed, norm2, mednorm2 and, with
//             prev, prev_dist2 / prev_dot / prev_norm2 (WFAgg-T) against the
//             rows p_k = prev[idx[n, k]], or p_k = prev[prev_idx[n, k]] in the
//             prev_idx variant (chaos transport: the payload edge (n, k)
//             actually served last round, its own (N, K) table into the same
//             stacked matrix; a per-edge (N, K, D) prev is this variant over
//             its N K rows); in the Gram variant (need_gram, Alt-WFAgg) also
//             the (K, K) candidate Gram;
//   epilogue  the WFAgg scoring stage (core/trust.py: derive_trust_weights
//             + combine_coefficients): the three filter masks (WFAgg-D or
//             Multi-Krum, WFAgg-C or Clustering, WFAgg-T), the tau-weighted
//             trust weights and the WFAgg-E coefficients;
//   phase 1   out[n] = lcoef * local[n] + sum_k wcomb_k * u_k.
//
// Bound on this card: bytes.  The function must read models, prev and local
// once and write out once (4 * M * D * 4 bytes for M = N); at 3.35 TB/s that
// is the floor, and only L2 lets nodes that share a neighbour share its
// bytes.  Phase 1 reads the accepted rows a second time.  The arithmetic
// (a sorting network and 12 flops per candidate coordinate; the Gram's
// K (K + 1) per node coordinate) sits near the byte time at 67 TFLOP/s.
//
// Design:
//   * Phase 0 is the body of indexed_phase0.cuh, shared with the statistics
//     kernel (robust_stats_indexed.cu): a cluster of C <= 8 CTAs per node
//     splits D (rank r takes the 256-coordinate tiles r, r + C, ...), each
//     CTA a 3-stage cp.async stream of the node's rows, the median one
//     coordinate per thread, the per-slot sums one slot per warp from float4
//     reads (the plain version's float32 terms, summed in double), the Gram
//     in 4 x 4 register blocks; fixed-order sums, and rank 0
//     adds the ranks' totals in rank order through distributed shared memory.
//     Identical rows get bit-identical statistics and Gram rows.
//   * Rank 0's warp 0 runs the scoring stage, one lane per slot, and
//     publishes the combine coefficients in its shared memory.  After a
//     cluster barrier every rank reads them through distributed shared
//     memory and combines its own tiles (phase 1), skipping the slots whose
//     coefficient is 0, which adds exactly +-0 in the reference.  The
//     cluster barrier is the grid-wide barrier the round needs, scoped to
//     one node: the round stays one launch, with no cooperative launch.
// What it leaves on the table: phase 1 reads the accepted rows again (from
// HBM at N = 64, d = 2^20: the node's rows exceed L2); every term of the
// statistics is converted to double; the CTAs of a
// cluster idle while rank 0's warp 0 scores; the Clustering epilogue is
// K - 2 merge steps of a K^2 argmin in one warp.
//
// No fast-math: the bands carry +-inf, invalid rows sort as +inf, and the
// cosines need IEEE sqrtf and division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "indexed_phase0.cuh"

namespace {

using phase0::F_COUNT;
using phase0::F_D2;
using phase0::F_DM;
using phase0::F_N2;
using phase0::F_PD2;
using phase0::F_PDT;
using phase0::F_PN2;
using phase0::kFull;
using phase0::kThreads;
using phase0::kTile;
using phase0::warp_sum;
using wfagg_common::bitonic_sort;

struct Args {
  phase0::Inputs in;     // models, idx, valid, prev, prev_idx, K, D, copy width
  const float* local;    // (N, D)
  const float* tbands;   // (N, 4K) [lo_d | hi_d | lo_c | hi_c] or null
  float* out;            // (N, D)
  float* weights;        // (N, K)
  uint8_t* mask_d;       // (N, K) bool
  uint8_t* mask_c;
  uint8_t* mask_t;
  float* dist2;          // (N, K)
  float* dotmed;
  float* norm2;
  float* mednorm2;       // (N,)
  float* prev_dist2;     // (N, K) or null
  float* prev_dot;
  float* prev_norm2;
  float* gram;           // (N, K, K), the Gram variant only
  int f;
  float tau1, tau2, tau3;
  float accept_floor;    // accept_threshold - 1e-9, rounded to float32
  float alpha;
  int mean_fallback;
  int dist_krum;         // distance filter: 1 Multi-Krum (Gram), 0 WFAgg-D
  int sim_cluster;       // similarity filter: 1 Clustering (Gram), 0 WFAgg-C
  int krum_m;            // Multi-Krum keep count m
};

// ---- the Alt-WFAgg epilogue (Gram variant) ------------------------------
//
// It mirrors core/trust.py (fused_distance_mask_valid /
// fused_similarity_mask_valid, sq_dists_from_gram, cosine_dist_from_gram) and
// core/aggregators.py (krum_scores_from_sq_dists_dyn,
// clustering_select_from_dist_dyn, smallest_k_mask_dyn) operation for
// operation, in float32 with no contraction into fma (the __f*_rn
// intrinsics), so that it decides as the plain version does:
//   * squared distance of slots i != j, both valid:
//       d2 = max((g_ii + g_jj) - 2 * g_ij, 0)   (the Gram's own diagonal, so
//       two bit-identical candidates, whose Gram entries are bit-equal, are
//       at distance exactly 0; the (1 - eye) factor is 1 off the diagonal);
//       the diagonal and invalid pairs are +inf;
//   * cosine distance: 1 - g_ij / max(sqrt(max(n_i, eps)) * sqrt(max(n_j, eps)),
//       eps), eps = 1e-12; invalid pairs +inf;
//   * Krum score of a valid slot: its row sorted ascending, the first
//       max(v - f - 2, 1) values added in that order from 0; an invalid slot
//       scores +inf; Multi-Krum keeps the min(m, v) smallest scores, ties to
//       the lower slot;
//   * Clustering, for v > 2 (else every valid slot): v - 2 merge steps, each
//       the row-major first argmin over active pairs i != j of the (K, K)
//       matrix (non-active entries count as +inf, as jnp.argmin /
//       torch.argmin of the flattened matrix see them), i < j the pair, the
//       Lance-Williams row (n_i * D[i] + n_j * D[j]) / max(n_i + n_j, 1)
//       written to row i and then column i, j retired (size 0), i's size
//       n_i + n_j, j's members moved to i; the mask keeps the valid members of
//       the first largest cluster (argmax of the sizes).
// The Gram rows of two bit-identical candidates are bit-identical, and so is
// every value built from them here, so exact ties resolve as in the plain
// version.

// Krum score of slot k (valid): G is the (K, K) Gram
template <int KP>
__device__ __forceinline__ float krum_score(const float* G, unsigned vbits, int K,
                                            int k, int n_closest) {
  const float nk = G[k * K + k];
  float r[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    float x = INFINITY;
    if (j < K && j != k && ((vbits >> j) & 1u)) {
      const float t = __fsub_rn(__fadd_rn(nk, G[j * K + j]), __fmul_rn(2.f, G[k * K + j]));
      x = fmaxf(t, 0.f);
    }
    r[j] = x;
  }
  bitonic_sort<KP>(r);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < KP; ++i)
    if (i < n_closest) s = __fadd_rn(s, r[i]);
  return s;
}

// Clustering mask of this lane's slot; the whole of warp 0 calls it.  Dm is
// (K, K) scratch in shared memory.
__device__ __forceinline__ bool clustering_mask(const float* G, float* Dm,
                                                const float* n2, unsigned vbits,
                                                int v, int K, int lane) {
  const bool vl = (vbits >> lane) & 1u;
  if (v <= 2) return vl;  // nothing to cluster (also covers K <= 2)
  const float nn = sqrtf(fmaxf(lane < K ? n2[lane] : 0.f, 1e-12f));
  for (int i = 0; i < K; ++i) {
    const float nni = __shfl_sync(kFull, nn, i);
    if (lane < K) {
      const bool ok = ((vbits >> i) & 1u) && vl;
      Dm[i * K + lane] =
          ok ? __fsub_rn(1.f, __fdiv_rn(G[i * K + lane], fmaxf(__fmul_rn(nni, nn), 1e-12f)))
             : INFINITY;
    }
  }
  __syncwarp();
  unsigned act = vbits;
  float size = vl ? 1.f : 0.f;
  int asg = lane;
  for (int s = 0; s < v - 2; ++s) {
    // the first (row-major) smallest entry over active pairs i != j
    float best = INFINITY;
    int be = K * K;
    for (int e = lane; e < K * K; e += 32) {
      const int i = e / K, j = e - i * K;
      const bool ok = i != j && ((act >> i) & 1u) && ((act >> j) & 1u);
      const float x = ok ? Dm[e] : INFINITY;
      if (x < best || (x == best && e < be)) {
        best = x;
        be = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oe = __shfl_xor_sync(kFull, be, o);
      if (ob < best || (ob == best && oe < be)) {
        best = ob;
        be = oe;
      }
    }
    const int i0 = be / K, j0 = be - i0 * K;
    const int i = min(i0, j0), j = max(i0, j0);
    const float ni = __shfl_sync(kFull, size, i), nj = __shfl_sync(kFull, size, j);
    float nr = 0.f;
    if (lane < K)
      nr = __fdiv_rn(__fadd_rn(__fmul_rn(ni, Dm[i * K + lane]), __fmul_rn(nj, Dm[j * K + lane])),
                     fmaxf(__fadd_rn(ni, nj), 1.f));
    __syncwarp();
    if (lane < K) {
      Dm[i * K + lane] = nr;
      Dm[lane * K + i] = nr;
    }
    __syncwarp();
    act &= ~(1u << j);
    size = lane == j ? 0.f : (lane == i ? __fadd_rn(ni, nj) : size);
    if (asg == j) asg = i;
  }
  // the first largest cluster
  float bs = lane < K ? size : -1.f;
  int bi = lane < K ? lane : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(kFull, bs, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (os > bs || (os == bs && oi < bi)) {
      bs = os;
      bi = oi;
    }
  }
  return vl && asg == bi;
}

// phase 1 on this rank's tiles: out = lc * local + sum_k wc_k u_k, in slot
// order, VEC coordinates a thread
template <int KP, int VEC>
__device__ __forceinline__ void combine(const Args& a, const float* const* rows,
                                        const float (&wc)[KP], float lc, int rank, int C) {
  constexpr int VT = kTile / VEC;  // vectors per tile
  const long long D = a.in.D;
  const int K = a.in.K;
  const float* loc = a.local + (size_t)blockIdx.y * D;
  float* o = a.out + (size_t)blockIdx.y * D;
  const long long total = phase0::rank_tiles(D, rank, C) * VT;
  for (long long q = threadIdx.x; q < total; q += kThreads) {
    const long long j = (rank + (q / VT) * C) * kTile + (q % VT) * VEC;
    if (j >= D) continue;  // D % VEC == 0: a vector is all in or all out
    float r[VEC];
    tile_stream::load_vec<VEC>(r, loc + j);
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = lc * r[e];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K && wc[k] != 0.f) {
        float x[VEC];
        tile_stream::load_vec<VEC>(x, rows[k] + j);
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[e] += wc[k] * x[e];
      }
    }
    tile_stream::store_vec<VEC>(o + j, r);
  }
}

template <int KP, bool kGram>
__global__ void __launch_bounds__(kThreads, KP > 16 ? 1 : 2)
wfagg_round_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ phase0::Node<KP> sh;
  __shared__ float wcomb[KP];   // rank 0: the combine coefficients
  __shared__ float lcoef;
  __shared__ float wc_s[KP + 1];  // every rank: its copy of them
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int K = a.in.K;
  const bool has_prev = a.in.prev != nullptr;
  const phase0::Layout L(K, KP, has_prev, kGram);

  // ---- phase 0: median + sufficient statistics [+ Gram] -----------------
  phase0::node_totals<KP, kGram>(a.in, sh, smem, L, cl);
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (rank == 0) {
    __syncthreads();
    const float* tot = smem + L.tot;
    const unsigned vbits = sh.vbits;
    const int v = __popc(vbits);
    const size_t nk = (size_t)n * K;
    // (K, K) Gram and clustering scratch over the dead ring
    float* G = smem;
    float* Dm = G + K * K;
    if constexpr (kGram) {
      float* go = a.gram + (size_t)n * K * K;
      for (int p = tid; p < K * (K + 1) / 2; p += kThreads) {
        int i, j;
        wfagg_common::pair_of(p, K, i, j);
        const float t = tot[phase0::n_stats<KP>() + p];
        G[i * K + j] = t;
        G[j * K + i] = t;
        go[i * K + j] = t;
        go[j * K + i] = t;
      }
      __syncthreads();
    }

    // ---- epilogue: WFAgg scoring stage, one lane per slot ------------------
    if (warp == 0) {
      const int k = lane;
      const bool real = k < K;
      const bool vk = (vbits >> k) & 1u;  // false on lanes >= K
      float d2 = 0.f, dm = 0.f, n2 = 0.f, pd2 = 0.f, pdt = 0.f, pn2 = 0.f;
      if (real) {
        d2 = tot[F_D2 * KP + k];
        dm = tot[F_DM * KP + k];
        n2 = tot[F_N2 * KP + k];
        pd2 = tot[F_PD2 * KP + k];
        pdt = tot[F_PDT * KP + k];
        pn2 = tot[F_PN2 * KP + k];
      }
      const float m2 = tot[F_COUNT * KP];
      const int keep_wf = v - a.f - 1;  // WFAgg-D and WFAgg-C keep counts
      float sd = vk ? d2 : INFINITY;
      int keep_d = keep_wf;
      bool cluster = false;
      if constexpr (kGram) {
        if (a.dist_krum) {
          sd = vk ? krum_score<KP>(G, vbits, K, k, max(v - a.f - 2, 1))
                  : INFINITY;
          keep_d = min(v, a.krum_m);
        }
        if (a.sim_cluster) cluster = clustering_mask(G, Dm, tot + F_N2 * KP, vbits, v, K, lane);
      }
      const float sc = vk ? 1.f - dm / sqrtf(fmaxf(n2 * m2, 1e-24f)) : INFINITY;
      // stable rank: #{j : s_j < s_k or (s_j == s_k and j < k)}
      int rd = 0, rc = 0;
  #pragma unroll
      for (int j = 0; j < KP; ++j) {
        const float sdj = __shfl_sync(kFull, sd, j);
        const float scj = __shfl_sync(kFull, sc, j);
        if (j < K) {
          rd += (sdj < sd) || (sdj == sd && j < k);
          rc += (scj < sc) || (scj == sc && j < k);
        }
      }
      const bool md = real && rd < min(max(keep_d, 0), K);
      const bool mc = real && (kGram && a.sim_cluster ? cluster
                                                      : rc < min(max(keep_wf, 0), K));
      bool mt = false;
      if (a.tbands != nullptr && real) {
        const float* tb = a.tbands + (size_t)n * 4 * K;
        const float bt = 1.f - pdt / sqrtf(fmaxf(n2 * pn2, 1e-24f));
        mt = vk && pd2 >= tb[k] && pd2 <= tb[K + k] && bt >= tb[2 * K + k] &&
             bt <= tb[3 * K + k];
      }
      float w = a.tau1 * (float)md + a.tau2 * (float)mc + a.tau3 * (float)mt;
      w = w < a.accept_floor ? 0.f : w;
      w = vk ? w : 0.f;
      const float wsum = warp_sum(w);
      float wn = w / fmaxf(wsum, 1e-12f);
      float ea;
      if (a.mean_fallback) {
        const float vsum = (float)v;
        wn = wsum > 0.f ? wn : (vk ? 1.f : 0.f) / fmaxf(vsum, 1.f);
        ea = vsum > 0.f ? a.alpha : 0.f;
      } else {
        ea = wsum > 0.f ? a.alpha : 0.f;
      }
      if (real) {
        const size_t e = nk + k;
        a.weights[e] = w;
        a.mask_d[e] = md;
        a.mask_c[e] = mc;
        a.mask_t[e] = mt;
        a.dist2[e] = d2;
        a.dotmed[e] = dm;
        a.norm2[e] = n2;
        if (has_prev) {
          a.prev_dist2[e] = pd2;
          a.prev_dot[e] = pdt;
          a.prev_norm2[e] = pn2;
        }
      }
      if (k < KP) wcomb[k] = real ? ea * wn : 0.f;
      if (k == 0) {
        lcoef = 1.f - ea;
        a.mednorm2[n] = m2;
      }
    }
    __syncthreads();
  }
  // rank 0 has read every rank's totals and published wcomb / lcoef
  cl.sync();

  // ---- phase 1: WFAgg-E combine of this rank's tiles, in slot order ------
  if (tid <= KP) wc_s[tid] = tid < KP ? cl.map_shared_rank(wcomb, 0)[tid]
                                      : *cl.map_shared_rank(&lcoef, 0);
  __syncthreads();
  // rank 0's shared memory is read: it may exit once every rank is here
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  float wc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) wc[k] = wc_s[k];
  const float lc = wc_s[KP];
  if (a.in.vec == 4)
    combine<KP, 4>(a, sh.rows, wc, lc, rank, C);
  else if (a.in.vec == 2)
    combine<KP, 2>(a, sh.rows, wc, lc, rank, C);
  else
    combine<KP, 1>(a, sh.rows, wc, lc, rank, C);
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int KP, bool kGram>
cudaError_t launch(const Args& a, int N, cudaStream_t stream) {
  const phase0::Layout L(a.in.K, KP, a.in.prev != nullptr, kGram);
  return phase0::cluster_launch(wfagg_round_kernel<KP, kGram>, L.bytes(), N, a.in.D, stream,
                                a);
}

template <int KP>
cudaError_t launch_width(const Args& a, int N, cudaStream_t stream) {
  return a.gram != nullptr ? launch<KP, true>(a, N, stream) : launch<KP, false>(a, N, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one kernel on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch.  gram is (N, K, K) when a Gram filter is on (dist_krum or
// sim_cluster), else null; prev_idx (N, K) needs prev, and null reads prev
// through idx.
extern "C" int wfagg_round_indexed_launch(
    const float* local, const float* models, const int32_t* idx,
    const uint8_t* valid, const float* prev, const int32_t* prev_idx,
    const float* tbands, float* out,
    float* weights, uint8_t* mask_d, uint8_t* mask_c, uint8_t* mask_t,
    float* dist2, float* dotmed, float* norm2, float* mednorm2,
    float* prev_dist2, float* prev_dot, float* prev_norm2, float* gram, int N,
    int K, long long D, int f, float tau1, float tau2, float tau3,
    float accept_floor, float alpha, int mean_fallback, int dist_krum,
    int sim_cluster, int krum_m, void* stream) {
  if (N <= 0 || N > 65535 || K <= 0 || K > 32 || D <= 0 ||
      (gram != nullptr) != (dist_krum != 0 || sim_cluster != 0) ||
      (prev_idx != nullptr && prev == nullptr))
    return (int)cudaErrorInvalidValue;
  const phase0::Inputs in{models, idx, valid, prev, prev_idx, K, D,
                          tile_stream::copy_width(D, {models, prev, local, out})};
  const Args a{in, local, tbands, out, weights, mask_d, mask_c, mask_t, dist2, dotmed,
               norm2, mednorm2, prev_dist2, prev_dot, prev_norm2, gram, f, tau1, tau2,
               tau3, accept_floor, alpha, mean_fallback, dist_krum, sim_cluster, krum_m};
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 8) return (int)launch_width<8>(a, N, s);
  if (K <= 16) return (int)launch_width<16>(a, N, s);
  return (int)launch_width<32>(a, N, s);
}
