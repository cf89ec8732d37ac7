// Single-launch WFAgg gossip round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _wfagg_round_indexed_kernel
// (src/repro/kernels/robust_stats/kernel.py:367), launched by
// wfagg_round_indexed_pallas (kernel.py:511).  For every receiving node n
// with neighbour rows u_k = models[idx[n, k]] (k < K <= 1024) it computes, in
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
//   * Above K = 32 (the wide route, below): phase 0 is indexed_wide.cuh's
//     (columns sorted in a (K', T) buffer, the Gram by output tiles written
//     straight to the output), the scoring stage runs on rank 0's whole CTA
//     and publishes K coefficients, and phase 1 reads them from shared
//     memory.  Still one launch.
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
#include "indexed_wide.cuh"

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
  float* scratch;        // (N, K, K) Clustering's distances, the wide route only
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

// ---- the wide route (K = 33 .. 1024) ---------------------------------------
//
// Phase 0 is indexed_wide.cuh's.  The epilogue then runs on the whole CTA of
// rank 0, in shared memory over rank 0's dead per-CTA totals, and decides as
// the register route's warp does (the same float32 expressions):
//   * stable ranks of the WFAgg-D / Krum and WFAgg-C scores by counting over
//     the slots, O(K^2) a node;
//   * Krum: each valid slot's row of squared distances (from the node's Gram
//     output, the Gram's own diagonal) sorted by the sort of indexed_wide.cuh,
//     T rows at a time, and its n_closest smallest added in ascending order;
//   * Clustering: the K - 2 merges over the (K, K) cosine distances in a
//     device scratch the wrapper allocates.  Each row keeps its first
//     smallest active entry (value, column); a merge's first row-major
//     argmin is the first smallest of the rows' minima, ties to the lower
//     flat index, exactly the register route's scan.  A merge of i and j
//     rewrites row and column i and retires j; a row whose minimum sat in
//     column i or j (and row i) is scanned again, every other row compares
//     its new entry in column i with its minimum;
//   * the weights' sum: each thread's slots in order, a warp butterfly, the
//     warps in order;
//   * the combine coefficients published as an array of K + 1 (lcoef last),
//     which every rank copies through distributed shared memory.
// Phase 1 is the register route's combine with the coefficients read from
// shared memory.  Still one launch a round.

namespace wide {

using phase0::kWarps;
using phase0w::kRun;
using phase0w::valid_at;

// The first smallest (x, e) over the CTA: the smaller x, ties to the smaller
// e (a NaN never wins).  Every thread calls it and gets the result; red_x and
// red_e are kWarps entries of shared memory.
__device__ __forceinline__ void block_argmin(float& x, int& e, float* red_x, int* red_e) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ox = __shfl_xor_sync(kFull, x, o);
    const int oe = __shfl_xor_sync(kFull, e, o);
    if (ox < x || (ox == x && oe < e)) {
      x = ox;
      e = oe;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red_x / red_e are free
  if (lane == 0) {
    red_x[warp] = x;
    red_e[warp] = e;
  }
  __syncthreads();
  x = red_x[0];
  e = red_e[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    if (red_x[w] < x || (red_x[w] == x && red_e[w] < e)) {
      x = red_x[w];
      e = red_e[w];
    }
}

// the CTA's sum of x: warp butterflies, then the warps in order
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = phase0::warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// Krum scores of the K slots into sd (an invalid slot +inf): the rows of
// squared distances, T at a time, sorted in srt
__device__ __forceinline__ void krum_scores(const float* G, const unsigned* vw, int K,
                                            int n_closest, float* sd, float* srt) {
  const int KP = phase0w::width(K), T = phase0w::tile(K), tid = threadIdx.x;
  const int col = tid & (T - 1), base = (tid / T) * kRun;
  for (int b0 = 0; b0 < K; b0 += T) {
    const int k = b0 + col;
    const bool vk = k < K && valid_at(vw, k);
    const float nk = vk ? __ldcg(G + (size_t)k * K + k) : 0.f;
    float x[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      const int j = base + e;
      float t = INFINITY;
      if (vk && j < K && j != k && valid_at(vw, j)) {
        t = __fsub_rn(__fadd_rn(nk, __ldcg(G + (size_t)j * K + j)),
                      __fmul_rn(2.f, __ldcg(G + (size_t)k * K + j)));
        t = fmaxf(t, 0.f);
      }
      x[e] = t;
    }
    __syncthreads();  // the last rows' scores have read srt
    phase0w::sort_columns(x, srt, KP, T, col, base);
    __syncthreads();
    if (tid < T && b0 + tid < K) {
      float s = 0.f;
      for (int i = 0; i < n_closest; ++i) s = __fadd_rn(s, srt[i * T + tid]);
      sd[b0 + tid] = valid_at(vw, b0 + tid) ? s : INFINITY;
    }
  }
}

// Clustering over the whole CTA: the merges of the register route's
// clustering_mask.  On return (after the caller's __syncthreads) asg holds
// each slot's cluster and *best the first largest cluster, or -1 when there
// is nothing to cluster (v <= 2: every valid slot is kept).  Dm is the node's
// (K, K) device scratch; the other arrays are K entries of shared memory.
__device__ void clustering(const float* G, const float* n2, const unsigned* vw, int v, int K,
                           float* Dm, float* size, int* asg, float* rmv, int* rmc, int* act,
                           float* nr, float* red_x, int* red_e, int* best) {
  const int tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    const bool vk = valid_at(vw, k);
    nr[k] = sqrtf(fmaxf(n2[k], 1e-12f));  // the norms, until the distances are set
    size[k] = vk ? 1.f : 0.f;
    asg[k] = k;
    act[k] = vk;
  }
  __syncthreads();
  if (v <= 2) {
    if (tid == 0) *best = -1;
    return;
  }
  for (int e = tid; e < K * K; e += kThreads) {
    const int i = e / K, j = e - i * K;
    Dm[e] = act[i] && act[j]
                ? __fsub_rn(1.f, __fdiv_rn(__ldcg(G + e), fmaxf(__fmul_rn(nr[i], nr[j]), 1e-12f)))
                : INFINITY;
  }
  __syncthreads();
  // row l's first smallest entry over active pairs l != j (+inf elsewhere)
  auto rescan = [&](int l) {
    const bool al = act[l] != 0;
    const float* row = Dm + (size_t)l * K;
    float b = INFINITY;
    int c = K;
    for (int j = 0; j < K; ++j) {
      const float x = al && j != l && act[j] ? row[j] : INFINITY;
      if (x < b || (x == b && j < c)) {
        b = x;
        c = j;
      }
    }
    rmv[l] = b;
    rmc[l] = c;
  };
  for (int l = tid; l < K; l += kThreads) rescan(l);
  __syncthreads();
  for (int s = 0; s < v - 2; ++s) {
    // the first (row-major) smallest entry over active pairs i != j
    float bx = INFINITY;
    int be = K * K;
    for (int l = tid; l < K; l += kThreads) {
      const float x = rmv[l];
      const int e = l * K + rmc[l];
      if (x < bx || (x == bx && e < be)) {
        bx = x;
        be = e;
      }
    }
    block_argmin(bx, be, red_x, red_e);
    const int i0 = be / K, j0 = be - i0 * K;
    const int i = min(i0, j0), j = max(i0, j0);
    const float ni = size[i], nj = size[j];
    for (int l = tid; l < K; l += kThreads)
      nr[l] = __fdiv_rn(__fadd_rn(__fmul_rn(ni, Dm[(size_t)i * K + l]),
                                  __fmul_rn(nj, Dm[(size_t)j * K + l])),
                        fmaxf(__fadd_rn(ni, nj), 1.f));
    __syncthreads();
    for (int l = tid; l < K; l += kThreads) {
      Dm[(size_t)i * K + l] = nr[l];
      Dm[(size_t)l * K + i] = nr[l];
      if (asg[l] == j) asg[l] = i;
      size[l] = l == j ? 0.f : (l == i ? __fadd_rn(ni, nj) : size[l]);
      if (l == j) act[l] = 0;
    }
    __syncthreads();
    for (int l = tid; l < K; l += kThreads) {
      if (!act[l]) {
        rmv[l] = INFINITY;
        rmc[l] = 0;
      } else if (l == i || rmc[l] == i || rmc[l] == j) {
        rescan(l);
      } else {
        const float x = act[i] ? Dm[(size_t)l * K + i] : INFINITY;
        if (x < rmv[l] || (x == rmv[l] && i < rmc[l])) {
          rmv[l] = x;
          rmc[l] = i;
        }
      }
    }
    __syncthreads();
  }
  // the first largest cluster
  float bx = INFINITY;
  int be = K;
  for (int l = tid; l < K; l += kThreads) {
    const float x = -size[l];
    if (x < bx || (x == bx && l < be)) {
      bx = x;
      be = l;
    }
  }
  block_argmin(bx, be, red_x, red_e);
  if (tid == 0) *best = be;
}

// The scoring stage of node n on rank 0's whole CTA, from the totals in
// sm.tot; writes the round's per-slot outputs and publishes the combine
// coefficients in E[0 .. K) and lcoef in E[K].  E is rank 0's dead per-CTA
// totals (9 K + 4 floats used).
template <bool kGram>
__device__ void epilogue(const Args& a, const phase0w::Smem& sm, float* E, int n) {
  __shared__ float red_x[kWarps];
  __shared__ int red_e[kWarps];
  __shared__ int best;
  const int K = a.in.K, tid = threadIdx.x;
  const bool has_prev = a.in.prev != nullptr;
  const float* tot = sm.tot;
  const unsigned* vw = sm.vw;
  const int v = phase0w::valid_count(vw, K);
  const float m2 = tot[F_COUNT * K];
  const size_t nk = (size_t)n * K;
  float* wcomb = E;
  float* sd = E + phase0w::round4(K + 1);
  float* sc = sd + K;
  float* wv = sc + K;
  float* size = wv + K;
  float* nr = size + K;
  float* rmv = nr + K;
  int* asg = reinterpret_cast<int*>(rmv + K);
  int* rmc = asg + K;
  int* act = rmc + K;
  const int keep_wf = v - a.f - 1;  // WFAgg-D and WFAgg-C keep counts
  bool krum = false, cluster = false;
  if constexpr (kGram) {
    krum = a.dist_krum != 0;
    cluster = a.sim_cluster != 0;
  }
  const float* G = kGram ? a.gram + nk * K : nullptr;
  if (krum) krum_scores(G, vw, K, max(v - a.f - 2, 1), sd, sm.srt);
  for (int k = tid; k < K; k += kThreads) {
    const bool vk = valid_at(vw, k);
    if (!krum) sd[k] = vk ? tot[F_D2 * K + k] : INFINITY;
    const float dm = tot[F_DM * K + k], n2 = tot[F_N2 * K + k];
    sc[k] = vk ? 1.f - dm / sqrtf(fmaxf(n2 * m2, 1e-24f)) : INFINITY;
  }
  if (cluster)
    clustering(G, tot + F_N2 * K, vw, v, K, a.scratch + nk * K, size, asg, rmv, rmc, act, nr,
               red_x, red_e, &best);
  __syncthreads();
  const int keep_d = krum ? min(v, a.krum_m) : keep_wf;
  float wpart = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    const bool vk = valid_at(vw, k);
    const float sdk = sd[k], sck = sc[k];
    // stable rank: #{j : s_j < s_k or (s_j == s_k and j < k)}
    int rd = 0, rc = 0;
    for (int j = 0; j < K; ++j) {
      const float sdj = sd[j], scj = sc[j];
      rd += (sdj < sdk) || (sdj == sdk && j < k);
      rc += (scj < sck) || (scj == sck && j < k);
    }
    const bool md = rd < min(max(keep_d, 0), K);
    const bool mc = cluster ? vk && (best < 0 || asg[k] == best) : rc < min(max(keep_wf, 0), K);
    const float d2 = tot[F_D2 * K + k], dm = tot[F_DM * K + k], n2 = tot[F_N2 * K + k];
    const float pd2 = tot[F_PD2 * K + k], pdt = tot[F_PDT * K + k], pn2 = tot[F_PN2 * K + k];
    bool mt = false;
    if (a.tbands != nullptr) {
      const float* tb = a.tbands + nk * 4;
      const float bt = 1.f - pdt / sqrtf(fmaxf(n2 * pn2, 1e-24f));
      mt = vk && pd2 >= tb[k] && pd2 <= tb[K + k] && bt >= tb[2 * K + k] &&
           bt <= tb[3 * K + k];
    }
    float w = a.tau1 * (float)md + a.tau2 * (float)mc + a.tau3 * (float)mt;
    w = w < a.accept_floor ? 0.f : w;
    w = vk ? w : 0.f;
    wv[k] = w;
    wpart += w;
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
  const float wsum = block_sum(wpart, red_x);
  const float vsum = (float)v;
  const float ea = a.mean_fallback ? (vsum > 0.f ? a.alpha : 0.f) : (wsum > 0.f ? a.alpha : 0.f);
  for (int k = tid; k < K; k += kThreads) {
    float wn = wv[k] / fmaxf(wsum, 1e-12f);
    if (a.mean_fallback) wn = wsum > 0.f ? wn : (valid_at(vw, k) ? 1.f : 0.f) / fmaxf(vsum, 1.f);
    wcomb[k] = ea * wn;
  }
  if (tid == 0) {
    wcomb[K] = 1.f - ea;
    a.mednorm2[n] = m2;
  }
}

// phase 1 on this rank's tiles: out = lc * local + sum_k wc_k u_k, in slot
// order, VEC coordinates a thread (the register route's combine, with the
// coefficients in shared memory)
template <int VEC>
__device__ __forceinline__ void combine(const Args& a, const float* const* rows, const float* wc,
                                        float lc, int rank, int C) {
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
    for (int k = 0; k < K; ++k) {
      const float w = wc[k];
      if (w != 0.f) {
        float x[VEC];
        tile_stream::load_vec<VEC>(x, rows[k] + j);
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[e] += w * x[e];
      }
    }
    tile_stream::store_vec<VEC>(o + j, r);
  }
}

template <bool kGram>
__global__ void __launch_bounds__(kThreads, 1) round_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int K = a.in.K, n = blockIdx.y;
  const phase0w::Layout L(K);
  const phase0w::Smem sm(smem, L, K);

  // ---- phase 0: median + sufficient statistics [+ Gram] -----------------
  phase0w::node_totals<kGram>(a.in, sm, cl, kGram ? a.gram + (size_t)n * K * K : nullptr);
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  float* E = smem + L.dpart;  // rank 0: the epilogue's scratch and coefficients
  if (rank == 0) {
    __syncthreads();
    epilogue<kGram>(a, sm, E, n);
    __syncthreads();
  }
  // rank 0 has read every rank's totals and published the coefficients
  cl.sync();

  // ---- phase 1: WFAgg-E combine of this rank's tiles, in slot order ------
  float* wc = sm.srt;
  const float* wc0 = cl.map_shared_rank(E, 0);
  for (int q = threadIdx.x; q <= K; q += kThreads) wc[q] = wc0[q];
  __syncthreads();
  // rank 0's shared memory is read: it may exit once every rank is here
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  if (a.in.vec == 4)
    combine<4>(a, sm.rows, wc, wc[K], rank, C);
  else if (a.in.vec == 2)
    combine<2>(a, sm.rows, wc, wc[K], rank, C);
  else
    combine<1>(a, sm.rows, wc, wc[K], rank, C);
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <bool kGram>
cudaError_t launch(const Args& a, int N, cudaStream_t stream) {
  return phase0::cluster_launch(round_kernel<kGram>, phase0w::smem_bytes(a.in.K), N, a.in.D,
                                stream, a);
}

}  // namespace wide

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one kernel on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch.  gram is (N, K, K) when a Gram filter is on (dist_krum or
// sim_cluster), else null; scratch is (N, K, K) for Clustering above K = 32,
// else null; prev_idx (N, K) needs prev, and null reads prev through idx.
// K <= 32 takes the register route, 33 .. 1024 the wide route.
extern "C" int wfagg_round_indexed_launch(
    const float* local, const float* models, const int32_t* idx,
    const uint8_t* valid, const float* prev, const int32_t* prev_idx,
    const float* tbands, float* out,
    float* weights, uint8_t* mask_d, uint8_t* mask_c, uint8_t* mask_t,
    float* dist2, float* dotmed, float* norm2, float* mednorm2,
    float* prev_dist2, float* prev_dot, float* prev_norm2, float* gram, float* scratch,
    int N, int K, long long D, int f, float tau1, float tau2, float tau3,
    float accept_floor, float alpha, int mean_fallback, int dist_krum,
    int sim_cluster, int krum_m, void* stream) {
  const bool wide = K > phase0w::kNarrowK;
  if (N <= 0 || N > 65535 || K <= 0 || K > phase0w::kMaxK || D <= 0 ||
      (gram != nullptr) != (dist_krum != 0 || sim_cluster != 0) ||
      (prev_idx != nullptr && prev == nullptr) ||
      (wide && sim_cluster != 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const phase0::Inputs in{models, idx, valid, prev, prev_idx, K, D,
                          tile_stream::copy_width(D, {models, prev, local, out})};
  const Args a{in, local, tbands, out, weights, mask_d, mask_c, mask_t, dist2, dotmed,
               norm2, mednorm2, prev_dist2, prev_dot, prev_norm2, gram, f, tau1, tau2,
               tau3, accept_floor, alpha, mean_fallback, dist_krum, sim_cluster, krum_m,
               scratch};
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return (int)(gram != nullptr ? wide::launch<true>(a, N, s) : wide::launch<false>(a, N, s));
  if (K <= 8) return (int)launch_width<8>(a, N, s);
  if (K <= 16) return (int)launch_width<16>(a, N, s);
  return (int)launch_width<32>(a, N, s);
}
