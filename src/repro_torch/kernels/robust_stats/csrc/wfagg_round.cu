// Single-launch WFAgg gossip round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _wfagg_round_indexed_kernel
// (src/repro/kernels/robust_stats/kernel.py:367), launched by
// wfagg_round_indexed_pallas (kernel.py:511).  For every receiving node n
// with neighbour rows u_k = models[idx[n, k]] (k < K <= 32) it computes, in
// one launch:
//   phase 0   the valid-masked coordinate-wise median of the u_k and the
//             sufficient statistics dist2, dotmed, norm2, mednorm2 and, with
//             prev, prev_dist2 / prev_dot / prev_norm2 (WFAgg-T); in the Gram
//             variant (need_gram, Alt-WFAgg) also the (K, K) candidate Gram;
//   epilogue  the WFAgg scoring stage (core/trust.py: derive_trust_weights
//             + combine_coefficients): the three filter masks (WFAgg-D or
//             Multi-Krum, WFAgg-C or Clustering, WFAgg-T), the tau-weighted
//             trust weights and the WFAgg-E coefficients;
//   phase 1   out[n] = lcoef * local[n] + sum_k wcomb_k * u_k.
//
// Bound on this card: bytes.  The function must read models, prev and local
// once and write out once (4 * M * D * 4 bytes for M = N); at 3.35 TB/s that
// is the floor.  Its arithmetic (about 16 flops per candidate coordinate plus
// a sorting network) sits below the float32 peak at these byte counts; the
// Gram adds K(K+1) flops per node coordinate, which at K = 16 is as much again.
//
// Design, simple first:
//   * One CTA of 256 threads per receiving node.  Threads stride over the
//     coordinates j, so neighbouring threads read neighbouring addresses of
//     each neighbour row (coalesced); rows are found through the index table,
//     so the (N, K, D) gossip tensor never exists.
//   * Per coordinate a thread holds the K values in registers and takes their
//     valid-masked median (valid_median.cuh: a bitonic network over K padded
//     to KP in {8, 16, 32}, invalid slots +inf, the dynamic middles of the
//     valid count v; the empty median is 0).
//   * Per-thread partial sums live in registers up to KP = 16 and in shared
//     memory at KP = 32.  The block reduction has a fixed order (warp
//     butterflies, then warps in index order) that is the same for every
//     slot: two bit-identical neighbour rows get bit-identical statistics,
//     so the stable-index tie-break of the masks picks the same slot as
//     torch.argsort(stable=True).  No atomics: results repeat run to run.
//   * Gram variant: the sort destroys slot order, so the Gram is taken from
//     the unsorted values, staged per 256-coordinate tile in shared memory;
//     each thread owns fixed (pair, coordinate range) items and sums them in
//     a fixed order (valid_median.cuh), with no K^2 partials per thread.  The
//     pairs i <= j are mirrored, so the Gram is exactly symmetric, and it is
//     written out as an (N, K, K) output.
//   * Warp 0 runs the scoring stage, one lane per slot, and leaves the
//     combine coefficients in shared memory; phase 1 re-reads the rows
//     (from L2 at the paper's size) and skips the slots whose coefficient
//     is 0, which adds exactly +-0 in the reference.
// What it leaves on the table: one CTA per node under-fills the 132 SMs at
// N = 20, and phase 1 reads the rows a second time.  Splitting D across CTAs
// needs a grid-wide barrier before phase 1; that is later work.  The
// Clustering epilogue is K - 2 merge steps of a K^2 argmin in one warp.
//
// No fast-math: the bands carry +-inf, invalid rows sort as +inf, and the
// cosines need IEEE sqrtf and division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "valid_median.cuh"

namespace {

using wfagg_common::bitonic_sort;
using wfagg_common::GramItems;
using wfagg_common::GramSplit;
using wfagg_common::kStride;
using wfagg_common::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* local;    // (N, D)
  const float* models;   // (M, D)
  const int32_t* idx;    // (N, K) rows into models (and prev)
  const uint8_t* valid;  // (N, K) bool
  const float* prev;     // (M, D) or null
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
  int K;
  long long D;
  int f;
  float tau1, tau2, tau3;
  float accept_floor;    // accept_threshold - 1e-9, rounded to float32
  float alpha;
  int mean_fallback;
  int dist_krum;         // distance filter: 1 Multi-Krum (Gram), 0 WFAgg-D
  int sim_cluster;       // similarity filter: 1 Clustering (Gram), 0 WFAgg-C
  int krum_m;            // Multi-Krum keep count m
};

// per-thread partial sums: six fields of KP slots, then mednorm2
enum { F_D2 = 0, F_DM, F_N2, F_PD2, F_PDT, F_PN2, F_COUNT };

template <int KP>
__host__ __device__ constexpr int n_partials() { return F_COUNT * KP + 1; }

// xor butterfly: every lane ends with the same, bit-identical sum
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int KP, bool kShared>
struct Partials;

template <int KP>
struct Partials<KP, false> {  // registers
  float v[n_partials<KP>()];
  __device__ __forceinline__ void init(float*, int) {
#pragma unroll
    for (int q = 0; q < n_partials<KP>(); ++q) v[q] = 0.f;
  }
  __device__ __forceinline__ float& operator[](int q) { return v[q]; }
};

template <int KP>
struct Partials<KP, true> {  // shared memory, one column per thread
  float* p;
  __device__ __forceinline__ void init(float* smem, int tid) {
    p = smem + tid;
#pragma unroll 4
    for (int q = 0; q < n_partials<KP>(); ++q) p[q * kThreads] = 0.f;
  }
  __device__ __forceinline__ float& operator[](int q) { return p[q * kThreads]; }
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
//       d2 = max((n_i + n_j) - 2 * g_ij, 0)   (the reference's (1 - eye)
//       factor is 1 off the diagonal); the diagonal and invalid pairs are +inf;
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

// Krum score of slot k (valid): G is the (K, K) Gram, n2 the squared norms
template <int KP>
__device__ __forceinline__ float krum_score(const float* G, const float* n2,
                                            unsigned vbits, int K, int k,
                                            int n_closest) {
  const float nk = n2[k];
  float r[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    float x = INFINITY;
    if (j < K && j != k && ((vbits >> j) & 1u)) {
      const float t = __fsub_rn(__fadd_rn(nk, n2[j]), __fmul_rn(2.f, G[k * K + j]));
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

template <int KP, bool kShared, bool kGram>
__global__ void __launch_bounds__(kThreads)
wfagg_round_kernel(const Args a) {
  constexpr int NP = n_partials<KP>();
  // kShared: NP * kThreads floats of partials; kGram: then a K * kStride tile
  // (and, without kShared, 2 K^2 floats of epilogue scratch)
  extern __shared__ float dyn[];
  __shared__ float red[kShared ? 1 : NP * kWarps];
  __shared__ float tot[NP];
  __shared__ const float* rows[KP];
  __shared__ const float* prows[KP];
  __shared__ float wcomb[KP];
  __shared__ float lcoef;
  __shared__ unsigned vbits_s;

  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K;
  const long long D = a.D;
  const bool has_prev = a.prev != nullptr;
  const size_t nk = (size_t)n * K;

  if (tid < K) {
    const long long r = a.idx[nk + tid];
    rows[tid] = a.models + r * D;
    prows[tid] = has_prev ? a.prev + r * D : nullptr;
  }
  if (warp == 0) {
    const bool vk = lane < K && a.valid[nk + lane] != 0;
    const unsigned b = __ballot_sync(kFull, vk);
    if (lane == 0) vbits_s = b;
  }
  __syncthreads();
  const unsigned vbits = vbits_s;
  const int v = __popc(vbits);

  float* tile = dyn + (kShared ? NP * kThreads : 0);
  const GramSplit gs(K);
  GramItems<KP> gi;
  if constexpr (kGram) gi.init(gs, K, tid);

  // ---- phase 0: median + sufficient statistics [+ Gram] -----------------
  Partials<KP, kShared> acc;
  acc.init(dyn, tid);
  for (long long base = 0; base < D; base += kThreads) {
    const long long j = base + tid;
    const bool in = j < D;
    float u[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) u[k] = (k < K && in) ? __ldg(rows[k] + j) : 0.f;
    if (in) {
      const float med = wfagg_common::valid_median<KP>(u, vbits, v);
      acc[F_COUNT * KP] += med * med;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < K) {
          const float x = u[k], dd = x - med;
          acc[F_D2 * KP + k] += dd * dd;
          acc[F_DM * KP + k] += x * med;
          acc[F_N2 * KP + k] += x * x;
          if (has_prev) {
            const float p = __ldg(prows[k] + j), dp = x - p;
            acc[F_PD2 * KP + k] += dp * dp;
            acc[F_PDT * KP + k] += x * p;
            acc[F_PN2 * KP + k] += p * p;
          }
        }
      }
    }
    if constexpr (kGram) {
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < K) tile[k * kStride + tid] = u[k];
      __syncthreads();
      gi.add(tile);
      __syncthreads();
    }
  }
  // the tile is dead (the loop ended on a barrier): it takes the Gram parts
  if constexpr (kGram) gi.store(gs, tile, tid);

  // ---- fixed-order block reduction into tot[] ---------------------------
  if constexpr (kShared) {
    __syncthreads();
    for (int q = warp; q < NP; q += kWarps) {
      float s = 0.f;
#pragma unroll
      for (int i = lane; i < kThreads; i += 32) s += dyn[q * kThreads + i];
      s = warp_sum(s);
      if (lane == 0) tot[q] = s;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const float s = warp_sum(acc[q]);
      if (lane == 0) red[q * kWarps + warp] = s;
    }
    __syncthreads();
    for (int q = tid; q < NP; q += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[q * kWarps + w];
      tot[q] = s;
    }
  }
  __syncthreads();

  // ---- Gram: the parts of each pair in order, mirrored ------------------
  // (K, K) Gram and clustering scratch: over the dead partials with kShared,
  // after the tile otherwise
  float* G = kShared ? dyn : tile + K * kStride;
  float* Dm = G + K * K;
  if constexpr (kGram) {
    float* go = a.gram + (size_t)n * K * K;
    for (int p = tid; p < gs.P; p += kThreads) {
      int i, j;
      wfagg_common::pair_of(p, K, i, j);
      const float t = wfagg_common::gram_pair_sum(gs, tile, p);
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
        sd = vk ? krum_score<KP>(G, tot + F_N2 * KP, vbits, K, k, max(v - a.f - 2, 1))
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

  // ---- phase 1: WFAgg-E combine in slot order ---------------------------
  float wc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) wc[k] = wcomb[k];
  const float lc = lcoef;
  const float* loc = a.local + (size_t)n * D;
  float* o = a.out + (size_t)n * D;
  for (long long j = tid; j < D; j += kThreads) {
    float r = lc * __ldg(loc + j);
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < K && wc[k] != 0.f) r += wc[k] * __ldg(rows[k] + j);
    o[j] = r;
  }
}

template <int KP, bool kGram>
cudaError_t launch(const Args& a, int N, cudaStream_t stream) {
  constexpr bool kShared = KP > 16;
  size_t floats = kShared ? (size_t)n_partials<KP>() * kThreads : 0;
  if (kGram) floats += (size_t)a.K * kStride + (kShared ? 0 : 2 * (size_t)a.K * a.K);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wfagg_round_kernel<KP, kShared, kGram>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  wfagg_round_kernel<KP, kShared, kGram><<<N, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_width(const Args& a, int N, cudaStream_t stream) {
  return a.gram != nullptr ? launch<KP, true>(a, N, stream) : launch<KP, false>(a, N, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// gram is (N, K, K) when a Gram filter is on (dist_krum or sim_cluster), else
// null.
extern "C" int wfagg_round_indexed_launch(
    const float* local, const float* models, const int32_t* idx,
    const uint8_t* valid, const float* prev, const float* tbands, float* out,
    float* weights, uint8_t* mask_d, uint8_t* mask_c, uint8_t* mask_t,
    float* dist2, float* dotmed, float* norm2, float* mednorm2,
    float* prev_dist2, float* prev_dot, float* prev_norm2, float* gram, int N,
    int K, long long D, int f, float tau1, float tau2, float tau3,
    float accept_floor, float alpha, int mean_fallback, int dist_krum,
    int sim_cluster, int krum_m, void* stream) {
  if (N <= 0 || K <= 0 || K > 32 || D <= 0 ||
      (gram != nullptr) != (dist_krum != 0 || sim_cluster != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{local, models, idx, valid, prev, tbands, out, weights,
               mask_d, mask_c, mask_t, dist2, dotmed, norm2, mednorm2,
               prev_dist2, prev_dot, prev_norm2, gram, K, D, f, tau1, tau2,
               tau3, accept_floor, alpha, mean_fallback, dist_krum, sim_cluster,
               krum_m};
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 8) return (int)launch_width<8>(a, N, s);
  if (K <= 16) return (int)launch_width<16>(a, N, s);
  return (int)launch_width<32>(a, N, s);
}
