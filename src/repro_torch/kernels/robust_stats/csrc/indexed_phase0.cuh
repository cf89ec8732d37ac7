// Phase 0 of the gossip round for Hopper (sm_90a): one body shared by
// wfagg_round.cu (kernel 1, the single-launch round) and
// robust_stats_indexed.cu (kernel 2, the statistics launch of the two-launch
// backend), so the two cannot drift apart.  It replaces the phase-0 loops of
// the Pallas kernels _wfagg_round_indexed_kernel and
// _robust_stats_indexed_kernel (src/repro/kernels/robust_stats/kernel.py:367
// and :191).
//
// For receiving node n with candidate rows u_k = models[idx[n, k]] (k < K <=
// 32, read through the index table: the (N, K, D) gossip tensor never exists)
// and, with prev, rows p_k = prev[idx[n, k]] or prev[prev_idx[n, k]], it
// computes the valid-masked coordinate-wise median med and the node's totals
//   dist2_k = sum (u_k - med)^2   dotmed_k = sum u_k med   norm2_k = sum u_k^2
//   prev_dist2_k = sum (u_k - p_k)^2   prev_dot_k = sum u_k p_k
//   prev_norm2_k = sum p_k^2          mednorm2 = sum med^2
// and, in the Gram variant, the pairs i <= j of the (K, K) Gram sum u_i u_j.
//
// What bounds it on this card: the bytes of the rows (4 K D per stream and
// node, at 3.35 TB/s, less what L2 serves to nodes that share a neighbour),
// then issue: per node coordinate a bitonic network of 6/24/80 (K <= 8/16/32
// padded) compare-exchanges; per candidate 6 float32 terms, each widened
// to double and added there (a conversion and a double add, both issued at
// a fraction of the float32 rate); with the Gram, K (K + 1) float32 flops
// more.
//
// Design:
//   * A cluster of C <= 8 CTAs per node (grid (C, N), cluster (C, 1, 1)):
//     the cluster rank walks D, blockIdx.y the nodes.  Rank r takes the
//     256-coordinate tiles r, r + C, ...  Clusters of different nodes that
//     run at the same time read the same D range, so a row shared by
//     neighbouring nodes is served from L2.  C = 8, the portable maximum,
//     at most one CTA a tile (cluster_size).
//   * A cp.async tile stream: kStages = 3 stages of the node's K rows (and
//     K prev rows) in shared memory, copies of 16, 8 or 4 bytes
//     (tile_stream.cuh; rows zero-filled past D), two tiles in flight while
//     one is reduced.  Row stride kRow = 260 floats: rows stay 16-byte
//     aligned and start on different banks.
//   * Per tile, three steps over the staged rows:
//       median  thread t takes coordinate t: its K values (one conflict-free
//               scalar load each), the network of valid_median.cuh, med to
//               shared memory;
//       sums    warp w owns candidates k = w, w + 8, ...; lane i reads float4
//               groups i and 32 + i of the row, its prev row and med, and
//               adds the four coordinates' terms in order to its running
//               sums (see "The sums" below);
//       Gram    4 x 4 register blocks (as pairwise_gram.cu): thread (bp, s)
//               owns block pair bp of the Kp/4 row blocks and slice s of S:
//               float4 groups s, s + S, ... of the tile; 8 float4 loads per
//               64 fmaf.
//   * The sums.  Each term of the seven statistics is the float32 value the
//     plain version forms (u - med, then its square; u * med; ...), so an
//     overflowing term is +-inf as there, and the terms are summed in
//     double: the result, rounded to float32 last, is the plain version's
//     up to the plain version's own float32 rounding.  dotmed and prev_dot
//     cancel (terms of both signs), and two float32 orders of their terms
//     differ by more than the statistics' tolerance of the result; the
//     squares share the scheme so that a row equal to its prev row gets
//     prev_dot == norm2 == prev_norm2 bit for bit (cosine exactly 1).  The
//     Gram stays float32 (fmaf chains).
//   * Fixed-order reduction, no atomics.  In the CTA: each warp's lanes by
//     an xor butterfly, the warps' mednorm2 in warp order, the Gram's S
//     slices in slice order (through shared memory).  In the cluster:
//     cluster.sync(), then rank 0 adds the C ranks' totals through
//     distributed shared memory (map_shared_rank) in rank order.
//   * The tie invariant: every per-slot sum and every Gram entry is one
//     expression tree (the same coordinates per lane or slice in the same
//     order, the same butterfly, slice and rank order), so two bit-identical
//     rows a, b get bit-identical statistics and Gram rows, and G[a,a] ==
//     G[a,b] == G[b,b]: the index tie-breaks of the masks and Multi-Krum's
//     exact-zero distances rely on it.
// What it still leaves on the table: every node reads its rows itself (L2,
// not shared memory, serves the rows that nodes share); the median network
// sorts every padded wire; the Gram's padded block pairs and the slices'
// uneven share of the 64 groups; one CTA per SM at K = 32 with prev; the
// conversion of every float32 term to double (on the H100 at N = 64, K =
// 16, d = 2^20 the double sums took 0.7 - 1.1 ms more than compensated
// float32 sums, which disagreed with the plain version at cancelling sums).
//
// No fast-math: invalid slots sort as +inf.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "tile_stream.cuh"
#include "valid_median.cuh"

namespace phase0 {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;          // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;             // coordinates per tile
constexpr int kRow = kTile + 4;        // shared row stride (floats)
constexpr int kStages = 3;             // tiles staged at once
constexpr int kGroups = kTile / 4;     // float4 groups of a tile row
constexpr int kPasses = kTile / 128;   // a warp's float4 passes over a tile row
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr unsigned kFull = 0xffffffffu;

// fields of the totals: F_COUNT blocks of KP slots, then mednorm2, then the
// Gram's pairs in row-major upper-triangle order
enum { F_D2 = 0, F_DM, F_N2, F_PD2, F_PDT, F_PN2, F_COUNT };

template <int KP>
__host__ __device__ constexpr int n_stats() {
  return F_COUNT * KP + 1;
}

// the node's inputs
struct Inputs {
  const float* models;      // (M, D)
  const int32_t* idx;       // (N, K) rows into models (and prev)
  const uint8_t* valid;     // (N, K) bool
  const float* prev;        // (Mp, D) or null
  const int32_t* prev_idx;  // (N, K) rows into prev, or null = idx
  int K;
  long long D;
  int vec;                  // copy width in floats (tile_stream::copy_width)
};

// the Gram's register blocks: nb row blocks of four, BP block pairs bi <= bj,
// S slices of the tile's float4 groups per block pair
struct GramBlocks {
  int nb, BP, S;
  __host__ __device__ explicit GramBlocks(int K)
      : nb((K + 3) / 4),
        BP(nb * (nb + 1) / 2),
        S(kThreads / BP < kGroups ? kThreads / BP : kGroups) {}
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// dynamic shared memory, in floats: the ring of staged tiles (later the Gram's
// slice sums, later the epilogue's (K, K) scratch), med of one tile, this
// CTA's Gram totals (read by rank 0), on rank 0 the node's totals, and this
// CTA's statistics in double (read by rank 0)
struct Layout {
  int stage, streams, area, med, part, tot, n_tot, dpart, total;
  __host__ __device__ Layout(int K, int KP, bool has_prev, bool gram) {
    const GramBlocks g(K);
    stage = round4(K) * kRow;
    streams = has_prev ? 2 : 1;
    area = round4(max3(kStages * streams * stage, gram ? g.BP * g.S * 16 : 0,
                       gram ? 2 * K * K : 0));
    n_tot = round4(F_COUNT * KP + 1 + (gram ? K * (K + 1) / 2 : 0));
    med = area;
    part = med + kTile;
    tot = part + n_tot;
    dpart = tot + n_tot;  // 16-byte aligned: every offset is a multiple of 4
    total = dpart + 2 * round4(F_COUNT * KP + 1);
  }
  __host__ __device__ size_t bytes() const { return (size_t)total * sizeof(float); }
};

// static shared state of one CTA
template <int KP>
struct Node {
  const float* rows[KP];
  const float* prows[KP];
  double red[kWarps];
  unsigned vbits;
};

// xor butterfly: every lane ends with the same, bit-identical sum
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// tiles of rank `rank` of `C`: rank, rank + C, ...
__device__ __forceinline__ long long rank_tiles(long long D, int rank, int C) {
  const long long n_tiles = (D + kTile - 1) / kTile;
  return rank < n_tiles ? (n_tiles - 1 - rank) / C + 1 : 0;
}

// copy one tile (coordinates c0 ..) of the K rows, and of the K prev rows
// `stage` floats further, into the stage at shared address dst
template <int VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* const* rows,
                                          const float* const* prows, int K, bool has_prev,
                                          long long c0, long long D, int stage) {
  constexpr int CPR = kTile / VEC;  // copies per row
  const int n = K * CPR * (has_prev ? 2 : 1);
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    const bool pv = r >= K;
    const int k = pv ? r - K : r;
    const bool in = c0 + col < D;  // D % VEC == 0: a copy is all in or all out
    const float* src = (pv ? prows[k] : rows[k]) + (in ? c0 + col : 0);
    tile_stream::cp_async<VEC>(dst + 4u * ((pv ? stage : 0) + k * kRow + col), src, in);
  }
}

// the float32 product a * b (as the plain version forms it) added to the
// double sum s
__device__ __forceinline__ void add_term(double& s, float a, float b) {
  s += (double)__fmul_rn(a, b);
}

// the four coordinates of x, m (and p) added in order to one slot's sums
__device__ __forceinline__ void add4(double (&a)[F_COUNT], const float4 x, const float4 m) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ms[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float dd = __fsub_rn(xs[e], ms[e]);
    add_term(a[F_D2], dd, dd);
    add_term(a[F_DM], xs[e], ms[e]);
    add_term(a[F_N2], xs[e], xs[e]);
  }
}

__device__ __forceinline__ void add4_prev(double (&a)[F_COUNT], const float4 x,
                                          const float4 p) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ps[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float dp = __fsub_rn(xs[e], ps[e]);
    add_term(a[F_PD2], dp, dp);
    add_term(a[F_PDT], xs[e], ps[e]);
    add_term(a[F_PN2], ps[e], ps[e]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Phase 0 of node blockIdx.y over the CTAs of its cluster.  Every thread of
// every CTA calls it.  On return, rank 0's threads have written the node's
// totals to smem + L.tot (visible to the CTA after a __syncthreads); the
// valid bits are in sh.vbits and the row pointers in sh.rows / sh.prows on
// every rank.  Rank 0 has read the other ranks' shared memory: they must not
// exit before the caller's next cluster barrier.
template <int KP, bool kGram>
__device__ __forceinline__ void node_totals(const Inputs& in, Node<KP>& sh, float* smem,
                                            const Layout& L, cg::cluster_group& cluster) {
  constexpr int S = KP / kWarps;  // candidates per warp
  const int n = blockIdx.y;
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = in.K;
  const long long D = in.D;
  const bool has_prev = in.prev != nullptr;
  const size_t nk = (size_t)n * K;
  float* ring = smem;
  float* sMed = smem + L.med;
  float* part = smem + L.part;
  double* dpart = reinterpret_cast<double*>(smem + L.dpart);

  if (tid < K) {
    const long long r = in.idx[nk + tid];
    const long long pr = in.prev_idx != nullptr ? in.prev_idx[nk + tid] : r;
    sh.rows[tid] = in.models + r * D;
    sh.prows[tid] = has_prev ? in.prev + pr * D : nullptr;
  }
  if (warp == 0) {
    const bool vk = lane < K && in.valid[nk + lane] != 0;
    const unsigned b = __ballot_sync(kFull, vk);
    if (lane == 0) sh.vbits = b;
  }
  for (int q = tid; q < L.n_tot; q += kThreads) part[q] = 0.f;
  for (int q = tid; q < n_stats<KP>(); q += kThreads) dpart[q] = 0.0;
  if constexpr (kGram) {
    // the Gram's padding rows K .. round4(K) - 1: zero in every stage, never
    // loaded
    const int pad = (round4(K) - K) * kRow;
    for (int e = tid; e < kStages * pad; e += kThreads)
      ring[(e / pad) * L.streams * L.stage + K * kRow + e % pad] = 0.f;
  }
  __syncthreads();
  const unsigned vbits = sh.vbits;
  const int v = __popc(vbits);

  // running sums over the tiles, in double: per (slot, field) of this
  // warp's slots, and mednorm2 per thread
  double acc[S][F_COUNT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int f = 0; f < F_COUNT; ++f) acc[s][f] = 0.0;
  double mn2 = 0.0;

  const GramBlocks gb(K);
  const bool gitem = kGram && tid < gb.BP * gb.S;
  int bi = 0, bj = 0, gs = 0;
  if (gitem) {
    wfagg_common::pair_of(tid / gb.S, gb.nb, bi, bj);
    gs = tid % gb.S;
  }
  float gacc[kGram ? 16 : 1];
#pragma unroll
  for (int e = 0; e < (kGram ? 16 : 1); ++e) gacc[e] = 0.f;

  const long long my_n = rank_tiles(D, rank, C);
  const uint32_t ring_at = tile_stream::shared_address(ring);
  auto load = [&](long long i) {
    const uint32_t dst = ring_at + 4u * (uint32_t)((i % kStages) * L.streams * L.stage);
    const long long c0 = (rank + i * C) * kTile;
    if (in.vec == 4)
      load_tile<4>(dst, sh.rows, sh.prows, K, has_prev, c0, D, L.stage);
    else if (in.vec == 2)
      load_tile<2>(dst, sh.rows, sh.prows, K, has_prev, c0, D, L.stage);
    else
      load_tile<1>(dst, sh.rows, sh.prows, K, has_prev, c0, D, L.stage);
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_n) load(i);
    tile_stream::commit();
  }
  for (long long i = 0; i < my_n; ++i) {
    tile_stream::wait<kStages - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();                   // everyone's copies; tile i - 1 is done with
    if (i + kStages - 1 < my_n) load(i + kStages - 1);  // into tile i - 1's stage
    tile_stream::commit();
    const float* U = ring + (i % kStages) * L.streams * L.stage;
    const float* P = U + L.stage;

    // median of coordinate tid (past D: zeros, median 0, adds +0 everywhere)
    float u[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) u[k] = k < K ? U[k * kRow + tid] : 0.f;
    const float med = v == KP ? wfagg_common::full_median<KP>(u)
                              : wfagg_common::valid_median<KP>(u, vbits, v);
    sMed[tid] = med;
    add_term(mn2, med, med);
    __syncthreads();

    // per-slot sums: warp w owns slots w, w + 8, ...; lane i adds the tile's
    // coordinates 4i .. 4i + 3, then 128 + 4i .. 128 + 4i + 3
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = warp + kWarps * s;
      if (k < K) {
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          const int c = 128 * p + 4 * lane;
          const float4 x = ld4(U + k * kRow + c);
          add4(acc[s], x, ld4(sMed + c));
          if (has_prev) add4_prev(acc[s], x, ld4(P + k * kRow + c));
        }
      }
    }

    // Gram: block pair (bi, bj), float4 groups gs, gs + S, ...
    if constexpr (kGram) {
      if (gitem) {
        const float* A = U + 4 * bi * kRow;
        const float* B = U + 4 * bj * kRow;
        for (int g = gs; g < kGroups; g += gb.S) {
          const int c = 4 * g;
          float4 a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = ld4(A + r * kRow + c);
            b[r] = ld4(B + r * kRow + c);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              float t = gacc[4 * r + cc];
              t = fmaf(a[r].x, b[cc].x, t);
              t = fmaf(a[r].y, b[cc].y, t);
              t = fmaf(a[r].z, b[cc].z, t);
              t = fmaf(a[r].w, b[cc].w, t);
              gacc[4 * r + cc] = t;
            }
        }
      }
    }
  }

  // ---- this CTA's totals, in a fixed order --------------------------------
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = warp + kWarps * s;
    if (k < K) {
#pragma unroll
      for (int f = 0; f < F_COUNT; ++f) {
        const double x = warp_sum(acc[s][f]);
        if (lane == 0) dpart[f * KP + k] = x;
      }
    }
  }
  const double m2 = warp_sum(mn2);
  if (lane == 0) sh.red[warp] = m2;
  __syncthreads();  // every warp is past the last tile: the ring is dead
  if (tid == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sh.red[w];
    dpart[F_COUNT * KP] = t;
  }
  if constexpr (kGram) {
    float* slices = ring;  // (BP, S, 16)
    if (gitem) {
#pragma unroll
      for (int e = 0; e < 16; ++e) slices[tid * 16 + e] = gacc[e];
    }
    __syncthreads();
    for (int p = tid; p < K * (K + 1) / 2; p += kThreads) {
      int i, j;
      wfagg_common::pair_of(p, K, i, j);
      const int pi = i >> 2, pj = j >> 2;
      const int bp = pi * gb.nb - pi * (pi - 1) / 2 + (pj - pi);
      const float* x = slices + (size_t)bp * gb.S * 16 + 4 * (i & 3) + (j & 3);
      float t = 0.f;
      for (int s = 0; s < gb.S; ++s) t += x[s * 16];
      part[n_stats<KP>() + p] = t;
    }
  }

  // ---- the node's totals: the ranks' totals in rank order, on rank 0 -----
  cluster.sync();
  if (rank == 0) {
    float* tot = smem + L.tot;
    for (int q = tid; q < L.n_tot; q += kThreads) {
      if (q < n_stats<KP>()) {
        double t = 0.0;
        for (int r = 0; r < C; ++r) t += cluster.map_shared_rank(dpart, r)[q];
        tot[q] = __double2float_rn(t);
      } else {
        float t = 0.f;
        for (int r = 0; r < C; ++r) t += cluster.map_shared_rank(part, r)[q];
        tot[q] = t;
      }
    }
  }
}

// ---- host side: cluster size and launch ------------------------------------

// The cluster size of a launch over D coordinates: the portable maximum of 8
// CTAs, at most one a tile.  On the H100 at N = 64, K = 16, d = 2^20 the
// sizes 2 and 8 ran fastest (3 and 4 slower), and 8 at the paper's N = 20; a
// cluster of 8 fits every shared-memory size of these kernels in one GPC.
__host__ __device__ constexpr int cluster_size(long long D) {
  return (D + kTile - 1) / kTile < kMaxCluster ? (int)((D + kTile - 1) / kTile)
                                               : kMaxCluster;
}

// Launch kernel on a (C, N) grid in clusters of (C, 1, 1), C = cluster_size(D),
// after raising its dynamic shared memory limit to smem.
template <typename... KArgs, typename... Args>
cudaError_t cluster_launch(void (*kernel)(KArgs...), size_t smem, int N, long long D,
                           cudaStream_t stream, Args&&... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int C = cluster_size(D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, N, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace phase0
