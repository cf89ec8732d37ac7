// Phase 0 of the gossip round above 32 neighbours (K = 33 .. 1024), for
// Hopper (sm_90a): the wide route of wfagg_round.cu (kernel 1) and
// robust_stats_indexed.cu (kernel 2), beside the register route of
// indexed_phase0.cuh, which K <= 32 keeps.  Like it, it replaces the
// phase-0 loops of the Pallas kernels _wfagg_round_indexed_kernel and
// _robust_stats_indexed_kernel (src/repro/kernels/robust_stats/kernel.py:367
// and :191), which unroll their sort network over any static K.
//
// For receiving node n with candidate rows u_k = models[idx[n, k]] (read
// through the index table) and, with prev, p_k = prev[idx[n, k]] or
// prev[prev_idx[n, k]], it computes the valid-masked coordinate-wise median
// med, the node's totals dist2 / dotmed / norm2 / prev_dist2 / prev_dot /
// prev_norm2 per slot and mednorm2, and in the Gram variant the (K, K) Gram
// sum u_i u_j, written straight to the node's (K, K) output.
//
// What bounds it on this card: the bytes of the rows (4 K D per stream and
// node at 3.35 TB/s, less what L2 serves to nodes that share a neighbour)
// and, above K ~ 64, the sort: a bitonic network of K' log2(K')^2 / 4
// compare-exchanges per coordinate (K' = K rounded up to a power of two);
// with the Gram, K (K + 1) float32 flops per node coordinate.
//
// Design (a simple kernel that is right; making it fast is later work):
//   * The cluster of C <= 8 CTAs per node of indexed_phase0.cuh (grid (C,
//     N)); rank r takes the tiles r, r + C, ... of T coordinates, T =
//     tile(K) = 16,384 / K' (256 up to K = 64, 16 at K = 1,024): a (K', T)
//     sort buffer of 64 KB.
//   * Per tile, as the wide path of robust_stats.cu: thread (column c, run s)
//     loads ranks 64 s .. 64 s + 63 of column c straight into registers
//     (invalid slots and rows past K +inf, coordinates past D 0), every
//     column is sorted by a bitonic network (fminf / fmaxf; the steps inside
//     a 64-rank run in registers, the stages pairing two runs through the
//     buffer), and thread t < T takes column t's median at the dynamic
//     middles (v - 1) / 2 and v / 2 of the valid count v (0 when v = 0) and
//     its mednorm2 term.
//   * The sums: G = group(K) threads per slot (the largest power of two with
//     G K <= 256), thread (slot, g) adding columns g, g + G, ... of each tile
//     (read again from device memory, mostly from L2) into running float64
//     sums of the plain version's float32 terms, kept in shared memory; at
//     the end a slot's G sums are added in group order.
//   * The valid mask is an array of 32-bit words; the row pointers are
//     arrays of K in shared memory.
//   * The Gram: 64 x 64 output tiles of the upper triangle in order (as
//     pairwise_gram.cu's), each over all of D split among the ranks (rank r
//     takes the 16-coordinate chunks [r P, (r + 1) P), P = ceil(chunks / C)),
//     one fmaf chain per entry in coordinate order; each rank's partial tile
//     in its shared memory, then the ranks' partials of an entry added in
//     rank order through distributed shared memory and written to both
//     triangles of the node's (K, K) output.  No atomics.
//   * Fixed-order reduction: the slot totals and mednorm2 (warp butterflies,
//     the warps in order) in float64 per CTA, then rank 0 adds the ranks'
//     totals in rank order through distributed shared memory, as the
//     register route does.
//   * The tie invariant of the register route holds: every per-slot sum and
//     Gram entry is one expression tree (the same columns per group in the
//     same order, the same chunk split and rank order), so two bit-identical
//     rows a, b get bit-identical statistics and Gram rows, and G[a,a] ==
//     G[a,b] == G[b,b].
// ref.robust_stats_indexed_kernel_order emulates this order on the CPU.
// What it leaves on the table: the shared-memory sort stages (10 at K =
// 1,024), the rows read twice (sort, sums), the Gram's SIMT fmaf with one
// cluster barrier pair a tile, and one CTA an SM.
//
// No fast-math: invalid slots sort as +inf.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "indexed_phase0.cuh"

namespace phase0w {

namespace cg = cooperative_groups;
using phase0::F_COUNT;
using phase0::F_D2;
using phase0::F_DM;
using phase0::F_N2;
using phase0::F_PD2;
using phase0::F_PDT;
using phase0::F_PN2;
using phase0::kFull;
using phase0::kThreads;
using phase0::kWarps;

constexpr int kMaxK = 1024;
constexpr int kNarrowK = 32;            // the register route's K; above: this one
constexpr int kMaxWords = kMaxK / 32;   // words of the valid mask
constexpr int kRun = 64;                // ranks of a column a thread sorts in registers
constexpr int kLogRun = 6;
constexpr int kSortFloats = 16384;      // the (K', T) sort buffer: kRun x kThreads
constexpr int kGramSide = 64;           // Gram entries a side of an output tile
constexpr int kGramChunk = 16;          // coordinates a step of a Gram tile
constexpr int kGramRow = kGramSide + 4; // shared row stride of a Gram step (floats)

__host__ __device__ inline int width(int K) {
  int kp = kRun;
  while (kp < K) kp <<= 1;
  return kp;
}
__host__ __device__ inline int tile(int K) { return kSortFloats / width(K); }
__host__ __device__ inline int group(int K) {
  int g = 1;
  while (2 * g * K <= kThreads) g *= 2;
  return g;
}
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// dynamic shared memory, in floats: the row pointers (2K of 8 bytes), the
// valid words, the sort buffer (later the Gram's steps and partial tile, the
// Krum sort and phase 1's coefficients), med of one tile, the groups' running
// sums in double (later the node's totals on rank 0), and this CTA's totals
// in double (read by rank 0; later rank 0's epilogue scratch)
struct Layout {
  int ptrs, words, srt, med, acc, dpart, n_dpart, total;
  __host__ __device__ explicit Layout(int K) {
    ptrs = 0;
    words = ptrs + 4 * K;
    srt = words + kMaxWords;
    med = srt + kSortFloats;
    acc = med + 256;
    dpart = acc + 2 * F_COUNT * group(K) * K;
    n_dpart = round4(2 * (F_COUNT * K + 1));
    total = dpart + n_dpart;
  }
  __host__ __device__ size_t bytes() const { return (size_t)total * sizeof(float); }
};

// the layout's arrays
struct Smem {
  const float** rows;
  const float** prows;
  unsigned* vw;
  float* srt;
  float* med;
  double* acc;
  float* tot;    // rank 0: the node's totals (6K + 1 floats), over acc
  double* dpart;
  __device__ Smem(float* smem, const Layout& L, int K)
      : rows(reinterpret_cast<const float**>(smem + L.ptrs)),
        prows(reinterpret_cast<const float**>(smem + L.ptrs) + K),
        vw(reinterpret_cast<unsigned*>(smem + L.words)),
        srt(smem + L.srt),
        med(smem + L.med),
        acc(reinterpret_cast<double*>(smem + L.acc)),
        tot(smem + L.acc),
        dpart(reinterpret_cast<double*>(smem + L.dpart)) {}
};

__device__ __forceinline__ bool valid_at(const unsigned* vw, int k) {
  return (vw[k >> 5] >> (k & 31)) & 1u;
}

__device__ __forceinline__ int valid_count(const unsigned* vw, int K) {
  int v = 0;
  for (int q = 0; q < (K + 31) / 32; ++q) v += __popc(vw[q]);
  return v;
}

// compare-exchange of positions x < y: the smaller value to x when up
__device__ __forceinline__ void cex(float& x, float& y, bool up) {
  const float mn = fminf(x, y), mx = fmaxf(x, y);
  x = up ? mn : mx;
  y = up ? mx : mn;
}

// The columns of a (KP, T) block sorted ascending, written rank-major to srt
// (KP T = kSortFloats).  Thread (column col, run base / 64) holds ranks base
// .. base + 63 of column col in v; every thread of the CTA calls it, and the
// caller syncs before reading srt.  The steps up to 64 ranks run inside each
// run in registers; above, the stages j >= 64 of step k pair two runs
// through srt and the rest run in registers again.
__device__ __forceinline__ void sort_columns(float (&v)[kRun], float* srt, int KP, int T,
                                             int col, int base) {
#pragma unroll
  for (int lk = 1; lk <= kLogRun; ++lk)
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj)
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        if ((e & (1 << lj)) == 0) cex(v[e], v[e + (1 << lj)], ((base + e) & (1 << lk)) == 0);
  for (int k = 2 * kRun; k <= KP; k <<= 1) {
    const bool up = (base & k) == 0;
    for (int j = k >> 1; j >= kRun; j >>= 1) {
#pragma unroll
      for (int e = 0; e < kRun; ++e) srt[(base + e) * T + col] = v[e];
      __syncthreads();
      const bool lower = (base & j) == 0;  // this run holds the pairs' lower ranks
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const float w = srt[((base ^ j) + e) * T + col];
        v[e] = lower == up ? fminf(v[e], w) : fmaxf(v[e], w);
      }
      __syncthreads();
    }
#pragma unroll
    for (int lj = kLogRun - 1; lj >= 0; --lj)
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        if ((e & (1 << lj)) == 0) cex(v[e], v[e + (1 << lj)], ((base + e) & k) == 0);
  }
#pragma unroll
  for (int e = 0; e < kRun; ++e) srt[(base + e) * T + col] = v[e];
}

// the float32 product a * b (as the plain version forms it) added to s
__device__ __forceinline__ void add_term(double& s, float a, float b) {
  s += (double)__fmul_rn(a, b);
}

// The (K, K) Gram of the node's rows into gout (both triangles), over the
// cluster's ranks: output tile pairs (bi <= bj) of the row-major upper
// triangle in order, each rank an fmaf chain over its chunks of D, then the
// ranks' partials in rank order.  Every thread of every rank calls it (one
// cluster barrier pair a tile pair); sbuf is 8,448 floats of this CTA's
// shared memory, 16-byte aligned.
__device__ __forceinline__ void gram_tiles(const float* const* rows, int K, long long D,
                                           int rank, int C, cg::cluster_group& cluster,
                                           float* sbuf, float* gout) {
  float* sA = sbuf;                                  // [2][kGramChunk][kGramRow]
  float* sB = sA + 2 * kGramChunk * kGramRow;
  float* part = sB + 2 * kGramChunk * kGramRow;      // [kGramSide][kGramSide]
  const int nt = (K + kGramSide - 1) / kGramSide;
  const long long n_chunks = (D + kGramChunk - 1) / kGramChunk;
  const long long per = (n_chunks + C - 1) / C;
  const long long ch0 = rank * per < n_chunks ? rank * per : n_chunks;
  const long long ch1 = ch0 + per < n_chunks ? ch0 + per : n_chunks;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // loads: row tid / 4 of each side's tile, coordinates 4 (tid % 4) .. + 3
  const int lr = tid >> 2, lc = (tid & 3) * 4;
  for (int p = 0; p < nt * (nt + 1) / 2; ++p) {
    int bi, bj;
    wfagg_common::pair_of(p, nt, bi, bj);
    const int ra = bi * kGramSide + lr, rb = bj * kGramSide + lr;
    const float* pa = ra < K ? rows[ra] : nullptr;
    const float* pb = rb < K ? rows[rb] : nullptr;
    float va[4], vb[4];
    auto fetch = [&](long long ch) {
      const long long c = ch * kGramChunk + lc;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = c + e < D;
        va[e] = pa != nullptr && in ? __ldg(pa + c + e) : 0.f;
        vb[e] = pb != nullptr && in ? __ldg(pb + c + e) : 0.f;
      }
    };
    auto stash = [&](int st) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sA[(st * kGramChunk + lc + e) * kGramRow + lr] = va[e];
        sB[(st * kGramChunk + lc + e) * kGramRow + lr] = vb[e];
      }
    };
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    __syncthreads();  // the buffers are free: the last tile's steps are done
    if (ch0 < ch1) {
      fetch(ch0);
      stash(0);
    }
    __syncthreads();
    for (long long ch = ch0; ch < ch1; ++ch) {
      const int st = (int)((ch - ch0) & 1);
      const bool more = ch + 1 < ch1;
      if (more) fetch(ch + 1);  // in flight while this step is summed
#pragma unroll
      for (int kk = 0; kk < kGramChunk; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(sA + (st * kGramChunk + kk) * kGramRow + 4 * ty);
        const float4 b = *reinterpret_cast<const float4*>(sB + (st * kGramChunk + kk) * kGramRow + 4 * tx);
        const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
      }
      if (more) stash(st ^ 1);  // the other buffer: everyone left it a step ago
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[(4 * ty + r) * kGramSide + 4 * tx + c] = acc[r][c];
    cluster.sync();  // every rank's partial tile is written
    for (int e = rank * kThreads + tid; e < kGramSide * kGramSide; e += kThreads * C) {
      const int i = bi * kGramSide + e / kGramSide, j = bj * kGramSide + e % kGramSide;
      if (i < K && j < K && (bi < bj || i <= j)) {
        float t = 0.f;
        for (int r = 0; r < C; ++r) t += cluster.map_shared_rank(part, r)[e];
        gout[(size_t)i * K + j] = t;
        gout[(size_t)j * K + i] = t;
      }
    }
    __threadfence();
    cluster.sync();  // every rank has read the partial tiles
  }
}

// Phase 0 of node blockIdx.y over the CTAs of its cluster, K > 32.  Every
// thread of every CTA calls it.  On return rank 0's threads have written the
// node's totals to sm.tot (fields f at f K + k, mednorm2 at 6K; visible to the
// CTA after a __syncthreads), the Gram variant's (K, K) Gram is in gout
// (visible to the cluster), and every rank holds the valid words and row
// pointers.  Rank 0 has read the other ranks' shared memory: they must not
// exit before the caller's next cluster barrier.
template <bool kGram>
__device__ __forceinline__ void node_totals(const phase0::Inputs& in, const Smem& sm,
                                            cg::cluster_group& cluster, float* gout) {
  __shared__ double red[kWarps];
  const int n = blockIdx.y;
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = in.K;
  const long long D = in.D;
  const bool has_prev = in.prev != nullptr;
  const size_t nk = (size_t)n * K;
  const int G = group(K);

  for (int k = tid; k < K; k += kThreads) {
    const long long r = in.idx[nk + k];
    const long long pr = in.prev_idx != nullptr ? in.prev_idx[nk + k] : r;
    sm.rows[k] = in.models + r * D;
    sm.prows[k] = has_prev ? in.prev + pr * D : nullptr;
  }
  for (int q = warp; q < (K + 31) / 32; q += kWarps) {
    const int k = 32 * q + lane;
    const unsigned b = __ballot_sync(kFull, k < K && in.valid[nk + k] != 0);
    if (lane == 0) sm.vw[q] = b;
  }
  for (int q = tid; q < F_COUNT * G * K; q += kThreads) sm.acc[q] = 0.0;
  for (int q = tid; q < F_COUNT * K + 1; q += kThreads) sm.dpart[q] = 0.0;
  __syncthreads();
  const int v = valid_count(sm.vw, K);
  const int KP = width(K), T = tile(K);
  const int col = tid & (T - 1), base = (tid / T) * kRun;
  const int g = tid & (G - 1), k0 = tid / G, kstep = kThreads / G;
  const int lo = (v - 1) >> 1, hi = v >> 1;
  double mn2 = 0.0;

  const long long n_tiles = (D + T - 1) / T;
  const long long my = rank < n_tiles ? (n_tiles - 1 - rank) / C + 1 : 0;
  for (long long i = 0; i < my; ++i) {
    const long long c0 = (rank + i * C) * T;
    const bool in_d = c0 + col < D;
    __syncthreads();  // the last tile's sums have read med; the buffer is free
    float x[kRun];
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      const int r = base + e;
      x[e] = r < K && valid_at(sm.vw, r) ? (in_d ? __ldg(sm.rows[r] + c0 + col) : 0.f)
                                         : INFINITY;
    }
    sort_columns(x, sm.srt, KP, T, col, base);
    __syncthreads();
    // column tid: the median at the dynamic middles and its mednorm2 term
    if (tid < T) {
      const float m = v > 0 ? 0.5f * (sm.srt[lo * T + tid] + sm.srt[hi * T + tid]) : 0.f;
      sm.med[tid] = m;
      add_term(mn2, m, m);
    }
    __syncthreads();
    // the tile's sums: slot k's group g adds columns g, g + G, ... in order
    for (int k = k0; k < K; k += kstep) {
      double* a = sm.acc + (size_t)k * F_COUNT * G + g;  // field f at a[f G]
      double t[F_COUNT];
#pragma unroll
      for (int f = 0; f < F_COUNT; ++f) t[f] = a[f * G];
      const float* xr = sm.rows[k] + c0;
      const float* pr = has_prev ? sm.prows[k] + c0 : nullptr;
      for (int c = g; c < T; c += G) {
        const bool in_c = c0 + c < D;
        const float xv = in_c ? __ldg(xr + c) : 0.f, m = sm.med[c];
        const float dd = __fsub_rn(xv, m);
        add_term(t[F_D2], dd, dd);
        add_term(t[F_DM], xv, m);
        add_term(t[F_N2], xv, xv);
        if (has_prev) {
          const float pv = in_c ? __ldg(pr + c) : 0.f;
          const float dp = __fsub_rn(xv, pv);
          add_term(t[F_PD2], dp, dp);
          add_term(t[F_PDT], xv, pv);
          add_term(t[F_PN2], pv, pv);
        }
      }
#pragma unroll
      for (int f = 0; f < F_COUNT; ++f) a[f * G] = t[f];
    }
  }

  // ---- this CTA's totals, in a fixed order --------------------------------
  __syncthreads();
  for (int e = tid; e < F_COUNT * K; e += kThreads) {
    const int k = e / F_COUNT, f = e - k * F_COUNT;
    double t = 0.0;
    for (int q = 0; q < G; ++q) t += sm.acc[(size_t)e * G + q];
    sm.dpart[f * K + k] = t;
  }
  const double m2 = phase0::warp_sum(mn2);
  if (lane == 0) red[warp] = m2;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w];
    sm.dpart[F_COUNT * K] = t;
  }
  if constexpr (kGram) gram_tiles(sm.rows, K, D, rank, C, cluster, sm.srt, gout);

  // ---- the node's totals: the ranks' totals in rank order, on rank 0 -----
  cluster.sync();
  if (rank == 0) {
    for (int q = tid; q < F_COUNT * K + 1; q += kThreads) {
      double t = 0.0;
      for (int r = 0; r < C; ++r) t += cluster.map_shared_rank(sm.dpart, r)[q];
      sm.tot[q] = __double2float_rn(t);
    }
  }
}

// the dynamic shared memory of the wide route for K candidates
__host__ inline size_t smem_bytes(int K) { return Layout(K).bytes(); }

}  // namespace phase0w
