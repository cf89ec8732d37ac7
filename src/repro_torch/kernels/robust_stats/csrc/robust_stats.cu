// Robust statistics of (K, D) candidate matrices, for Hopper (sm_90a): one
// matrix (kernel 4) or a gathered (N, K, D) tensor, one matrix per node
// (kernel 5).
//
// Replaces the Pallas TPU kernel _robust_stats_kernel
// (src/repro/kernels/robust_stats/kernel.py:70) in both of its launches:
// d_axis=0 by robust_stats_pallas (kernel.py:136, the single-node wfagg()
// and the CFL server) and d_axis=1 by robust_stats_batch_pallas
// (kernel.py:652, the gathered wfagg_batch).  For node n's candidates
// u_k (k < K <= 1024) and, optionally, their previous-round rows p_k (a
// per-edge (N, K, D) tensor) it computes
//   med[d]     coordinate-wise median (mean of the two middles for even K)
//   trim[d]    beta-trimmed mean: mean of the sorted values t .. K-t-1
//   dist2[k]   sum_d (u_k - med)^2        dotmed[k]  sum_d u_k * med
//   norm2[k]   sum_d u_k^2                mednorm2   sum_d med^2
//   prev_dist2[k] sum_d (u_k - p_k)^2, prev_dot[k] sum_d u_k * p_k,
//   prev_norm2[k] sum_d p_k^2             (only with prev)
// med and trim are written only when asked for (need_center); the WFAgg
// filter bank reads only the O(K) sums.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s float32): bytes.  The
// function must read the candidates (and prev) once, 4 N K D bytes per
// stream: 0.3205 ms for kernel 4 at K = 32, D = 2^22 with prev, 2.5642 ms
// for kernel 5 at N = 64, K = 16, d = 2^20 with per-edge prev.  Its
// operations (a sorting network per coordinate, about 15 flops per
// candidate coordinate) take a third of that or less.
//
// Two paths: K <= 32 sorts each coordinate in registers (the register
// path, below); K > 32 sorts a tile's columns in shared memory (the wide
// path, after it).  Both deal D to B CTAs per node and end with the same
// fixed-order finish.
//
// Design of the register path:
//   * Grid (B, N): B CTAs of 256 threads per node, B N about the CTAs the
//     card holds at once (the wrapper sizes B from this kernel's occupancy,
//     robust_stats_plan), so one node (kernel 4) fills the card as N = 64
//     nodes do.  CTA b takes the node's 256-coordinate tiles b, b + B, ...
//   * A cp.async tile stream (kernels/csrc/tile_stream.cuh): a ring of
//     `stages` tiles of the node's K rows (and K prev rows) in shared
//     memory, copies of 16 bytes where D % 4 == 0 and the rows are 16-byte
//     aligned, else 8 or 4 (the paper's d = 44,426 has D % 4 = 2; the
//     single matrix is not padded); rows zero-filled past D.  Row stride
//     260 floats: rows stay 16-byte aligned and start on different banks.
//     The stages are the fewest (at least 3) that keep 32 KB of tiles in
//     flight per CTA, at most 6 and at most ~200 KB (plan_stages).
//   * Skewed steps, one __syncthreads() per tile: iteration i sorts tile i
//     (thread t takes coordinate t, med to a double-buffered row) while the
//     warps sum tile i - 1 against the med row written an iteration before;
//     the copy of tile i + stages - 2 is issued right after the barrier,
//     into the stage tile i - 2 left, so stages - 2 tiles are in flight
//     while two are read.
//   * The median network: Batcher's odd-even merge sort, every
//     compare-exchange ascending (fminf to the lower wire, fmaxf to the
//     upper), 2 instructions each.  Padding wires (K < template width KP)
//     hold +inf and never move, so the compare-exchanges that touch them
//     are dropped at compile time for the K the main paths use (8, 16, 20,
//     32; 103 instead of 191 at K = 20) and kept for any other K.  Without
//     the centers only the middle ranks are read, and the compiler drops
//     what feeds nothing else.  fminf / fmaxf drop a NaN, so a per-column
//     flag (x != x, OR-ed over the K values) makes med and trim NaN, and
//     through med every candidate's sums: the plain version's result, where
//     a NaN sorts the whole column to NaN.
//   * The sums: warp w owns candidates k = w, w + 8, ...; lane i reads
//     float4 groups i and 32 + i of the staged row, its prev row and the med
//     row, and adds the four coordinates' terms in order.  Every term is
//     the float32 value the plain version forms (__fsub_rn, __fmul_rn) and
//     is added with __fadd_rn: no fused multiply-add, so a CPU emulation
//     (ref.robust_stats_kernel_order) reproduces every sum bit for bit,
//     and an overflowing term is +-inf as in the plain version.
//   * Fixed order, no atomics on the sums: lanes by an xor butterfly, the
//     warps' mednorm2 in warp order, each CTA's totals to its own row of an
//     (N, B, 6K+1) buffer; then a last-CTA ticket (one atomicAdd on a
//     per-node counter, not on a sum): the CTA that draws B - 1 adds the
//     node's B rows in block order and resets the counter.  One launch per
//     call.  Every slot's sum is one expression tree, so two bit-identical
//     rows get bit-identical sums whichever warp owns them (the index
//     tie-breaks of WFAgg-D and WFAgg-C), and results repeat run to run.
// What it still leaves on the table: 1 CTA per SM at K >= 20 with prev
// (the ring of 3 stages of 2K rows takes 125-200 KB), so at the CFL shape
// (174 tiles) each CTA waits out one or two tiles' latency; with the
// centers the full network and the trimmed sum make it issue-bound; the
// copies are issued by every thread (no TMA, no producer warp).  The network
// takes any power-of-two width KP, but a stage of 2 x 64 rows of 256
// coordinates (133 KB) would need a narrower tile: K > 32 takes the wide
// path.
//
// Design of the wide path (K = 33 .. 1024; a simple kernel that is right,
// not yet a fast one):
//   * The same grid (B, N) of 256 threads; CTA b takes the node's tiles b,
//     b + B, ... of T coordinates, T = wide_tile(K): the widest power of two
//     up to 256 at which a (KP, T) sort buffer fits 64 KB (KP = K rounded up
//     to a power of two: T = 256 up to K = 64, 128 to 128, 64 to 256, 32 to
//     512, 16 to 1,024).
//   * Per tile: thread (column c, run s) loads ranks 64 s .. 64 s + 63 of
//     column c straight into registers (KP T = 16,384 = 64 x 256 at every
//     K; plain loads, any alignment; rows K .. KP-1 +inf, columns past D 0);
//     a per-column NaN flag as in the register path; every column sorted by
//     a bitonic network (fminf / fmaxf): steps up to 64 ranks inside each
//     run, in registers, and above them the stages that pair two runs
//     through the (KP, T) buffer in shared memory (1 at KP = 128, 10 at
//     1,024), the rest again in registers; the runs written back to the
//     buffer, rank-major; thread t < T takes column t's
//     median, its mednorm2 term and, with the centers, its trimmed sum in
//     rank order, in double (a float32 sum of ~800 ranks drifts ~2e-6 from
//     the plain version's mean, past the trimmed mean's rtol 1e-5 where it
//     is near 0), divided in double and rounded once.
//   * The sums: G = wide_group(K) threads per candidate (the largest power of
//     two with G K <= 256), so a thread owns at most 4 candidates (K =
//     1,024) and keeps their running sums in registers over all its tiles;
//     group g adds columns g, g + G, ... of each tile in order (read from
//     global memory a second time, mostly from L2), and at the end the G
//     groups, neighbouring lanes, are added by an xor butterfly.  The same
//     terms as the register path, without fused multiply-adds:
//     ref.robust_stats_kernel_order emulates this order too, and two
//     bit-identical rows get bit-identical sums.
//   * One CTA an SM (__launch_bounds__(256, 1)): a thread's run and its sums
//     take 255 registers without spilling (at two an SM, 128 registers
//     spilled 840 bytes and the CTAs ran slower, PERF.md section 6).
//   * Each CTA's totals to its row of (N, B, 6K+1), then the last-CTA ticket,
//     as the register path.
//
// No fast-math: the padding is +inf and NaN must be detected.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr int kThreads = 256;           // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;              // coordinates per tile
constexpr int kRow = kTile + 4;         // shared row stride (floats)
constexpr int kPasses = kTile / 128;    // a lane's float4 passes over a tile row
constexpr int kMinStages = 3;           // two tiles read, one in flight
constexpr int kMaxStages = 6;
constexpr int kInFlightBytes = 32 << 10;  // tiles in flight per CTA, at least
constexpr int kMaxSmemBytes = 204 << 10;  // the ring and the med rows
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNetworkMaxK = 32;          // the register path's K
constexpr int kWideMaxK = 1024;           // the wide path's
constexpr int kWideSortBytes = 64 << 10;  // the wide sort buffer, at most ...
constexpr int kWideMinTile = 16;          // ... (K = 1,024: 16 columns)
constexpr int kWideMaxTile = 256;

// fields of a partial row: F_COUNT blocks of K, then mednorm2 (the output
// is (F_COUNT + 1, K) per node, mednorm2 at [F_COUNT, 0], zeros after it)
enum { F_D2 = 0, F_DM, F_N2, F_PD2, F_PDT, F_PN2, F_COUNT };

struct Args {
  const float* u;        // (N, K, D)
  const float* prev;     // (N, K, D) or null
  float* med;            // (N, D) or null (centers not wanted)
  float* trim;           // (N, D) or null
  float* partials;       // (N, B, F_COUNT K + 1): each CTA's totals
  unsigned* tickets;     // (N,): 0 on entry, 0 again on exit
  float* out;            // (N, F_COUNT + 1, K): mednorm2 at [n, F_COUNT, 0]
  int K;
  long long D;
  int n_trim;
  int stages;            // tiles in the ring (plan_stages)
  int vec;               // copy width in floats (tile_stream::copy_width)
};

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// Batcher's odd-even merge sort of the first KS (KS == 0: all KP) wires of
// KP, every compare-exchange ascending.  With +inf on the wires past K the
// ones that touch them do nothing, so KS = K drops them and sorts the same.
// Step (p, k) = (2^lp, 2^lk), lk = lp .. 0, pairs wire lo with lo + k where
// lo - k % p falls in the first half of a 2k block and both wires lie in one
// 2p block.  Every loop has a constant trip count, so the network unrolls
// fully and the wires stay in registers.
template <int KP, int KS>
__device__ __forceinline__ void odd_even_sort(float (&a)[KP]) {
  constexpr int kLimit = KS > 0 ? KS : KP;
  constexpr int kLog = ilog2(KP);
#pragma unroll
  for (int lp = 0; lp < kLog; ++lp) {
#pragma unroll
    for (int lk = kLog - 1; lk >= 0; --lk) {
      if (lk > lp) continue;
      const int p = 1 << lp, k = 1 << lk, j0 = k % p;
#pragma unroll
      for (int lo = 0; lo < KP; ++lo) {
        const int hi = lo + k;
        if (lo >= j0 && (lo - j0) % (2 * k) < k && hi < kLimit &&
            lo / (2 * p) == hi / (2 * p)) {
          const float x = a[lo], y = a[hi];
          a[lo] = fminf(x, y);
          a[hi] = fmaxf(x, y);
        }
      }
    }
  }
}

// xor butterfly: every lane ends with the same, bit-identical sum
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// the float32 product a * b, as the plain version forms it, added to s
__device__ __forceinline__ void add_term(float& s, float a, float b) {
  s = __fadd_rn(s, __fmul_rn(a, b));
}

__device__ __forceinline__ void add4(float (&acc)[F_COUNT], const float4 x, const float4 m) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ms[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float dd = __fsub_rn(xs[e], ms[e]);
    add_term(acc[F_D2], dd, dd);
    add_term(acc[F_DM], xs[e], ms[e]);
    add_term(acc[F_N2], xs[e], xs[e]);
  }
}

__device__ __forceinline__ void add4_prev(float (&acc)[F_COUNT], const float4 x,
                                          const float4 p) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ps[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float dp = __fsub_rn(xs[e], ps[e]);
    add_term(acc[F_PD2], dp, dp);
    add_term(acc[F_PDT], xs[e], ps[e]);
    add_term(acc[F_PN2], ps[e], ps[e]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// copy one tile (coordinates c0 ..) of the K rows u and the K rows p (rows K
// .. 2K - 1 of the stage) into the stage at shared address dst.  Thread t
// copies column (t % CPR) VEC of rows t / CPR, t / CPR + 256 / CPR, ...;
// with D % VEC == 0 a copy is all inside a row or all past its end.
template <int VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* u, const float* p,
                                          int K, int rows, long long c0, long long D) {
  constexpr int CPR = kTile / VEC;  // copies per row
  constexpr int STEP = kThreads / CPR;
  const int col = (threadIdx.x % CPR) * VEC;
  const bool in = c0 + col < D;
  const long long off = in ? c0 + col : 0;
  for (int r = threadIdx.x / CPR; r < rows; r += STEP) {
    const float* src = (r < K ? u + (size_t)r * D : p + (size_t)(r - K) * D) + off;
    tile_stream::cp_async<VEC>(dst + 4u * (uint32_t)(r * kRow + col), src, in);
  }
}

// The last of a node's B CTAs, by a ticket (one atomicAdd on a per-node
// counter, not on a sum), adds the node's B rows of F floats in block order
// into its (F_COUNT + 1) K outputs (F = F_COUNT K + 1) (the fields, then mednorm2 and zeros) and
// resets the counter.  Every thread of the CTA calls it once the CTA's row is
// written; `last` is a __shared__ flag of the kernel.
__device__ __forceinline__ void finish_node(const float* partials, unsigned* tickets,
                                            float* out, size_t node, int B, int K,
                                            int F, bool& last) {
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + node, 1u) == (unsigned)(B - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* rows0 = partials + node * B * (size_t)F;
  const int n_out = (F_COUNT + 1) * K;  // the fields, then mednorm2 and zeros
  for (int q = tid; q < n_out; q += kThreads) {
    float t = 0.f;
    int r = 0;
    // 32 loads in flight, then their adds in block order
    for (; q < F && r + 32 <= B; r += 32) {
      float v[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) v[e] = __ldcg(rows0 + (size_t)(r + e) * F + q);
#pragma unroll
      for (int e = 0; e < 32; ++e) t = __fadd_rn(t, v[e]);
    }
    for (; q < F && r < B; ++r) t = __fadd_rn(t, __ldcg(rows0 + (size_t)r * F + q));
    out[node * n_out + q] = t;
  }
  if (tid == 0) tickets[node] = 0u;
}

template <int KP, int KS, bool kCenter>
__global__ void __launch_bounds__(kThreads, KP == 32 ? 1 : 3)
stats_kernel(const Args a) {
  constexpr int S = KP / kWarps;  // candidates per warp
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps];
  __shared__ bool last;

  const int K = KS > 0 ? KS : a.K;
  const long long D = a.D;
  const bool has_prev = a.prev != nullptr;
  const int rows = has_prev ? 2 * K : K;
  const int stage = rows * kRow;
  const int n_st = a.stages;
  float* ring = smem;
  float* sMed = smem + (size_t)n_st * stage;  // 2 x kTile: tiles i and i - 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t node = blockIdx.y;
  const int b = blockIdx.x, B = gridDim.x;
  const float* u = a.u + node * K * (size_t)D;
  const float* p = has_prev ? a.prev + node * K * (size_t)D : nullptr;
  const long long n_tiles = (D + kTile - 1) / kTile;
  const int my = b < n_tiles ? (int)((n_tiles - 1 - b) / B + 1) : 0;

  float acc[S][F_COUNT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int f = 0; f < F_COUNT; ++f) acc[s][f] = 0.f;
  float mn2 = 0.f;

  const uint32_t ring_at = tile_stream::shared_address(ring);
  auto load = [&](int i) {
    const uint32_t dst = ring_at + 4u * (uint32_t)((i % n_st) * stage);
    const long long c0 = (b + (long long)i * B) * kTile;
    if (a.vec == 4)
      load_tile<4>(dst, u, p, K, rows, c0, D);
    else if (a.vec == 2)
      load_tile<2>(dst, u, p, K, rows, c0, D);
    else
      load_tile<1>(dst, u, p, K, rows, c0, D);
  };

  for (int i = 0; i < n_st - 2; ++i) {
    if (i < my) load(i);
    tile_stream::commit();
  }
  for (int i = 0; i <= my; ++i) {
    tile_stream::wait_pending(n_st - 3);  // tile i has landed (this thread's copies)
    __syncthreads();         // everyone's; tile i - 2 and med row i & 1 are free
    if (i + n_st - 2 < my) load(i + n_st - 2);  // into tile i - 2's stage
    tile_stream::commit();

    // tile i: median of coordinate tid (past D: zeros, median 0, adds +0)
    if (i < my) {
      const float* U = ring + (i % n_st) * stage;
      float s[KP];
      bool nan = false;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        s[k] = k < K ? U[k * kRow + tid] : INFINITY;
        nan |= s[k] != s[k];
      }
      odd_even_sort<KP, KS>(s);
      float mlo = 0.f, mhi = 0.f;
      if constexpr (KS > 0) {
        mlo = s[(KS - 1) / 2];
        mhi = s[KS / 2];
      } else {
        const int lo = (K - 1) >> 1, hi = K >> 1;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          if (k == lo) mlo = s[k];
          if (k == hi) mhi = s[k];
        }
      }
      float med = (K & 1) ? mhi : __fmul_rn(0.5f, __fadd_rn(mlo, mhi));
      if (nan) med = __int_as_float(0x7fc00000);
      sMed[(i & 1) * kTile + tid] = med;
      add_term(mn2, med, med);
      if constexpr (kCenter) {
        const long long j = (b + (long long)i * B) * kTile + tid;
        if (j < D) {
          float tsum = 0.f;
#pragma unroll
          for (int k = 0; k < KP; ++k)
            if (k >= a.n_trim && k < K - a.n_trim) tsum = __fadd_rn(tsum, s[k]);
          const float tr = __fdiv_rn(tsum, (float)(K - 2 * a.n_trim));
          a.med[node * D + j] = med;
          a.trim[node * D + j] = nan ? __int_as_float(0x7fc00000) : tr;
        }
      }
    }

    // tile i - 1: per-slot sums; lane i adds the tile's coordinates
    // 4i .. 4i + 3, then 128 + 4i .. 128 + 4i + 3
    if (i >= 1) {
      const float* U = ring + ((i - 1) % n_st) * stage;
      const float* P = U + K * kRow;
      const float* M = sMed + ((i - 1) & 1) * kTile;
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const int c = 128 * q + 4 * lane;
        const float4 m = ld4(M + c);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int k = warp + kWarps * s;
          if (k < K) {
            const float4 x = ld4(U + k * kRow + c);
            add4(acc[s], x, m);
            if (has_prev) add4_prev(acc[s], x, ld4(P + k * kRow + c));
          }
        }
      }
    }
  }

  // ---- this CTA's totals, in a fixed order, to its own row ----------------
  const int F = F_COUNT * K + 1;
  float* row = a.partials + (node * B + b) * (size_t)F;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = warp + kWarps * s;
    if (k < K) {
#pragma unroll
      for (int f = 0; f < F_COUNT; ++f) {
        const float v = warp_sum(acc[s][f]);
        if (lane == 0) row[f * K + k] = v;
      }
    }
  }
  const float m2 = warp_sum(mn2);
  if (lane == 0) red[warp] = m2;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, red[w]);
    row[F_COUNT * K] = t;
  }

  // ---- the node's totals: the last of its B CTAs adds the rows in order ----
  finish_node(a.partials, a.tickets, a.out, node, B, K, F, last);
}

using Kernel = void (*)(const Args);

// the instance for K: specialised (no padding wires) at the K the main paths
// use, padded with +inf to KP in {8, 16, 32} otherwise
template <bool kCenter>
Kernel pick_t(int K) {
  if (K == 8) return stats_kernel<8, 8, kCenter>;
  if (K < 8) return stats_kernel<8, 0, kCenter>;
  if (K == 16) return stats_kernel<16, 16, kCenter>;
  if (K < 16) return stats_kernel<16, 0, kCenter>;
  if (K == 20) return stats_kernel<32, 20, kCenter>;
  if (K == 32) return stats_kernel<32, 32, kCenter>;
  return stats_kernel<32, 0, kCenter>;
}

Kernel pick(int K, bool centers) { return centers ? pick_t<true>(K) : pick_t<false>(K); }

// ---- the wide path (K > 32) ------------------------------------------------

struct WideArgs {
  const float* u;        // (N, K, D)
  const float* prev;     // (N, K, D) or null
  float* med;            // (N, D) or null (centers not wanted)
  float* trim;           // (N, D) or null
  float* partials;       // (N, B, F_COUNT K + 1): each CTA's totals
  unsigned* tickets;     // (N,): 0 on entry, 0 again on exit
  float* out;            // (N, F_COUNT + 1, K): mednorm2 at [n, F_COUNT, 0]
  int K;
  int kp;                // the sort width: K rounded up to a power of two
  long long D;
  int n_trim;
  int tile;              // T coordinates per tile (wide_tile)
};

__host__ int wide_width(int K) {
  int kp = 1;
  while (kp < K) kp <<= 1;
  return kp;
}

__host__ int wide_tile(int K) {
  const size_t kp = (size_t)wide_width(K);
  int t = kWideMaxTile;
  while (t > kWideMinTile && kp * t * sizeof(float) > (size_t)kWideSortBytes) t >>= 1;
  return t;
}

// a column's ranks a thread sorts in registers: KP T = 64 KB / 4 B = 16,384 =
// kWideRun x 256 threads at every K of the wide path
constexpr int kWideRun = 64;
constexpr int kWideLogRun = 6;

// compare-exchange of positions x < y: the smaller value to x when up
__device__ __forceinline__ void cex(float& x, float& y, bool up) {
  const float mn = fminf(x, y), mx = fmaxf(x, y);
  x = up ? mn : mx;
  y = up ? mx : mn;
}

// stages j = 32 .. 1 of bitonic step k on a thread's run of ranks base ..
// base + 63 (every loop unrolled: the run stays in registers)
__device__ __forceinline__ void run_merge(float (&v)[kWideRun], int base, int k) {
#pragma unroll
  for (int lj = kWideLogRun - 1; lj >= 0; --lj)
#pragma unroll
    for (int e = 0; e < kWideRun; ++e)
      if ((e & (1 << lj)) == 0) cex(v[e], v[e + (1 << lj)], ((base + e) & k) == 0);
}

// threads per candidate in the sums: G, the largest power of two with
// G K <= 256 (4 at K <= 64, 2 to 128, 1 above)
__host__ __device__ int wide_group(int K) {
  int g = 1;
  while (2 * g * K <= kThreads) g *= 2;
  return g;
}

// the sort buffer (KP, T), the med row (T) and the NaN flags (T)
__host__ size_t wide_smem_bytes(int K) {
  const int t = wide_tile(K);
  return ((size_t)wide_width(K) * t + t) * sizeof(float) + (size_t)t * sizeof(int);
}

constexpr int kWideSlots = (kWideMaxK + kThreads - 1) / kThreads;  // candidates a thread, at most

template <bool kCenter>
__global__ void __launch_bounds__(kThreads, 1) wide_stats_kernel(const WideArgs a) {
  extern __shared__ float4 smem4[];
  float* srt = reinterpret_cast<float*>(smem4);  // (KP, T), rank-major
  const int K = a.K, KP = a.kp, T = a.tile;
  float* sMed = srt + (size_t)KP * T;            // (T,)
  int* sNan = reinterpret_cast<int*>(sMed + T);  // (T,)
  __shared__ float red[kWarps];
  __shared__ bool last;

  const long long D = a.D;
  const bool has_prev = a.prev != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t node = blockIdx.y;
  const int b = blockIdx.x, B = gridDim.x;
  const float* u = a.u + node * K * (size_t)D;
  const float* p = has_prev ? a.prev + node * K * (size_t)D : nullptr;
  const long long n_tiles = (D + T - 1) / T;
  const int my = b < n_tiles ? (int)((n_tiles - 1 - b) / B + 1) : 0;
  // the sort: thread (column col, run s) holds ranks base .. base + 63 of
  // column col; KP / 64 = 256 / T runs a column
  const int col = tid & (T - 1), base = (tid / T) * kWideRun;
  // the sums: thread (slot base tid / G, group g) owns candidates tid / G +
  // s 256 / G and adds columns g, g + G, ... of every tile
  const int G = wide_group(K), g = tid & (G - 1), k0 = tid / G, kstep = kThreads / G;

  float acc[kWideSlots][F_COUNT];
#pragma unroll
  for (int q = 0; q < kWideSlots; ++q)
#pragma unroll
    for (int f = 0; f < F_COUNT; ++f) acc[q][f] = 0.f;
  if (tid < T) sNan[tid] = 0;
  float mn2 = 0.f;

  for (int i = 0; i < my; ++i) {
    const long long c0 = (b + (long long)i * B) * T;
    const bool in = c0 + col < D;
    __syncthreads();  // the last tile's sums have read sMed; the buffer is free
    // this thread's run of column col: rows base .. base + 63 (past K +inf,
    // past D zeros: median 0, adds +0), loaded straight into registers
    float v[kWideRun];
    bool nan = false;
#pragma unroll
    for (int e = 0; e < kWideRun; ++e) {
      const int r = base + e;
      v[e] = r < K ? (in ? __ldg(u + (size_t)r * D + c0 + col) : 0.f) : INFINITY;
      nan |= v[e] != v[e];
    }
    if (nan) sNan[col] = 1;
    // every column sorted ascending by the bitonic network: steps k <= 64
    // inside each run, in registers; above, the stages j >= 64 pair a run
    // with another (through shared memory) and the rest run in registers
#pragma unroll
    for (int lk = 1; lk <= kWideLogRun; ++lk)
#pragma unroll
      for (int lj = lk - 1; lj >= 0; --lj)
#pragma unroll
        for (int e = 0; e < kWideRun; ++e)
          if ((e & (1 << lj)) == 0)
            cex(v[e], v[e + (1 << lj)], ((base + e) & (1 << lk)) == 0);
    for (int k = 2 * kWideRun; k <= KP; k <<= 1) {
      const bool up = (base & k) == 0;
      for (int j = k >> 1; j >= kWideRun; j >>= 1) {
#pragma unroll
        for (int e = 0; e < kWideRun; ++e) srt[(base + e) * T + col] = v[e];
        __syncthreads();
        const bool lower = (base & j) == 0;  // this run holds the pairs' lower ranks
#pragma unroll
        for (int e = 0; e < kWideRun; ++e) {
          const float w = srt[((base ^ j) + e) * T + col];
          v[e] = lower == up ? fminf(v[e], w) : fmaxf(v[e], w);
        }
        __syncthreads();
      }
      run_merge(v, base, k);
    }
#pragma unroll
    for (int e = 0; e < kWideRun; ++e) srt[(base + e) * T + col] = v[e];
    __syncthreads();
    // column tid: the median, its mednorm2 term, the trimmed sum in rank order
    if (tid < T) {
      const bool bad = sNan[tid] != 0;
      sNan[tid] = 0;  // no one reads it again before the next tile's loads
      const float mlo = srt[((K - 1) >> 1) * T + tid], mhi = srt[(K >> 1) * T + tid];
      float med = (K & 1) ? mhi : __fmul_rn(0.5f, __fadd_rn(mlo, mhi));
      if (bad) med = __int_as_float(0x7fc00000);
      sMed[tid] = med;
      add_term(mn2, med, med);
      if constexpr (kCenter) {
        const long long j = c0 + tid;
        if (j < D) {
          // up to 1,024 ranks: summed in double, so the trimmed mean stays
          // within a float32 rounding of the exact one
          double tsum = 0.0;
          for (int r = a.n_trim; r < K - a.n_trim; ++r) tsum += (double)srt[r * T + tid];
          const float tr = (float)(tsum / (double)(K - 2 * a.n_trim));
          a.med[node * D + j] = med;
          a.trim[node * D + j] = bad ? __int_as_float(0x7fc00000) : tr;
        }
      }
    }
    __syncthreads();
    // the tile's sums: each owned candidate's columns g, g + G, ... in order,
    // read from global memory again (mostly from L2), eight loads in flight
    // (T / G is a multiple of 8: 16 at K = 1,024, 32 or 64 below)
#pragma unroll
    for (int q = 0; q < kWideSlots; ++q) {
      const int k = k0 + q * kstep;
      if (k >= K) continue;
      const float* x_row = u + (size_t)k * D + c0;
      const float* p_row = has_prev ? p + (size_t)k * D + c0 : nullptr;
      for (int c = g; c < T; c += 8 * G) {
        float xs[8], ps[8];
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const int cc = c + h * G;
          const bool inc = c0 + cc < D;
          xs[h] = inc ? __ldg(x_row + cc) : 0.f;
          ps[h] = inc && has_prev ? __ldg(p_row + cc) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const float x = xs[h], m = sMed[c + h * G];
          const float dd = __fsub_rn(x, m);
          add_term(acc[q][F_D2], dd, dd);
          add_term(acc[q][F_DM], x, m);
          add_term(acc[q][F_N2], x, x);
          if (has_prev) {
            const float pv = ps[h];
            const float dp = __fsub_rn(x, pv);
            add_term(acc[q][F_PD2], dp, dp);
            add_term(acc[q][F_PDT], x, pv);
            add_term(acc[q][F_PN2], pv, pv);
          }
        }
      }
    }
  }

  // ---- this CTA's totals, in a fixed order, to its own row ----------------
  // a candidate's G groups by an xor butterfly over their G neighbouring lanes
  const int F = F_COUNT * K + 1;
  float* row = a.partials + (node * B + b) * (size_t)F;
#pragma unroll
  for (int q = 0; q < kWideSlots; ++q) {
    const int k = k0 + q * kstep;
#pragma unroll
    for (int f = 0; f < F_COUNT; ++f) {
      float v = acc[q][f];
      for (int o = G >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
      if (g == 0 && k < K) row[f * K + k] = v;
    }
  }
  const float m2 = warp_sum(mn2);
  if (lane == 0) red[warp] = m2;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, red[w]);
    row[F_COUNT * K] = t;
  }
  finish_node(a.partials, a.tickets, a.out, node, B, K, F, last);
}

using WideKernel = void (*)(const WideArgs);

WideKernel pick_wide(bool centers) {
  return centers ? wide_stats_kernel<true> : wide_stats_kernel<false>;
}

// stages of the ring: enough to keep kInFlightBytes of tiles in flight (a
// tile is read while stages - 2 are in flight), within kMaxSmemBytes
int plan_stages(int K, bool has_prev) {
  const int stage_bytes = (has_prev ? 2 : 1) * K * kRow * (int)sizeof(float);
  int s = 2 + (kInFlightBytes + stage_bytes - 1) / stage_bytes;
  s = s < kMaxStages ? s : kMaxStages;
  while (s > kMinStages && s * stage_bytes + 2 * kTile * (int)sizeof(float) > kMaxSmemBytes)
    --s;
  return s < kMinStages ? kMinStages : s;
}

size_t smem_bytes(int K, bool has_prev, int stages) {
  return ((size_t)stages * (has_prev ? 2 : 1) * K * kRow + 2 * kTile) * sizeof(float);
}

bool valid_shape(int K, int N) { return K >= 1 && K <= kWideMaxK && N >= 1 && N <= 65535; }

int launch_wide(const WideArgs& w, bool centers, int N, int n_blocks, cudaStream_t stream) {
  const WideKernel kernel = pick_wide(centers);
  const size_t smem = wide_smem_bytes(w.K);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(n_blocks, N), kThreads, smem, stream>>>(w);
  return (int)cudaGetLastError();
}

int launch_any(const float* u, const float* prev, float* med, float* trim, float* partials,
               unsigned* tickets, float* out, int N, int K, long long D, int n_trim,
               int n_blocks, void* stream) {
  if (!valid_shape(K, N) || D <= 0 || n_blocks <= 0 || n_trim < 0 || K - 2 * n_trim < 1 ||
      (med == nullptr) != (trim == nullptr) || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  if (K > kNetworkMaxK)
    return launch_wide(WideArgs{u, prev, med, trim, partials, tickets, out, K, wide_width(K), D,
                                n_trim, wide_tile(K)},
                       med != nullptr, N, n_blocks, (cudaStream_t)stream);
  const bool has_prev = prev != nullptr;
  Args a{u, prev, med, trim, partials, tickets, out, K, D, n_trim,
         plan_stages(K, has_prev), tile_stream::copy_width(D, {u, prev})};
  const Kernel kernel = pick(K, med != nullptr);
  const size_t smem = smem_bytes(K, has_prev, a.stages);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(n_blocks, N), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launch entry launches one
// kernel on `stream`, does not synchronise, allocates nothing, and returns
// the cudaError_t of its launch.  med / trim are null unless the centers are
// wanted; prev may be null.  tickets is a zeroed (N,) uint32 buffer the
// kernel leaves zeroed; partials holds each CTA's totals.
//
// K <= 1024 (K > 32 on the wide path).  One matrix u (K, D), prev (K, D);
// med / trim (D,); partials is
// (n_blocks, 6K+1); out is (7, K): rows dist2, dotmed, norm2, prev_dist2,
// prev_dot, prev_norm2 (0 without prev), then mednorm2 and K - 1 zeros.
extern "C" int robust_stats_launch(const float* u, const float* prev, float* med,
                                   float* trim, float* partials, unsigned* tickets,
                                   float* out, int K, long long D, int n_trim, int n_blocks,
                                   void* stream) {
  return launch_any(u, prev, med, trim, partials, tickets, out, 1, K, D, n_trim, n_blocks,
                    stream);
}

// A gathered tensor u (N, K, D), prev (N, K, D); med / trim (N, D); partials
// is (N, n_blocks, 6K+1), out is (N, 7, K) in the same layout; n_blocks
// CTAs per node.
extern "C" int robust_stats_batch_launch(const float* u, const float* prev, float* med,
                                         float* trim, float* partials, unsigned* tickets,
                                         float* out, int N, int K, long long D, int n_trim,
                                         int n_blocks, void* stream) {
  return launch_any(u, prev, med, trim, partials, tickets, out, N, K, D, n_trim, n_blocks,
                    stream);
}

// The launch plan for K candidates on the current device, launching
// nothing: plan[0] the ring's stages (1 on the wide path: no ring),
// plan[1] the tile width in coordinates, plan[2] the CTAs one SM holds at
// once (the occupancy of the instance the launch would take), plan[3] the
// network's template width (the wide path's sort width), plan[4] 1 where
// the instance is specialised on K (no padding wires) and plan[5] 1 on the
// wide path (K > 32).
extern "C" int robust_stats_plan(int K, int has_prev, int need_center, int* plan) {
  if (!valid_shape(K, 1)) return (int)cudaErrorInvalidValue;
  const bool wide = K > kNetworkMaxK;
  const int stages = wide ? 1 : plan_stages(K, has_prev != 0);
  const void* kernel = wide ? (const void*)pick_wide(need_center != 0)
                            : (const void*)pick(K, need_center != 0);
  const size_t smem = wide ? wide_smem_bytes(K) : smem_bytes(K, has_prev != 0, stages);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  plan[0] = stages;
  plan[1] = wide ? wide_tile(K) : kTile;
  plan[2] = per_sm;
  plan[3] = wide ? wide_width(K) : K <= 8 ? 8 : K <= 16 ? 16 : 32;
  plan[4] = !wide && (K == 8 || K == 16 || K == 20 || K == 32);
  plan[5] = wide;
  return 0;
}
