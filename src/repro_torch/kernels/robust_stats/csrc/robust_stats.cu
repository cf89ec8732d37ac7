// Robust statistics of (K, D) candidate matrices, for Hopper (sm_90a): one
// matrix (kernel 4) or a gathered (N, K, D) tensor, one matrix per node
// (kernel 5).
//
// Replaces the Pallas TPU kernel _robust_stats_kernel
// (src/repro/kernels/robust_stats/kernel.py:70) in both of its launches:
// d_axis=0 by robust_stats_pallas (kernel.py:136, the single-node wfagg()
// and the CFL server) and d_axis=1 by robust_stats_batch_pallas
// (kernel.py:652, the gathered wfagg_batch).  For node n's candidates
// u_k (k < K <= 32) and, optionally, their previous-round rows p_k (a
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
// Design:
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
// copies are issued by every thread (no TMA, no producer warp).  K > 32 is
// refused: the network takes any power-of-two width KP, but a stage of 2 x
// 64 rows of 256 coordinates (133 KB) would need a narrower tile.
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

// cp.async.wait_group takes an immediate: all but the newest n groups landed
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: tile_stream::wait<0>(); break;
    case 1: tile_stream::wait<1>(); break;
    case 2: tile_stream::wait<2>(); break;
    default: tile_stream::wait<3>(); break;
  }
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
    wait_pending(n_st - 3);  // tile i has landed (this thread's copies)
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
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + node, 1u) == (unsigned)(B - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* rows0 = a.partials + node * B * (size_t)F;
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
    a.out[node * n_out + q] = t;
  }
  if (tid == 0) a.tickets[node] = 0u;
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

bool valid_shape(int K, int N) { return K >= 1 && K <= 32 && N >= 1 && N <= 65535; }

int launch_any(const float* u, const float* prev, float* med, float* trim, float* partials,
               unsigned* tickets, float* out, int N, int K, long long D, int n_trim,
               int n_blocks, void* stream) {
  if (!valid_shape(K, N) || D <= 0 || n_blocks <= 0 || n_trim < 0 || K - 2 * n_trim < 1 ||
      (med == nullptr) != (trim == nullptr) || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
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
// One matrix u (K, D), prev (K, D); med / trim (D,); partials is
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
// nothing: plan[0] the ring's stages, plan[1] the tile width in
// coordinates, plan[2] the CTAs one SM holds at once (the occupancy of the
// instance the launch would take), plan[3] the network's template width and
// plan[4] 1 where the instance is specialised on K (no padding wires).
extern "C" int robust_stats_plan(int K, int has_prev, int need_center, int* plan) {
  if (!valid_shape(K, 1)) return (int)cudaErrorInvalidValue;
  const int stages = plan_stages(K, has_prev != 0);
  const Kernel kernel = pick(K, need_center != 0);
  const size_t smem = smem_bytes(K, has_prev != 0, stages);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  plan[0] = stages;
  plan[1] = kTile;
  plan[2] = per_sm;
  plan[3] = K <= 8 ? 8 : K <= 16 ? 16 : 32;
  plan[4] = K == 8 || K == 16 || K == 20 || K == 32;
  return 0;
}
