// Gather-free WFAgg-E combine of a gossip round, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _weighted_agg_indexed_kernel
// (src/repro/kernels/weighted_agg/kernel.py:30), launched by
// weighted_agg_indexed_pallas (kernel.py:56), the combine launch of the
// two-launch backend:
//   out[n] = lcoef[n] * local[n] + sum_k wvec[n, k] * models[idx[n, k]]
// with wvec = eff_alpha * w_norm (N, K) and lcoef = 1 - eff_alpha (N,) left
// on the device by the wrapper (core/trust.py combine_coefficients) and read
// here through pointers, so the host never waits for them.  The rows are
// read through the index table: the (N, K, D) gossip tensor never exists.
//
// Exact order: every output coordinate is round(lcoef * local), then, for
// k = 0 .. K-1 in slot order, plus round(wvec[n, k] * row_k), each step
// rounded (__fmul_rn / __fadd_rn, no fused multiply-add).  That is what
// weighted_agg_indexed_plain (ops.py) computes op for op, so the kernel
// equals it bit for bit.  No slot is skipped: a zero weight times a NaN row
// is NaN, as in the reference; with all-zero weights lcoef = 1 and every
// term adds +0, so out = local (finite rows).
//
// Bound on this card: bytes.  The function must read each distinct row the
// table reaches once (R <= M rows), read local and write out: 4 (R + 2N) D
// bytes at 3.35 TB/s (0.2404 ms at N = 64, K = 16, d = 2^20 on a ring, R =
// 64), against 2 N K D flops (0.03 ms at 67 TFLOP/s).
//
// Design:
//   * Grid (B, groups).  A group is G consecutive nodes (nodes g G .. g G +
//     G - 1, the last group possibly shorter); its B CTAs split the D-tiles
//     of T = 32, 64 or 128 coordinates, CTA b taking tiles b, b + B, ...
//     G, T and the ring's stages come from kernel.combine_plan (from M, N
//     and K: G = N wherever min(M, N K) + N rows of a stage fit), B from
//     this instance's occupancy.
//   * Set-up, once per CTA: the group's G K table entries and its G local
//     rows are keys (key r < M: models row r; key M + n: local row n; key n
//     when local is models itself).  An open-addressing hash in shared
//     memory (aliased on the ring) finds the distinct keys and numbers
//     them; each distinct row is one staged row, and every slot keeps its
//     weight and staged row as one (float, int) pair.  Which staged row a
//     key gets follows the order of the atomics and changes nothing: each
//     output coordinate adds the same values in slot order.
//   * A cp.async ring (kernels/csrc/tile_stream.cuh) of `stages` tiles of
//     the staged rows: copies of 16 bytes where D % 4 == 0 and local,
//     models and out are 16-byte aligned, else 8 or 4 (the paper's d =
//     44,426 has D % 4 = 2; nothing is padded in device memory), zero-filled
//     past D; stages - 1 tiles in flight while one is read, one barrier per
//     tile.  A row tile that 16 nodes read crosses L2 -> SM once per CTA,
//     not once per node.
//   * The sums: 1024 threads a CTA (32 warps: with 8 or 16 the sums waited
//     on shared-memory latency, and reads kept in L2 took as long); a warp
//     combines P = 4 / (T / 32) nodes at once, so a lane carries four
//     independent sums at every tile width, and lane l owns coordinates
//     l T/32 .. (l + 1) T/32 - 1 of the tile.  Two slots' (weight, row)
//     pairs are one broadcast 16-byte shared read, a row's values one
//     conflict-free vector read; the output goes straight to device memory
//     in vectors of the copy width.
//   * Any K up to 1,024.  Where even one node's distinct rows (min(M, K) + 1)
//     do not fit three stages of the narrowest tile (K above ~600 over as
//     many rows), the direct route takes over: grid (B, N), each CTA one
//     node's share of D in vectors of the copy width, its K weights and row
//     pointers in shared memory, the rows read from device memory in slot
//     order (nothing to share when a group is one node).  The same order of
//     operations: bit for bit the plain version too.
// What it leaves on the table: the sums (shared memory carries every (node,
// slot) value once, 4 N K D bytes) overlap the copies and the stores, but
// not wholly; every CTA of a group repeats the set-up (G (K + 1) keys).  No
// TMA multicast across a cluster: each tile is read by one CTA only, so
// there is nothing to share.
//
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kDirectThreads = 256;    // the direct route's CTA
constexpr int kMaxSmemBytes = 232448;  // 227 KB, what one CTA may use
constexpr int kEmpty = -1;

struct Args {
  const float* wvec;    // (N, K)
  const float* lcoef;   // (N,)
  const float* local;   // (N, D)
  const float* models;  // (M, D)
  const int32_t* idx;   // (N, K) rows of models
  float* out;           // (N, D)
  int N, K, M;
  long long D;
  int group;            // G nodes per group
  int rows;             // staged rows a stage holds: min(M, G K) + G
  int stages;           // tiles in the ring
  int vec;              // copy width in floats (tile_stream::copy_width)
  bool alias;           // local is models: local row n is key n
};

// smallest power of two >= 2 rows, the hash's slots
__device__ __forceinline__ int hash_slots(int rows) {
  int h = 2;
  while (h < 2 * rows) h *= 2;
  return h;
}

__device__ __forceinline__ int ilog2(int x) {
  int l = 0;
  while ((1 << (l + 1)) <= x) ++l;
  return l;
}

// (weight, row) pairs a node keeps: its K slots and its local row, rounded
// up to an even count so that slots k, k + 1 (k even) are one 16-byte read
__host__ __device__ inline int meta_pairs(int K) { return (K + 2) & ~1; }

// TV consecutive floats of a shared row
template <int TV>
__device__ __forceinline__ void lds(float (&x)[TV], const float* p) {
  if constexpr (TV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (TV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// one tile (coordinates c0 .. c0 + T - 1) of the R staged rows into the
// stage at shared address dst; copy q of the tile is row q / (T / VEC),
// column VEC (q % (T / VEC)).  With D % VEC == 0 a copy is all inside a row
// or all past its end.
template <int T, int VEC>
__device__ __forceinline__ void load_tile(uint32_t dst, const Args& a, const int* keys,
                                          int R, long long c0) {
  constexpr int CPR = T / VEC;  // copies per row
  for (int q = threadIdx.x; q < R * CPR; q += kThreads) {
    const int r = q / CPR, col = (q % CPR) * VEC;
    const int key = keys[r];
    const float* row = key < a.M ? a.models + (size_t)key * a.D
                                 : a.local + (size_t)(key - a.M) * a.D;
    const bool in = c0 + col < a.D;
    tile_stream::cp_async<VEC>(dst + 4u * (uint32_t)(r * T + col), row + (in ? c0 + col : 0),
                               in);
  }
}

template <int TV, int VEC>
__global__ void __launch_bounds__(kThreads)
combine_indexed_kernel(const Args a) {
  constexpr int T = 32 * TV;          // coordinates per tile
  constexpr int SV = TV < VEC ? TV : VEC;  // store width
  constexpr int P = 4 / TV;           // nodes a warp combines at once
  extern __shared__ float4 smem4[];

  const int K = a.K, S = a.stages, rows = a.rows;
  const long long D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * a.group;
  const int g = min(a.group, a.N - n0);
  const int E = g * (K + 1);          // keys: K slots and the local row per node

  float* ring = reinterpret_cast<float*>(smem4);
  const int pairs = meta_pairs(K);
  float2* meta = reinterpret_cast<float2*>(ring + (size_t)S * rows * T);  // G pairs
  int* keys = reinterpret_cast<int*>(meta + (size_t)a.group * pairs);     // rows
  int* n_rows = keys + rows;          // the staged rows counted so far
  int* meta_i = reinterpret_cast<int*>(meta);

  // ---- set-up: the group's distinct rows ----------------------------------
  const int H = hash_slots(rows), shift = 32 - ilog2(H);
  int* hkey = reinterpret_cast<int*>(ring);   // H keys, then H staged rows
  int* hrow = hkey + H;
  for (int h = tid; h < H; h += kThreads) hkey[h] = kEmpty;
  if (tid == 0) *n_rows = 0;
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int j = e / (K + 1), s = e - j * (K + 1), n = n0 + j;
    const int key = s < K ? a.idx[(size_t)n * K + s] : (a.alias ? n : a.M + n);
    unsigned h = ((unsigned)key * 2654435761u) >> shift;
    for (;;) {
      const int was = atomicCAS(hkey + h, kEmpty, key);
      if (was == kEmpty || was == key) break;
      h = (h + 1) & (H - 1);
    }
    meta_i[2 * (j * pairs + s) + 1] = (int)h;   // the key's hash slot, for now
  }
  __syncthreads();
  for (int h = tid; h < H; h += kThreads) {
    const int key = hkey[h];
    if (key != kEmpty) {
      const int r = atomicAdd(n_rows, 1);
      hrow[h] = r;
      keys[r] = key;
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int j = e / (K + 1), s = e - j * (K + 1), n = n0 + j;
    const float coef = s < K ? a.wvec[(size_t)n * K + s] : a.lcoef[n];
    float2& m = meta[j * pairs + s];
    m = make_float2(coef, __int_as_float(hrow[__float_as_int(m.y)] * T));
  }
  __syncthreads();                     // the hash is dead: the ring is free
  const int R = *n_rows;

  // ---- the ring over this CTA's tiles --------------------------------------
  const int B = gridDim.x, b = blockIdx.x;
  const long long n_tiles = (D + T - 1) / T;
  const int my = b < n_tiles ? (int)((n_tiles - 1 - b) / B + 1) : 0;
  const int stage = rows * T;
  const uint32_t ring_at = tile_stream::shared_address(ring);
  auto load = [&](int i) {
    const uint32_t dst = ring_at + 4u * (uint32_t)((i % S) * stage);
    load_tile<T, VEC>(dst, a, keys, R, (b + (long long)i * B) * T);
  };
  for (int i = 0; i < S - 1; ++i) {
    if (i < my) load(i);
    tile_stream::commit();
  }
  const int col = lane * TV;
  for (int i = 0; i < my; ++i) {
    tile_stream::wait_pending(S - 2);  // tile i has landed (this thread's copies)
    __syncthreads();       // everyone's; and tile i - 1's stage is free
    if (i + S - 1 < my) load(i + S - 1);
    tile_stream::commit();

    const float* st = ring + (i % S) * stage + col;
    const long long c = (b + (long long)i * B) * T + col;
    for (int j0 = warp * P; j0 < g; j0 += kWarps * P) {
      const float4* m[P];
      float x[TV], r[P][TV];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        m[p] = reinterpret_cast<const float4*>(meta + (j0 + p < g ? j0 + p : j0) * pairs);
        const float2 lm = reinterpret_cast<const float2*>(m[p])[K];
        lds<TV>(x, st + __float_as_int(lm.y));
#pragma unroll
        for (int t = 0; t < TV; ++t) r[p][t] = __fmul_rn(lm.x, x[t]);
      }
#pragma unroll 2
      for (int k = 0; k < K; k += 2) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 mk = m[p][k / 2];     // slots k and k + 1
          lds<TV>(x, st + __float_as_int(mk.y));
#pragma unroll
          for (int t = 0; t < TV; ++t) r[p][t] = __fadd_rn(r[p][t], __fmul_rn(mk.x, x[t]));
          if (k + 1 < K) {
            lds<TV>(x, st + __float_as_int(mk.w));
#pragma unroll
            for (int t = 0; t < TV; ++t) r[p][t] = __fadd_rn(r[p][t], __fmul_rn(mk.z, x[t]));
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (j0 + p >= g) break;
        float* o = a.out + (size_t)(n0 + j0 + p) * D + c;
#pragma unroll
        for (int v = 0; v < TV; v += SV) {
          if (c + v < D) {
            float y[SV];
#pragma unroll
            for (int t = 0; t < SV; ++t) y[t] = r[p][v + t];
            tile_stream::store_vec<SV>(o + v, y);
          }
        }
      }
    }
  }
}

// The direct route: node blockIdx.y's out over vectors blockIdx.x, blockIdx.x
// + B, ... of VEC coordinates a thread, in slot order from device memory.
template <int VEC>
__global__ void __launch_bounds__(kDirectThreads)
combine_direct_kernel(const Args a) {
  __shared__ float sw[kMaxK];
  __shared__ const float* srow[kMaxK];
  const int K = a.K, n = blockIdx.y, tid = threadIdx.x;
  const long long D = a.D;
  for (int k = tid; k < K; k += kDirectThreads) {
    sw[k] = a.wvec[(size_t)n * K + k];
    srow[k] = a.models + (size_t)a.idx[(size_t)n * K + k] * D;
  }
  const float lc = a.lcoef[n];
  __syncthreads();
  const float* loc = a.local + (size_t)n * D;
  float* o = a.out + (size_t)n * D;
  const long long step = (long long)gridDim.x * kDirectThreads * VEC;
  // D % VEC == 0: a vector is all in or all out
  for (long long j = ((long long)blockIdx.x * kDirectThreads + tid) * VEC; j < D; j += step) {
    float r[VEC], x[VEC];
    tile_stream::load_vec<VEC>(r, loc + j);
#pragma unroll
    for (int t = 0; t < VEC; ++t) r[t] = __fmul_rn(lc, r[t]);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      tile_stream::load_vec<VEC>(x, srow[k] + j);
      const float w = sw[k];
#pragma unroll
      for (int t = 0; t < VEC; ++t) r[t] = __fadd_rn(r[t], __fmul_rn(w, x[t]));
    }
    tile_stream::store_vec<VEC>(o + j, r);
  }
}

using Kernel = void (*)(const Args);

Kernel pick_direct(int vec) {
  return vec == 4 ? combine_direct_kernel<4>
                  : vec == 2 ? combine_direct_kernel<2> : combine_direct_kernel<1>;
}

template <int TV>
Kernel pick_vec(int vec) {
  return vec == 4 ? combine_indexed_kernel<TV, 4>
                  : vec == 2 ? combine_indexed_kernel<TV, 2> : combine_indexed_kernel<TV, 1>;
}

Kernel pick(int tile, int vec) {
  return tile == 128 ? pick_vec<4>(vec) : tile == 64 ? pick_vec<2>(vec) : pick_vec<1>(vec);
}

// the layout of shared memory: the ring, the (weight, row) pairs, the staged
// rows' keys and their counter.  kernel.combine_plan chooses group, tile and
// stages against the same sum (kernel._smem_bytes); here it only sizes the
// launch and keeps it inside what one CTA may use.
size_t smem_bytes(int rows, int group, int K, int tile, int stages) {
  return (size_t)stages * rows * tile * sizeof(float) + (size_t)group * meta_pairs(K) * 8 +
         (size_t)(rows + 1) * sizeof(int);
}

// what the kernel itself needs of a plan: an instance for the tile, a ring
// of at least two stages, groups on the grid's y axis; tile 0 is the direct
// route (one node a group)
bool launchable(int N, int K, int M, int group, int tile, int stages) {
  const bool shape = N >= 1 && N <= 65535 && K >= 1 && K <= kMaxK && M >= 1 &&
                     (long long)M + N < 0x7fffffffLL;
  if (tile == 0) return shape && group == 1;
  return shape && group >= 1 && group <= N && (tile == 32 || tile == 64 || tile == 128) &&
         stages >= 2;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one kernel on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch.  idx holds rows of models; group, tile and stages are
// kernel.combine_plan's (tile 0: the direct route, n_blocks CTAs a node),
// n_blocks the CTAs per group.  Any alignment of the float rows is taken (the
// copy width follows it).
extern "C" int weighted_agg_indexed_launch(const float* wvec, const float* lcoef,
                                           const float* local, const float* models,
                                           const int32_t* idx, float* out, int N, int K,
                                           int M, long long D, int group, int tile,
                                           int stages, int n_blocks, void* stream) {
  if (!launchable(N, K, M, group, tile, stages) || D <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (tile == 0) {
    const Args a{wvec, lcoef, local, models, idx, out, N, K, M, D, 1, 0, 0,
                 tile_stream::copy_width(D, {local, models, out}), false};
    pick_direct(a.vec)<<<dim3(n_blocks, N), kDirectThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int rows = (M < group * K ? M : group * K) + group;
  const size_t smem = smem_bytes(rows, group, K, tile, stages);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const Args a{wvec, lcoef, local, models, idx, out, N, K, M, D, group, rows, stages,
               tile_stream::copy_width(D, {local, models, out}),
               local == models && N <= M};
  const Kernel kernel = pick(tile, a.vec);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (N + group - 1) / group;
  kernel<<<dim3(n_blocks, groups), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The CTAs one SM holds at once of the instance for this tile (16-byte
// copies) at `smem` bytes of dynamic shared memory (tile 0: the direct
// route's, smem ignored); launches nothing.
extern "C" int weighted_agg_indexed_occupancy(int tile, int smem, int* per_sm) {
  if (tile == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pick_direct(4),
                                                              kDirectThreads, 0);
  if ((tile != 32 && tile != 64 && tile != 128) || smem <= 0 || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick(tile, 4);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}
