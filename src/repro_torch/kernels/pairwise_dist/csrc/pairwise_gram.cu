// Pairwise Gram of one (K, D) candidate matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pairwise_kernel
// (src/repro/kernels/pairwise_dist/kernel.py:17), launched by pairwise_pallas
// (kernel.py:29).  For candidates u_k (k < K <= 1024) it computes
//   gram[i][j] = sum_d u_i[d] * u_j[d]    (K, K), exactly symmetric
//   norm2[k]   = gram[k][k]               (K,)
// which Krum / Multi-Krum (squared distances by the Gram expansion) and
// Clustering (cosine distances) read.
//
// Bound on this card: bytes at K <= 32.  It must read the matrix once,
// 4*K*D bytes at 3.35 TB/s (0.160 ms at K = 32, D = 2^22); its K*(K+1)/2
// multiply-adds per coordinate stay under that time at 67 TFLOP/s float32
// for K <= 32.  At K = 1,024 and D = 50,890 they are 5.34e10 flops, 0.80 ms,
// against 0.062 ms of bytes: operations.  No tensor cores: the reference is
// float32, TF32 stays off, and a split product would break the tie invariant
// below.
//
// Two paths: K <= 32 (the register-blocked stream) and K > 32 (output
// tiles, after it).
//
// Design at K <= 32: a register-blocked stream.
//   * Rows are padded to Kp = 4*ceil(K/4) and cut into Kp/4 blocks of four;
//     a block pair (bi <= bj) is 16 Gram entries (36 pairs at K = 32).
//   * A tile is kTile = 256 coordinates of all K rows, loaded with cp.async
//     into a double-buffered shared tile (row-major, Kp x kTile floats per
//     stage; rows K .. Kp-1 are zero), so the next tile is in flight while
//     this one is reduced.  Loads are 16 bytes a thread when D % 4 == 0 and
//     the matrix is 16-byte aligned; otherwise 8 or 4 bytes (the paper's
//     d = 44,426 has D % 4 = 2), inside the kernel: nothing is padded.
//     Coordinates past D are zero-filled through cp.async's src-size
//     (kernels/csrc/tile_stream.cuh, shared with kernels 1 and 2).
//   * Thread (bp, s) of a CTA of 8 * (block pairs) threads owns block pair
//     bp and slice s < 8 of each tile: the float4 groups s, s + 8, ...,
//     s + 56.  Per group it reads its eight rows as float4 (the eight
//     slices of one block pair are eight neighbouring lanes reading 128
//     contiguous bytes of a row: no bank conflict) and does 64 fmaf into a
//     4 x 4 register block: 8 vector loads per 64 FMAs.  CTAs walk tiles in a
//     grid-stride loop, 2 CTAs per SM.
//   * The tie invariant.  Bit-identical rows a, b must give bit-identical
//     Gram rows and G[a,a] == G[a,b] == G[b,b]: Multi-Krum's exact-zero
//     distances (core/trust.py sq_dists_from_gram) and Clustering's index
//     tie-breaks rely on it.  So every entry is the same expression tree:
//     the same coordinates per slice in the same order (one fmaf chain per
//     entry); the eight slices added by the same xor-shuffle tree (4, 2, 1;
//     a + b == b + a, so both lanes of a step hold the same sum); the CTAs'
//     sums added in block order by a second, one-CTA launch.  No atomics.
//     Only i <= j is summed; the finish writes it to (i, j) and (j, i).
//
// Design at K > 32: the upper triangle in output tiles (a simple kernel that
// is right, not yet a fast one).
//   * The Gram is cut into 64 x 64 tiles; a CTA of 256 threads takes one tile
//     pair (bi <= bj) of the row-major upper triangle and one of S splits of
//     D (grid: pairs x S, S the card's resident CTAs over the pairs, rounded
//     down to one wave, so the partials are S K^2 floats: 12.6 MB at K =
//     1,024, not one row of K^2 per CTA of a grid-stride stream).
//   * Per step, 16 coordinates of the tile's 64 rows of each side go through
//     registers (plain loads: any alignment; rows past K and coordinates past
//     D are 0) into a double-buffered shared tile, coordinate-major, and
//     thread (ty, tx) adds rows 4 ty .. 4 ty + 3 times rows 4 tx .. 4 tx + 3
//     by fmaf into a 4 x 4 register block: 16 fmaf per two float4 reads.
//   * The tie invariant holds as above: every entry is one fmaf chain over
//     its split's coordinates in order, whatever its tile, then the S splits'
//     sums in split order by a second launch that writes (i, j) and (j, i).
//     The diagonal tiles compute their lower half too and drop it.
//
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr int kMaxK = 32;                   // the register-blocked stream's K
constexpr int kWideMaxK = 1024;             // the tiled path's
constexpr int kTile = 256;                  // coordinates per tile
constexpr int kSlices = 8;                  // threads per block pair
constexpr int kGroups = kTile / 4 / kSlices;  // float4 groups per slice per tile
constexpr int kMaxBlockPairs = (kMaxK / 4) * (kMaxK / 4 + 1) / 2;
constexpr int kMaxThreads = kMaxBlockPairs * kSlices;  // 288
constexpr int kFinishThreads = 1024;

// pair p of the row-major upper triangle (i <= j) of an n x n matrix
__device__ __forceinline__ void pair_of(int p, int n, int& i, int& j) {
  i = 0;
  while (p >= n - i) {
    p -= n - i;
    ++i;
  }
  j = i + p;
}

using tile_stream::cp_async;

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gram_partials_kernel(const float* __restrict__ u, float* __restrict__ partials, int K,
                     long long D) {
  extern __shared__ __align__(16) float sU[];  // 2 stages of Kp x kTile
  const int Kp = (K + 3) & ~3;
  const int nb = Kp / 4;
  const int stage = Kp * kTile;
  const int tid = threadIdx.x;
  const int s = tid % kSlices;
  const int bp = tid / kSlices;
  const bool active = bp < nb * (nb + 1) / 2;
  int bi = 0, bj = 0;
  if (active) pair_of(bp, nb, bi, bj);
  const long long n_tiles = (D + kTile - 1) / kTile;

  // the padding rows are zero in both stages and never loaded
  for (int e = tid; e < 2 * (Kp - K) * kTile; e += blockDim.x) {
    const int st = e / ((Kp - K) * kTile);
    sU[st * stage + K * kTile + e % ((Kp - K) * kTile)] = 0.f;
  }
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sU));
  auto load = [&](long long tile, int st) {
    constexpr int CPR = kTile / VEC;  // copies per row
    const long long c0 = tile * kTile;
    for (int c = tid; c < K * CPR; c += blockDim.x) {
      const int r = c / CPR, col = (c % CPR) * VEC;
      const bool in = c0 + col < D;  // D % VEC == 0: a copy is all in or all out
      cp_async<VEC>(base + 4u * (st * stage + r * kTile + col),
                    u + (size_t)r * D + (in ? c0 + col : 0), in);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  long long tile = blockIdx.x;
  if (tile < n_tiles) load(tile, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int st = it & 1;
    __syncthreads();  // the other stage (read last iteration) may be overwritten
    if (tile + gridDim.x < n_tiles) load(tile + gridDim.x, st ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile has landed
    __syncthreads();
    if (active) {
      const float* A = sU + st * stage + 4 * bi * kTile;
      const float* B = sU + st * stage + 4 * bj * kTile;
#pragma unroll 2
      for (int q = 0; q < kGroups; ++q) {
        const int c = 4 * (s + kSlices * q);
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = *reinterpret_cast<const float4*>(A + r * kTile + c);
          b[r] = *reinterpret_cast<const float4*>(B + r * kTile + c);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float t = acc[r][cc];
            t = fmaf(a[r].x, b[cc].x, t);
            t = fmaf(a[r].y, b[cc].y, t);
            t = fmaf(a[r].z, b[cc].z, t);
            t = fmaf(a[r].w, b[cc].w, t);
            acc[r][cc] = t;
          }
      }
    }
  }

  // the eight slices of a block pair are eight neighbouring lanes
#pragma unroll
  for (int off = kSlices / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        acc[r][cc] += __shfl_xor_sync(0xffffffffu, acc[r][cc], off);
  if (!active) return;
  float* row = partials + (size_t)blockIdx.x * K * K;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int r = e / 4, cc = e % 4, i = 4 * bi + r, j = 4 * bj + cc;
    if (e / 2 == s && i < K && j < K && (bi < bj || r <= cc)) row[i * K + j] = acc[r][cc];
  }
}

// one CTA: each pair's sum over blocks, in block order, to both triangles
__global__ void __launch_bounds__(kFinishThreads)
gram_finish_kernel(const float* __restrict__ partials, float* __restrict__ gram,
                   float* __restrict__ norm2, int K, int n_blocks) {
  const int P = K * (K + 1) / 2;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int i, j;
    pair_of(p, K, i, j);
    float t = 0.f;
#pragma unroll 8
    for (int b = 0; b < n_blocks; ++b) t += partials[(size_t)b * K * K + i * K + j];
    gram[i * K + j] = t;
    gram[j * K + i] = t;
    if (i == j) norm2[i] = t;
  }
}

template <int VEC>
cudaError_t launch_partials(const float* u, float* partials, int K, long long D, int n_blocks,
                            cudaStream_t s) {
  const int Kp = (K + 3) & ~3;
  const int n_bp = (Kp / 4) * (Kp / 4 + 1) / 2;
  const int threads = (n_bp * kSlices + 31) / 32 * 32;
  const int smem = 2 * Kp * kTile * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gram_partials_kernel<VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  gram_partials_kernel<VEC><<<n_blocks, threads, smem, s>>>(u, partials, K, D);
  return cudaGetLastError();
}

// ---- K > 32: output tiles of the upper triangle -----------------------------

constexpr int kTileK = 64;                   // Gram entries a side of an output tile
constexpr int kChunk = 16;                   // coordinates a step
constexpr int kTileThreads = 256;            // 16 x 16 threads, 4 x 4 entries each
constexpr int kTileRow = kTileK + 4;         // shared row stride (floats)

// tile pair blockIdx.x of the row-major upper triangle of nt x nt tiles,
// split blockIdx.y of D: chunks [s per, (s + 1) per) of 16 coordinates
__global__ void __launch_bounds__(kTileThreads)
gram_tiles_kernel(const float* __restrict__ u, float* __restrict__ partials, int K,
                  long long D, int nt, long long per) {
  __shared__ __align__(16) float sA[2][kChunk][kTileRow];
  __shared__ __align__(16) float sB[2][kChunk][kTileRow];
  int bi, bj;
  pair_of(blockIdx.x, nt, bi, bj);
  const long long n_chunks = (D + kChunk - 1) / kChunk;
  const long long ch0 = (long long)blockIdx.y * per;
  const long long ch1 = ch0 + per < n_chunks ? ch0 + per : n_chunks;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // loads: row tid / 4 of each side's tile, coordinates 4 (tid % 4) .. + 3
  const int lr = tid >> 2, lc = (tid & 3) * 4;
  const int ra = bi * kTileK + lr, rb = bj * kTileK + lr;
  const float* pa = ra < K ? u + (size_t)ra * D : nullptr;
  const float* pb = rb < K ? u + (size_t)rb * D : nullptr;
  float va[4], vb[4];
  auto fetch = [&](long long ch) {
    const long long c = ch * kChunk + lc;
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
      sA[st][lc + e][lr] = va[e];
      sB[st][lc + e][lr] = vb[e];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
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
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[st][kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[st][kk][4 * tx]);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    if (more) stash(st ^ 1);  // the other buffer: everyone left it a step ago
    __syncthreads();
  }
  float* out = partials + (size_t)blockIdx.y * K * K;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = bi * kTileK + 4 * ty + r, j = bj * kTileK + 4 * tx + c;
      if (i < K && j < K && i <= j) out[(size_t)i * K + j] = acc[r][c];
    }
}

// entry (i, j), i <= j: the S splits' sums in split order, to both triangles
__global__ void gram_tiles_finish_kernel(const float* __restrict__ partials,
                                         float* __restrict__ gram, float* __restrict__ norm2,
                                         int K, int splits) {
  const int i = blockIdx.y * 16 + threadIdx.y, j = blockIdx.x * 16 + threadIdx.x;
  if (i >= K || j >= K || i > j) return;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += partials[((size_t)s * K + i) * K + j];
  gram[(size_t)i * K + j] = t;
  gram[(size_t)j * K + i] = t;
  if (i == j) norm2[i] = t;
}

cudaError_t launch_tiles(const float* u, float* partials, float* gram, float* norm2, int K,
                         long long D, int splits, cudaStream_t s) {
  const int nt = (K + kTileK - 1) / kTileK;
  const long long n_chunks = (D + kChunk - 1) / kChunk;
  const long long per = (n_chunks + splits - 1) / splits;
  gram_tiles_kernel<<<dim3(nt * (nt + 1) / 2, splits), kTileThreads, 0, s>>>(u, partials, K,
                                                                              D, nt, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nb = (K + 15) / 16;
  gram_tiles_finish_kernel<<<dim3(nb, nb), dim3(16, 16), 0, s>>>(partials, gram, norm2, K,
                                                                  splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launches.
// partials is (n_blocks, K*K) scratch, gram is (K, K), norm2 is (K,); K <=
// 1024, n_blocks the CTAs of the stream at K <= 32 and the splits of D
// above.
extern "C" int pairwise_gram_launch(const float* u, float* partials, float* gram,
                                    float* norm2, int K, long long D, int n_blocks,
                                    void* stream) {
  if (K <= 0 || K > kWideMaxK || D <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K > kMaxK) return (int)launch_tiles(u, partials, gram, norm2, K, D, n_blocks, s);
  const int vec = tile_stream::copy_width(D, {u});
  const cudaError_t e = vec == 4   ? launch_partials<4>(u, partials, K, D, n_blocks, s)
                        : vec == 2 ? launch_partials<2>(u, partials, K, D, n_blocks, s)
                                   : launch_partials<1>(u, partials, K, D, n_blocks, s);
  if (e != cudaSuccess) return (int)e;
  gram_finish_kernel<<<1, kFinishThreads, 0, s>>>(partials, gram, norm2, K, n_blocks);
  return (int)cudaGetLastError();
}
