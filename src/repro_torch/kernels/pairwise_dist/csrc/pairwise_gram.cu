// Pairwise Gram of one (K, D) candidate matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pairwise_kernel
// (src/repro/kernels/pairwise_dist/kernel.py:17), launched by pairwise_pallas
// (kernel.py:29).  For candidates u_k (k < K <= 32) it computes
//   gram[i][j] = sum_d u_i[d] * u_j[d]    (K, K), exactly symmetric
//   norm2[k]   = gram[k][k]               (K,)
// which Krum / Multi-Krum (squared distances by the Gram expansion) and
// Clustering (cosine distances) read.
//
// Bound on this card: bytes.  It must read the matrix once, 4*K*D bytes at
// 3.35 TB/s (0.160 ms at K = 32, D = 2^22); its K*(K+1)/2 multiply-adds per
// coordinate stay under that time at 67 TFLOP/s float32 for K <= 32.  No
// tensor cores: the reference is float32, TF32 stays off, and a split
// product would break the tie invariant below.
//
// Design: a register-blocked stream.
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
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr int kMaxK = 32;
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

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launches.
// partials is (n_blocks, K*K) scratch, gram is (K, K), norm2 is (K,).
extern "C" int pairwise_gram_launch(const float* u, float* partials, float* gram,
                                    float* norm2, int K, long long D, int n_blocks,
                                    void* stream) {
  if (K <= 0 || K > kMaxK || D <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = tile_stream::copy_width(D, {u});
  const cudaError_t e = vec == 4   ? launch_partials<4>(u, partials, K, D, n_blocks, s)
                        : vec == 2 ? launch_partials<2>(u, partials, K, D, n_blocks, s)
                                   : launch_partials<1>(u, partials, K, D, n_blocks, s);
  if (e != cudaSuccess) return (int)e;
  gram_finish_kernel<<<1, kFinishThreads, 0, s>>>(partials, gram, norm2, K, n_blocks);
  return (int)cudaGetLastError();
}
