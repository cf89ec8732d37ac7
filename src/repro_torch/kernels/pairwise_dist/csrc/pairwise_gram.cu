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
// Bound on this card: bytes at the K it serves.  It must read the matrix once,
// 4*K*D bytes at 3.35 TB/s; its K*(K+1)/2 multiply-adds per coordinate (K*(K+1)
// flops) stay under that time at 67 TFLOP/s float32 for K <= 32 (the TPU
// kernel used the MXU; here there is no TF32: the reference is float32).
//
// Design, simple first:
//   * A tile is 256 consecutive coordinates of all K rows, staged in shared
//     memory with a row stride of 257 floats, so the lanes of a warp that read
//     coordinate c of different rows hit different banks.  Each CTA of 256
//     threads walks tiles in a grid-stride loop (at most 4 CTAs per SM).
//   * Only the K*(K+1)/2 pairs i <= j are computed, at most 3 per thread; the
//     finishing pass writes each to (i, j) and (j, i), so the Gram is exactly
//     symmetric.  A pair's thread adds its products with fmaf in coordinate
//     order, tile after tile.
//   * No atomics.  Each CTA writes its pair sums to its own row of a
//     (blocks, K*(K+1)/2) buffer; a second, one-CTA launch adds the rows in
//     block order.  Two bit-identical rows a, b give bit-identical Gram rows:
//     the products u_a*u_x and u_x*u_b are the same floats, summed in the same
//     order.  Multi-Krum's and Clustering's index tie-breaks rely on it.
// What it leaves on the table: every multiply-add reads two floats from shared
// memory (no register blocking), and loads are 4 bytes a thread.
//
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA = coordinates per tile
constexpr int kStride = kThreads + 1;
constexpr int kMaxK = 32;
constexpr int kMaxPairs = (kMaxK * (kMaxK + 1) / 2 + kThreads - 1) / kThreads;

// pair p of the row-major upper triangle (i <= j)
__device__ __forceinline__ void pair_of(int p, int K, int& i, int& j) {
  i = 0;
  while (p >= K - i) {
    p -= K - i;
    ++i;
  }
  j = i + p;
}

__global__ void __launch_bounds__(kThreads)
gram_partials_kernel(const float* __restrict__ u, float* __restrict__ partials, int K,
                     long long D) {
  extern __shared__ float sU[];  // K * kStride
  const int tid = threadIdx.x;
  const int P = K * (K + 1) / 2;
  const long long n_tiles = (D + kThreads - 1) / kThreads;

  int pi[kMaxPairs], pj[kMaxPairs];
  float acc[kMaxPairs];
#pragma unroll
  for (int s = 0; s < kMaxPairs; ++s) {
    const int p = tid + s * kThreads;
    pi[s] = pj[s] = 0;
    if (p < P) pair_of(p, K, pi[s], pj[s]);
    acc[s] = 0.f;
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * kThreads;
    for (int k = 0; k < K; ++k) {
      const long long j = base + tid;
      sU[k * kStride + tid] = j < D ? __ldg(u + (size_t)k * D + j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxPairs; ++s) {
      if (tid + s * kThreads < P) {
        const float* a = sU + pi[s] * kStride;
        const float* b = sU + pj[s] * kStride;
        float t = acc[s];
#pragma unroll 8
        for (int c = 0; c < kThreads; ++c) t = fmaf(a[c], b[c], t);
        acc[s] = t;
      }
    }
    __syncthreads();
  }

  float* row = partials + (size_t)blockIdx.x * P;
#pragma unroll
  for (int s = 0; s < kMaxPairs; ++s) {
    const int p = tid + s * kThreads;
    if (p < P) row[p] = acc[s];
  }
}

// one CTA: each pair's sum over blocks, in block order, to both triangles
__global__ void __launch_bounds__(kThreads)
gram_finish_kernel(const float* __restrict__ partials, float* __restrict__ gram,
                   float* __restrict__ norm2, int K, int n_blocks) {
  const int P = K * (K + 1) / 2;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float t = 0.f;
    for (int b = 0; b < n_blocks; ++b) t += partials[(size_t)b * P + p];
    int i, j;
    pair_of(p, K, i, j);
    gram[i * K + j] = t;
    gram[j * K + i] = t;
    if (i == j) norm2[i] = t;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launches.
// partials is (n_blocks, K*(K+1)/2), gram is (K, K), norm2 is (K,).
extern "C" int pairwise_gram_launch(const float* u, float* partials, float* gram,
                                    float* norm2, int K, long long D, int n_blocks,
                                    void* stream) {
  if (K <= 0 || K > kMaxK || D <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)K * kStride * sizeof(float);
  gram_partials_kernel<<<n_blocks, kThreads, smem, s>>>(u, partials, K, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gram_finish_kernel<<<1, kThreads, 0, s>>>(partials, gram, norm2, K, n_blocks);
  return (int)cudaGetLastError();
}
