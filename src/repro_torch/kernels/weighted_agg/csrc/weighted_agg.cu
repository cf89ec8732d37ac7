// Single-node WFAgg-E combine, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _weighted_agg_kernel
// (src/repro/kernels/weighted_agg/kernel.py:22), launched by weighted_agg_pallas
// (kernel.py:88):
//   out[d] = lcoef * local[d] + sum_k wvec[k] * U[k][d]
// with wvec = eff_alpha * w_norm (K,) and lcoef = 1 - eff_alpha, both left on
// the device by the wrapper and read here through pointers, so the host never
// waits for them.
//
// Exact order: out[d] = round(lcoef * local[d]), then, for k = 0 .. K-1 in
// slot order, plus round(wvec[k] * U[k][d]), each step rounded (__fmul_rn /
// __fadd_rn, no fused multiply-add): what weighted_agg_plain (ops.py)
// computes op for op, so the kernel equals it bit for bit.  No slot is
// skipped: a zero weight times a NaN row is NaN, as in the reference's dot
// product; with all-zero weights lcoef = 1 and every term adds +0, so out =
// local (finite U).
//
// Bound on this card: bytes.  The function must read U and local once and
// write out: 4 (K + 2) D bytes at 3.35 TB/s (0.1703 ms at K = 32, D = 2^22),
// against 2 K D flops (0.004 ms at 67 TFLOP/s).
//
// Design: a plain stream.  Each thread owns VEC consecutive coordinates in a
// grid-stride loop of at most 4 CTAs of 256 threads per SM, and walks the
// rows k = 0 .. K-1 with read-only vector loads of VEC floats: 16 bytes where
// D % 4 == 0 and local, U and out are 16-byte aligned, else 8 or 4
// (tile_stream::copy_width; nothing is padded in device memory).  The
// weights are warp-uniform __ldg reads (L1 broadcasts).  A cp.async ring of
// up to 32 rows a stage was tried and dropped: timed in turns with this
// stream on one card, it was slower at K = 32, D = 2^22 and at K = 20, d =
// 44,426 (PERF.md).
//
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr int kThreads = 256;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(const float* __restrict__ wvec, const float* __restrict__ lcoef,
                    const float* __restrict__ local, const float* __restrict__ U,
                    float* __restrict__ out, int K, long long D) {
  const float lc = __ldg(lcoef);
  for (long long j = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC; j < D;
       j += (long long)gridDim.x * kThreads * VEC) {
    float x[VEC], r[VEC];
    tile_stream::load_vec<VEC>(x, local + j);
#pragma unroll
    for (int t = 0; t < VEC; ++t) r[t] = __fmul_rn(lc, x[t]);
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(wvec + k);
      tile_stream::load_vec<VEC>(x, U + (size_t)k * D + j);
#pragma unroll
      for (int t = 0; t < VEC; ++t) r[t] = __fadd_rn(r[t], __fmul_rn(w, x[t]));
    }
    tile_stream::store_vec<VEC>(out + j, r);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// Any K >= 1, any D >= 1, any alignment of the float rows (the vector width
// follows it); at most n_blocks CTAs, and none without a vector to combine.
extern "C" int weighted_agg_launch(const float* wvec, const float* lcoef,
                                   const float* local, const float* U, float* out,
                                   int K, long long D, int n_blocks, void* stream) {
  if (K <= 0 || D <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int vec = tile_stream::copy_width(D, {local, U, out});
  const long long needed = (D / vec + kThreads - 1) / kThreads;
  auto kernel = vec == 4 ? weighted_agg_kernel<4>
                         : vec == 2 ? weighted_agg_kernel<2> : weighted_agg_kernel<1>;
  kernel<<<(int)(needed < n_blocks ? needed : n_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      wvec, lcoef, local, U, out, K, D);
  return (int)cudaGetLastError();
}
