// Gather-free WFAgg-E combine of a gossip round, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _weighted_agg_indexed_kernel
// (src/repro/kernels/weighted_agg/kernel.py:30), launched by
// weighted_agg_indexed_pallas (kernel.py:56), the combine launch of the
// two-launch backend:
//   out[n] = lcoef[n] * local[n] + sum_k wvec[n, k] * models[idx[n, k]]
// accumulated in slot order k = 0 .. K-1 and seeded with
// lcoef * local + wvec[n, 0] * u_0, as the Pallas body does.  wvec =
// eff_alpha * w_norm (N, K) and lcoef = 1 - eff_alpha (N,) are left on the
// device by the wrapper (core/trust.py combine_coefficients) and read here
// through pointers, so the host never waits for them.  The rows are read
// through the index table: the (N, K, D) gossip tensor never exists.
//
// Bound on this card: bytes.  It must read each node's K rows and its local
// row and write its output row: 4 * N * (K + 2) * D bytes at 3.35 TB/s,
// against 2 * N * K * D flops.
//
// Design, simple first: a grid of (D-chunk, node) CTAs of 256 threads, about
// 4 CTAs per SM over the whole grid.  A CTA reads its node's K table entries
// and weights into shared memory once, then each thread owns 4 consecutive
// coordinates and moves them as float4 (the wrapper pads D to a multiple of
// 4), walking the rows in slot order with fmaf.  With all-zero weights
// lcoef = 1 and every term adds +0, so out = local exactly (finite rows); no
// slot is skipped, as in the reference (a zero weight times a NaN row is
// NaN).
//
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;

__global__ void __launch_bounds__(kThreads)
weighted_agg_indexed_kernel(const float* __restrict__ wvec, const float* __restrict__ lcoef,
                            const float4* __restrict__ local, const float4* __restrict__ models,
                            const int32_t* __restrict__ idx, float4* __restrict__ out, int K,
                            long long D4) {
  __shared__ const float4* rows[kMaxK];
  __shared__ float w[kMaxK];
  const int n = blockIdx.y, tid = threadIdx.x;
  if (tid < K) {
    rows[tid] = models + (size_t)idx[(size_t)n * K + tid] * D4;
    w[tid] = wvec[(size_t)n * K + tid];
  }
  __syncthreads();
  const float lc = __ldg(lcoef + n);
  const float4* loc = local + (size_t)n * D4;
  float4* o = out + (size_t)n * D4;
  for (long long q = (long long)blockIdx.x * kThreads + tid; q < D4;
       q += (long long)gridDim.x * kThreads) {
    const float4 l = __ldg(loc + q);
    float4 r = make_float4(lc * l.x, lc * l.y, lc * l.z, lc * l.w);
    for (int k = 0; k < K; ++k) {
      const float wk = w[k];
      const float4 x = __ldg(rows[k] + q);
      r.x = fmaf(wk, x.x, r.x);
      r.y = fmaf(wk, x.y, r.y);
      r.z = fmaf(wk, x.z, r.z);
      r.w = fmaf(wk, x.w, r.w);
    }
    o[q] = r;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// local / models / out must start on 16-byte boundaries and D % 4 == 0;
// idx holds rows of models.
extern "C" int weighted_agg_indexed_launch(const float* wvec, const float* lcoef,
                                           const float* local, const float* models,
                                           const int32_t* idx, float* out, int N, int K,
                                           long long D, int n_chunks, void* stream) {
  if (N <= 0 || N > 65535 || K <= 0 || K > kMaxK || D <= 0 || D % 4 != 0 ||
      n_chunks <= 0 ||
      ((uintptr_t)local | (uintptr_t)models | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  weighted_agg_indexed_kernel<<<dim3(n_chunks, N), kThreads, 0, (cudaStream_t)stream>>>(
      wvec, lcoef, reinterpret_cast<const float4*>(local),
      reinterpret_cast<const float4*>(models), idx, reinterpret_cast<float4*>(out), K,
      D / 4);
  return (int)cudaGetLastError();
}
