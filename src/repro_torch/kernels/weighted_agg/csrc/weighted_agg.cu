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
// Bound on this card: bytes.  It must read U (K*D floats) and local and write
// out: 4*(K+2)*D bytes at 3.35 TB/s, against 2*K*D flops.
//
// Design, simple first: each thread owns 4 consecutive coordinates and moves
// them as float4 (16-byte loads and stores; the wrapper pads D to a multiple
// of 4), walking the rows k = 0 .. K-1 in order with fmaf, in a grid-stride
// loop of at most 4 CTAs of 256 threads per SM.  With all-zero weights
// lcoef = 1 and every term is +0, so out = local exactly (for finite U).
// No slot is skipped: a zero weight times a NaN row is NaN, as in the
// reference's dot product.
//
// No fast-math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
weighted_agg_kernel(const float* __restrict__ wvec, const float* __restrict__ lcoef,
                    const float4* __restrict__ local, const float4* __restrict__ U,
                    float4* __restrict__ out, int K, long long D4) {
  const float lc = __ldg(lcoef);
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < D4;
       q += (long long)gridDim.x * kThreads) {
    const float4 l = __ldg(local + q);
    float4 r = make_float4(lc * l.x, lc * l.y, lc * l.z, lc * l.w);
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(wvec + k);
      const float4 x = __ldg(U + (size_t)k * D4 + q);
      r.x = fmaf(w, x.x, r.x);
      r.y = fmaf(w, x.y, r.y);
      r.z = fmaf(w, x.z, r.z);
      r.w = fmaf(w, x.w, r.w);
    }
    out[q] = r;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// local / U / out must start on 16-byte boundaries and D % 4 == 0.
extern "C" int weighted_agg_launch(const float* wvec, const float* lcoef,
                                   const float* local, const float* U, float* out,
                                   int K, long long D, int n_blocks, void* stream) {
  if (K <= 0 || D <= 0 || D % 4 != 0 || n_blocks <= 0 ||
      ((uintptr_t)local | (uintptr_t)U | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  weighted_agg_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      wvec, lcoef, reinterpret_cast<const float4*>(local),
      reinterpret_cast<const float4*>(U), reinterpret_cast<float4*>(out), K, D / 4);
  return (int)cudaGetLastError();
}
