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
// Bound on this card: bytes at the paper's K.  The function must read the
// candidates (and prev) once: 4*N*K*D bytes (twice with prev) at 3.35 TB/s.
// Its arithmetic is a sorting network of 24 / 80 / 240 compare-exchanges per
// coordinate for K padded to 8 / 16 / 32, plus about 8 flops per candidate
// coordinate; at K = 32 without prev the network's operations come close to
// the byte time.
//
// Design, simple first:
//   * A tile is 256 consecutive coordinates of all K rows of one node.  The
//     grid is (blocks, N): CTA (b, n) of 256 threads walks node n's tiles b,
//     b + blocks, ... (about 4 CTAs per SM over the whole grid).  Thread t
//     loads coordinate t of every row (coalesced across the warp), keeps the
//     column in registers and stages it in shared memory.  Element offsets
//     (n*K + k)*D + j are size_t: a gathered tensor may hold 2^30 floats.
//   * Thread t sorts its column with a bitonic network (K padded to 8, 16 or
//     32 with +inf) whose compare-exchange propagates NaN as jnp.minimum /
//     jnp.maximum do: a NaN anywhere in a column makes the whole sorted column
//     NaN, as in the Pallas kernel and jnp.median (fminf / fmaxf would drop it
//     and give a finite median where the reference has NaN).  The median is
//     s[K/2] for odd K and 0.5f * (s[K/2-1] + s[K/2]) for even K: the same
//     selection and the same rounding as the plain version, so bit-equal.
//   * The per-candidate sums are taken from shared memory by warp w for the
//     candidates k = w, w+8, ...: lane i of every warp adds the tile's
//     coordinates i, i+32, ... in the same order, so two bit-identical rows
//     get bit-identical partial sums whichever warp owns them.
//   * No atomics.  Each CTA writes its partials (warp butterflies, warps in
//     index order for mednorm2) to its own row (n, b) of an (N, blocks, 6K+1)
//     buffer; a second launch, one CTA per node, adds a node's rows in block
//     order.  Results repeat run to run, and identical rows keep identical
//     sums, so the index tie-break of WFAgg-D and WFAgg-C picks the same slot
//     as the plain version.  The single matrix is the case N = 1.
// What it leaves on the table: loads are 4 bytes a thread and wait on a
// barrier per tile (no cp.async / TMA pipeline), and the network sorts all
// 32 wires when K = 20.
//
// No fast-math: the padding is +inf and NaN must survive the network.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA = coordinates per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// fields of the flat output / partial row: F_COUNT blocks of K, then mednorm2
enum { F_D2 = 0, F_DM, F_N2, F_PD2, F_PDT, F_PN2, F_COUNT };

// ascending (up) or descending compare-exchange; any NaN makes both NaN
__device__ __forceinline__ void cmpx(float& a, float& b, bool up) {
  const bool nan = (a != a) || (b != b);
  const bool swap = up ? (b < a) : (a < b);
  const float x = swap ? b : a, y = swap ? a : b;
  a = nan ? __int_as_float(0x7fc00000) : x;
  b = nan ? __int_as_float(0x7fc00000) : y;
}

template <int KP>
__device__ __forceinline__ void bitonic_sort(float (&s)[KP]) {
#pragma unroll
  for (int size = 2; size <= KP; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int j = i ^ stride;
        if (j > i) cmpx(s[i], s[j], (i & size) == 0);
      }
    }
  }
}

// xor butterfly: every lane ends with the same, bit-identical sum
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
stats_partials_kernel(const float* __restrict__ u, const float* __restrict__ prev,
                      float* __restrict__ med_out, float* __restrict__ trim_out,
                      float* __restrict__ partials, int K, long long D, int n_trim) {
  constexpr int S = KP / kWarps;  // candidates per warp
  extern __shared__ float smem[];
  const bool has_prev = prev != nullptr;
  float* sU = smem;                                   // K * kThreads
  float* sP = sU + (size_t)K * kThreads;              // K * kThreads with prev
  float* sMed = sP + (has_prev ? (size_t)K * kThreads : 0);  // kThreads
  __shared__ float red[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (D + kThreads - 1) / kThreads;
  // node blockIdx.y: its K rows, its prev rows, its centers
  const size_t node = blockIdx.y;
  u += node * K * (size_t)D;
  if (has_prev) prev += node * K * (size_t)D;
  if (med_out != nullptr) {
    med_out += node * (size_t)D;
    trim_out += node * (size_t)D;
  }
  const int lo = (K - 1) >> 1, hi = K >> 1;

  float acc[S][F_COUNT];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < F_COUNT; ++q) acc[s][q] = 0.f;
  float mn2 = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long j = tile * kThreads + tid;
    const bool in = j < D;
    float s[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      float x = INFINITY;
      if (k < K) {
        x = in ? __ldg(u + (size_t)k * D + j) : 0.f;
        sU[k * kThreads + tid] = x;
        if (has_prev) sP[k * kThreads + tid] = in ? __ldg(prev + (size_t)k * D + j) : 0.f;
      }
      s[k] = x;
    }
    bitonic_sort<KP>(s);
    float mlo = 0.f, mhi = 0.f, tsum = 0.f;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      if (i == lo) mlo = s[i];
      if (i == hi) mhi = s[i];
      if (med_out != nullptr && i >= n_trim && i < K - n_trim) tsum += s[i];
    }
    const float med = (K & 1) ? mlo : 0.5f * (mlo + mhi);
    if (med_out != nullptr && in) {
      med_out[j] = med;
      trim_out[j] = tsum / (float)(K - 2 * n_trim);
    }
    sMed[tid] = med;
    mn2 += med * med;
    __syncthreads();

#pragma unroll
    for (int si = 0; si < S; ++si) {
      const int k = warp + kWarps * si;
      if (k < K) {
        const float* row = sU + k * kThreads;
        const float* prow = sP + k * kThreads;
        for (int i = lane; i < kThreads; i += 32) {
          const float x = row[i], m = sMed[i], dd = x - m;
          acc[si][F_D2] += dd * dd;
          acc[si][F_DM] += x * m;
          acc[si][F_N2] += x * x;
          if (has_prev) {
            const float p = prow[i], dp = x - p;
            acc[si][F_PD2] += dp * dp;
            acc[si][F_PDT] += x * p;
            acc[si][F_PN2] += p * p;
          }
        }
      }
    }
    __syncthreads();
  }

  float* row = partials + (node * gridDim.x + blockIdx.x) * (size_t)(F_COUNT * K + 1);
#pragma unroll
  for (int si = 0; si < S; ++si) {
    const int k = warp + kWarps * si;
    if (k < K) {
#pragma unroll
      for (int q = 0; q < F_COUNT; ++q) {
        const float v = warp_sum(acc[si][q]);
        if (lane == 0) row[q * K + k] = v;
      }
    }
  }
  const float m = warp_sum(mn2);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w];
    row[F_COUNT * K] = t;
  }
}

// one CTA per node n: out[n][q] = sum over blocks b, in block order, of
// partials[n][b][q]
__global__ void __launch_bounds__(kThreads)
stats_finish_kernel(const float* __restrict__ partials, float* __restrict__ out,
                    int n_out, int n_blocks) {
  const size_t node = blockIdx.x;
  const float* rows = partials + node * n_blocks * (size_t)n_out;
  for (int q = threadIdx.x; q < n_out; q += blockDim.x) {
    float t = 0.f;
    for (int b = 0; b < n_blocks; ++b) t += rows[(size_t)b * n_out + q];
    out[node * n_out + q] = t;
  }
}

template <int KP>
cudaError_t launch(const float* u, const float* prev, float* med, float* trim,
                   float* partials, float* out, int N, int K, long long D,
                   int n_trim, int n_blocks, cudaStream_t stream) {
  const size_t smem =
      ((size_t)K * kThreads * (prev != nullptr ? 2 : 1) + kThreads) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stats_partials_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  stats_partials_kernel<KP><<<dim3(n_blocks, N), kThreads, smem, stream>>>(
      u, prev, med, trim, partials, K, D, n_trim);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stats_finish_kernel<<<N, kThreads, 0, stream>>>(partials, out, F_COUNT * K + 1,
                                                  n_blocks);
  return cudaGetLastError();
}

int launch_any(const float* u, const float* prev, float* med, float* trim,
               float* partials, float* out, int N, int K, long long D, int n_trim,
               int n_blocks, void* stream) {
  if (N <= 0 || N > 65535 || K <= 0 || K > 32 || D <= 0 || n_blocks <= 0 ||
      n_trim < 0 || K - 2 * n_trim < 1 || (med == nullptr) != (trim == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 8)
    return (int)launch<8>(u, prev, med, trim, partials, out, N, K, D, n_trim, n_blocks, s);
  if (K <= 16)
    return (int)launch<16>(u, prev, med, trim, partials, out, N, K, D, n_trim, n_blocks, s);
  return (int)launch<32>(u, prev, med, trim, partials, out, N, K, D, n_trim, n_blocks, s);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, allocates nothing, and returns the cudaError_t of its
// launches.  med / trim are null unless the centers are wanted; prev may be
// null.
//
// One matrix u (K, D), prev (K, D); med / trim (D,); partials is
// (n_blocks, 6K+1), out is (6K+1,): [dist2 | dotmed | norm2 | prev_dist2 |
// prev_dot | prev_norm2 | mednorm2] (the prev fields are 0 without prev).
extern "C" int robust_stats_launch(const float* u, const float* prev, float* med,
                                   float* trim, float* partials, float* out, int K,
                                   long long D, int n_trim, int n_blocks,
                                   void* stream) {
  return launch_any(u, prev, med, trim, partials, out, 1, K, D, n_trim, n_blocks,
                    stream);
}

// A gathered tensor u (N, K, D), prev (N, K, D); med / trim (N, D); partials
// is (N, n_blocks, 6K+1), out is (N, 6K+1) in the same field order;
// n_blocks CTAs per node.
extern "C" int robust_stats_batch_launch(const float* u, const float* prev, float* med,
                                         float* trim, float* partials, float* out,
                                         int N, int K, long long D, int n_trim,
                                         int n_blocks, void* stream) {
  return launch_any(u, prev, med, trim, partials, out, N, K, D, n_trim, n_blocks,
                    stream);
}
