// Single-launch WFAgg gossip round for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _wfagg_round_indexed_kernel
// (src/repro/kernels/robust_stats/kernel.py:367), launched by
// wfagg_round_indexed_pallas (kernel.py:511).  For every receiving node n
// with neighbour rows u_k = models[idx[n, k]] (k < K <= 32) it computes, in
// one launch:
//   phase 0   the valid-masked coordinate-wise median of the u_k and the
//             sufficient statistics dist2, dotmed, norm2, mednorm2 and, with
//             prev, prev_dist2 / prev_dot / prev_norm2 (WFAgg-T);
//   epilogue  the WFAgg scoring stage (core/trust.py: derive_trust_weights
//             + combine_coefficients): the three filter masks, the
//             tau-weighted trust weights and the WFAgg-E coefficients;
//   phase 1   out[n] = lcoef * local[n] + sum_k wcomb_k * u_k.
//
// Bound on this card: bytes.  The function must read models, prev and local
// once and write out once (4 * M * D * 4 bytes for M = N); at 3.35 TB/s that
// is the floor.  Its arithmetic (about 16 flops per candidate coordinate plus
// a sorting network) sits below the float32 peak at these byte counts.
//
// Design, simple first:
//   * One CTA of 256 threads per receiving node.  Threads stride over the
//     coordinates j, so neighbouring threads read neighbouring addresses of
//     each neighbour row (coalesced); rows are found through the index table,
//     so the (N, K, D) gossip tensor never exists.
//   * Per coordinate a thread holds the K values in registers, sorts a copy
//     with a bitonic network (invalid slots and the padding up to the template
//     width KP in {8, 16, 32} hold +inf) and takes 0.5 * (srt[lo] + srt[hi])
//     at the dynamic middles of the valid count v; the empty median (v = 0)
//     is 0.
//   * Per-thread partial sums live in registers up to KP = 16 and in shared
//     memory at KP = 32.  The block reduction has a fixed order (warp
//     butterflies, then warps in index order) that is the same for every
//     slot: two bit-identical neighbour rows get bit-identical statistics,
//     so the stable-index tie-break of the masks picks the same slot as
//     torch.argsort(stable=True).  No atomics: results repeat run to run.
//   * Warp 0 runs the scoring stage, one lane per slot, and leaves the
//     combine coefficients in shared memory; phase 1 re-reads the rows
//     (from L2 at the paper's size) and skips the slots whose coefficient
//     is 0, which adds exactly +-0 in the reference.
// What it leaves on the table: one CTA per node under-fills the 132 SMs at
// N = 20, and phase 1 reads the rows a second time.  Splitting D across CTAs
// needs a grid-wide barrier before phase 1; that is later work.
//
// No fast-math: the bands carry +-inf, invalid rows sort as +inf, and the
// cosines need IEEE sqrtf and division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* local;    // (N, D)
  const float* models;   // (M, D)
  const int32_t* idx;    // (N, K) rows into models (and prev)
  const uint8_t* valid;  // (N, K) bool
  const float* prev;     // (M, D) or null
  const float* tbands;   // (N, 4K) [lo_d | hi_d | lo_c | hi_c] or null
  float* out;            // (N, D)
  float* weights;        // (N, K)
  uint8_t* mask_d;       // (N, K) bool
  uint8_t* mask_c;
  uint8_t* mask_t;
  float* dist2;          // (N, K)
  float* dotmed;
  float* norm2;
  float* mednorm2;       // (N,)
  float* prev_dist2;     // (N, K) or null
  float* prev_dot;
  float* prev_norm2;
  int K;
  long long D;
  int f;
  float tau1, tau2, tau3;
  float accept_floor;    // accept_threshold - 1e-9, rounded to float32
  float alpha;
  int mean_fallback;
};

// per-thread partial sums: six fields of KP slots, then mednorm2
enum { F_D2 = 0, F_DM, F_N2, F_PD2, F_PDT, F_PN2, F_COUNT };

template <int KP>
__host__ __device__ constexpr int n_partials() { return F_COUNT * KP + 1; }

template <int KP>
__device__ __forceinline__ void bitonic_sort(float (&a)[KP]) {
#pragma unroll
  for (int size = 2; size <= KP; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const float lo = fminf(a[i], a[j]);
          const float hi = fmaxf(a[i], a[j]);
          const bool up = (i & size) == 0;
          a[i] = up ? lo : hi;
          a[j] = up ? hi : lo;
        }
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

template <int KP, bool kShared>
struct Partials;

template <int KP>
struct Partials<KP, false> {  // registers
  float v[n_partials<KP>()];
  __device__ __forceinline__ void init(float*, int) {
#pragma unroll
    for (int q = 0; q < n_partials<KP>(); ++q) v[q] = 0.f;
  }
  __device__ __forceinline__ float& operator[](int q) { return v[q]; }
};

template <int KP>
struct Partials<KP, true> {  // shared memory, one column per thread
  float* p;
  __device__ __forceinline__ void init(float* smem, int tid) {
    p = smem + tid;
#pragma unroll 4
    for (int q = 0; q < n_partials<KP>(); ++q) p[q * kThreads] = 0.f;
  }
  __device__ __forceinline__ float& operator[](int q) { return p[q * kThreads]; }
};

template <int KP, bool kShared>
__global__ void __launch_bounds__(kThreads)
wfagg_round_kernel(const Args a) {
  constexpr int NP = n_partials<KP>();
  extern __shared__ float partial_smem[];  // kShared: NP * kThreads floats
  __shared__ float red[kShared ? 1 : NP * kWarps];
  __shared__ float tot[NP];
  __shared__ const float* rows[KP];
  __shared__ const float* prows[KP];
  __shared__ float wcomb[KP];
  __shared__ float lcoef;
  __shared__ unsigned vbits_s;

  const int n = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K;
  const long long D = a.D;
  const bool has_prev = a.prev != nullptr;
  const size_t nk = (size_t)n * K;

  if (tid < K) {
    const long long r = a.idx[nk + tid];
    rows[tid] = a.models + r * D;
    prows[tid] = has_prev ? a.prev + r * D : nullptr;
  }
  if (warp == 0) {
    const bool vk = lane < K && a.valid[nk + lane] != 0;
    const unsigned b = __ballot_sync(kFull, vk);
    if (lane == 0) vbits_s = b;
  }
  __syncthreads();
  const unsigned vbits = vbits_s;
  const int v = __popc(vbits);
  const int lo = (v - 1) >> 1, hi = v >> 1;  // dynamic middles (v > 0)

  // ---- phase 0: median + sufficient statistics --------------------------
  Partials<KP, kShared> acc;
  acc.init(partial_smem, tid);
  for (long long j = tid; j < D; j += kThreads) {
    float u[KP], s[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      u[k] = k < K ? __ldg(rows[k] + j) : 0.f;
      s[k] = ((vbits >> k) & 1u) ? u[k] : INFINITY;
    }
    bitonic_sort<KP>(s);
    float mlo = 0.f, mhi = 0.f;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      if (i == lo) mlo = s[i];
      if (i == hi) mhi = s[i];
    }
    const float med = v > 0 ? 0.5f * (mlo + mhi) : 0.f;
    acc[F_COUNT * KP] += med * med;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K) {
        const float x = u[k], dd = x - med;
        acc[F_D2 * KP + k] += dd * dd;
        acc[F_DM * KP + k] += x * med;
        acc[F_N2 * KP + k] += x * x;
        if (has_prev) {
          const float p = __ldg(prows[k] + j), dp = x - p;
          acc[F_PD2 * KP + k] += dp * dp;
          acc[F_PDT * KP + k] += x * p;
          acc[F_PN2 * KP + k] += p * p;
        }
      }
    }
  }

  // ---- fixed-order block reduction into tot[] ---------------------------
  if constexpr (kShared) {
    __syncthreads();
    for (int q = warp; q < NP; q += kWarps) {
      float s = 0.f;
#pragma unroll
      for (int i = lane; i < kThreads; i += 32) s += partial_smem[q * kThreads + i];
      s = warp_sum(s);
      if (lane == 0) tot[q] = s;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const float s = warp_sum(acc[q]);
      if (lane == 0) red[q * kWarps + warp] = s;
    }
    __syncthreads();
    for (int q = tid; q < NP; q += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[q * kWarps + w];
      tot[q] = s;
    }
  }
  __syncthreads();

  // ---- epilogue: WFAgg scoring stage, one lane per slot ------------------
  if (warp == 0) {
    const int k = lane;
    const bool real = k < K;
    const bool vk = (vbits >> k) & 1u;  // false on lanes >= K
    float d2 = 0.f, dm = 0.f, n2 = 0.f, pd2 = 0.f, pdt = 0.f, pn2 = 0.f;
    if (real) {
      d2 = tot[F_D2 * KP + k];
      dm = tot[F_DM * KP + k];
      n2 = tot[F_N2 * KP + k];
      pd2 = tot[F_PD2 * KP + k];
      pdt = tot[F_PDT * KP + k];
      pn2 = tot[F_PN2 * KP + k];
    }
    const float m2 = tot[F_COUNT * KP];
    const float sd = vk ? d2 : INFINITY;
    const float sc = vk ? 1.f - dm / sqrtf(fmaxf(n2 * m2, 1e-24f)) : INFINITY;
    // stable rank: #{j : s_j < s_k or (s_j == s_k and j < k)}
    int rd = 0, rc = 0;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const float sdj = __shfl_sync(kFull, sd, j);
      const float scj = __shfl_sync(kFull, sc, j);
      if (j < K) {
        rd += (sdj < sd) || (sdj == sd && j < k);
        rc += (scj < sc) || (scj == sc && j < k);
      }
    }
    const int keep = min(max(v - a.f - 1, 0), K);
    const bool md = real && rd < keep;
    const bool mc = real && rc < keep;
    bool mt = false;
    if (a.tbands != nullptr && real) {
      const float* tb = a.tbands + (size_t)n * 4 * K;
      const float bt = 1.f - pdt / sqrtf(fmaxf(n2 * pn2, 1e-24f));
      mt = vk && pd2 >= tb[k] && pd2 <= tb[K + k] && bt >= tb[2 * K + k] &&
           bt <= tb[3 * K + k];
    }
    float w = a.tau1 * (float)md + a.tau2 * (float)mc + a.tau3 * (float)mt;
    w = w < a.accept_floor ? 0.f : w;
    w = vk ? w : 0.f;
    const float wsum = warp_sum(w);
    float wn = w / fmaxf(wsum, 1e-12f);
    float ea;
    if (a.mean_fallback) {
      const float vsum = (float)v;
      wn = wsum > 0.f ? wn : (vk ? 1.f : 0.f) / fmaxf(vsum, 1.f);
      ea = vsum > 0.f ? a.alpha : 0.f;
    } else {
      ea = wsum > 0.f ? a.alpha : 0.f;
    }
    if (real) {
      const size_t e = nk + k;
      a.weights[e] = w;
      a.mask_d[e] = md;
      a.mask_c[e] = mc;
      a.mask_t[e] = mt;
      a.dist2[e] = d2;
      a.dotmed[e] = dm;
      a.norm2[e] = n2;
      if (has_prev) {
        a.prev_dist2[e] = pd2;
        a.prev_dot[e] = pdt;
        a.prev_norm2[e] = pn2;
      }
    }
    if (k < KP) wcomb[k] = real ? ea * wn : 0.f;
    if (k == 0) {
      lcoef = 1.f - ea;
      a.mednorm2[n] = m2;
    }
  }
  __syncthreads();

  // ---- phase 1: WFAgg-E combine in slot order ---------------------------
  float wc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) wc[k] = wcomb[k];
  const float lc = lcoef;
  const float* loc = a.local + (size_t)n * D;
  float* o = a.out + (size_t)n * D;
  for (long long j = tid; j < D; j += kThreads) {
    float r = lc * __ldg(loc + j);
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < K && wc[k] != 0.f) r += wc[k] * __ldg(rows[k] + j);
    o[j] = r;
  }
}

template <int KP>
cudaError_t launch(const Args& a, int N, cudaStream_t stream) {
  constexpr bool kShared = KP > 16;
  const size_t smem = kShared ? (size_t)n_partials<KP>() * kThreads * sizeof(float) : 0;
  if (kShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        wfagg_round_kernel<KP, kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  wfagg_round_kernel<KP, kShared><<<N, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
extern "C" int wfagg_round_indexed_launch(
    const float* local, const float* models, const int32_t* idx,
    const uint8_t* valid, const float* prev, const float* tbands, float* out,
    float* weights, uint8_t* mask_d, uint8_t* mask_c, uint8_t* mask_t,
    float* dist2, float* dotmed, float* norm2, float* mednorm2,
    float* prev_dist2, float* prev_dot, float* prev_norm2, int N, int K,
    long long D, int f, float tau1, float tau2, float tau3, float accept_floor,
    float alpha, int mean_fallback, void* stream) {
  if (N <= 0 || K <= 0 || K > 32 || D <= 0) return (int)cudaErrorInvalidValue;
  const Args a{local, models, idx, valid, prev, tbands, out, weights,
               mask_d, mask_c, mask_t, dist2, dotmed, norm2, mednorm2,
               prev_dist2, prev_dot, prev_norm2, K, D, f, tau1, tau2, tau3,
               accept_floor, alpha, mean_fallback};
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 8) return (int)launch<8>(a, N, s);
  if (K <= 16) return (int)launch<16>(a, N, s);
  return (int)launch<32>(a, N, s);
}
