// Flash attention for Hopper (sm_90a): causal, padded, online-softmax
// attention with the running max and denominator kept on chip.
//
// Replaces the Pallas TPU kernel _flash_kernel
// (src/repro/kernels/flash_attn/kernel.py:29), launched by
// flash_attention_pallas (kernel.py:81).  For q (BH, Sq, hd) and k, v
// (BH, Sk, hd), f32 or bf16, it computes per query row i of head bh
//   s_j  = (q_i . k_j) * scale                   in f32
//   live = j < sk_valid  and, if causal, j <= i + q_offset
//   m    = max over live s_j (-1e30 if none), p_j = live ? exp(s_j - m) : 0
//   l    = sum_j p_j,  o_i = (sum_j p_j v_j) / max(l, 1e-30)
// and writes o (BH, Sq, hd) in q's type, m and l (BH, Sq) f32.  A row with
// no live key gets o = 0, m = -1e30, l = 0, as in the reference.
//
// Bound on this card: operations.  Each live (query, key) pair costs
// 4*hd flops (the score's and the output's multiply-adds) against
// 2*(3+1)*hd bytes per row of q, k, v, o read or written once; at the
// prefill shape (Sq = Sk = 8192, hd = 64) that is ~2000 flops per byte.
// The reference upcasts bf16 inputs to f32 before both products and the
// port keeps TF32 off, so the rate that counts is f32 on the CUDA cores
// (67 TFLOP/s), not the tensor cores' bf16 rate.
//
// Design, simple first:
//   * One CTA of 256 threads per (bh, block of 64 query rows); the grid
//     walks the query blocks from the last (the longest causal row) down.
//     The reference's sequential KV grid axis becomes a loop over 64-key
//     tiles inside the CTA, which stops at the last tile any of its rows can
//     see: the Pallas update is the identity on a tile with no live key, so
//     skipping those tiles changes nothing.
//   * Q (64 x hd) is staged once, K and V (64 x hd) per tile, all as f32 in
//     shared memory with a row stride of hd + 1 floats, so the lanes that
//     read one column of different rows hit different banks (hd = 80 is not
//     a power of two and needs no special case).
//   * Thread (ty, tx) owns query rows 4*ty .. 4*ty + 3.  Scores: keys
//     tx + 16*j (j < 4), a 4 x 4 register tile of fmaf chains over d.  The
//     16 threads of a row are one half-warp: the row max and the sum of p
//     are xor-shuffles inside it.  Output: head dims tx + 16*c (c < hd/16),
//     a 4 x hd/16 register accumulator that stays in f32 across all tiles.
//     P goes through shared memory; it is written and read by the same
//     half-warp, so a warp barrier orders it.
//   * size_t offsets: BH * S * hd passes 2^31 at long prefills.
// Deliberate deviation: the Pallas kernel keeps its accumulator in the
// output block, rounding it to bf16 after every KV block when q is bf16;
// here it stays f32 until the final division, nearer the dense oracle.
// What it leaves on the table: every multiply-add reads one float from
// shared memory (4-byte loads, no tensor cores), so shared-memory issue, not
// the FMA pipes, bounds it; loads from device memory are one element a
// thread.
//
// No fast-math: expf and IEEE division, as the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 64;              // keys per tile
constexpr int kTX = 16;              // lanes across keys / head dims
constexpr int kTY = 16;              // row groups
constexpr int kThreads = kTX * kTY;  // 256
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // keys per thread in the score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)((kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                  int Sq, int Sk, float scale, int causal, int sk_valid, int q_offset) {
  constexpr int LD = HD + 1;      // row stride of the Q, K, V tiles
  constexpr int PD = kBK + 1;     // row stride of the P tile
  constexpr int DPT = HD / kTX;   // head dims per thread in the output
  static_assert(HD % kTX == 0, "hd must be a multiple of 16");
  extern __shared__ float smem[];
  float* sQ = smem;               // kBQ x LD
  float* sK = sQ + kBQ * LD;      // kBK x LD
  float* sV = sK + kBK * LD;      // kBK x LD
  float* sP = sV + kBK * LD;      // kBQ x PD

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qb = q + bh * (size_t)Sq * HD;
  const T* kb = k + bh * (size_t)Sk * HD;
  const T* vb = v + bh * (size_t)Sk * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    sQ[r * LD + c] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * HD + c]) : 0.f;
  }

  float acc[kRows][DPT];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // keys past kv_lim are padding; past kv_end no row of this block sees one
  const int kv_lim = min(sk_valid, Sk);
  const int kv_end = causal ? min(kv_lim, q0 + kBQ + q_offset) : kv_lim;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Q staged; the last tile's K, V and P no longer read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * HD + c;
      sK[r * LD + c] = in ? to_f32(kb[g]) : 0.f;
      sV[r * LD + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[kRows], kk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kk[j] = sK[(tx + kTX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i + q_offset;
      bool live[kCols];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        live[j] = kpos < kv_lim && (!causal || kpos <= qpos);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run[i], tmax);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < kCols; ++j) sP[(ty * kRows + i) * PD + tx + kTX * j] = s[i][j];
    }
    __syncwarp();  // a row's P is written and read by its own half-warp

#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      float pa[kRows], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sP[(ty * kRows + i) * PD + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = sV[j * LD + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pa[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    T* orow = o + (bh * (size_t)Sq + row) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) store(orow + tx + kTX * c, acc[i][c] / denom);
    if (tx == 0) {
      m_out[bh * (size_t)Sq + row] = m_run[i];
      l_out[bh * (size_t)Sq + row] = l_run[i];
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int BH,
           int Sq, int Sk, float scale, int causal, int sk_valid, int q_offset,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_attn_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, m, l, Sq, Sk, scale, causal, sk_valid,
      q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// q, o are (BH, Sq, hd) and k, v (BH, Sk, hd), contiguous, all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1); m, l are (BH, Sq) f32.
// hd is 32, 64, 80 or 128.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                                 float* m, float* l, int BH, int Sq, int Sk, int hd,
                                 int is_bf16, float scale, int causal, int sk_valid,
                                 int q_offset, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define FLASH_ATTN_CASE(HD)                                                                   \
  case HD:                                                                                    \
    return is_bf16 ? launch<__nv_bfloat16, HD>(q, k, v, o, m, l, BH, Sq, Sk, scale, causal,   \
                                               sk_valid, q_offset, s)                         \
                   : launch<float, HD>(q, k, v, o, m, l, BH, Sq, Sk, scale, causal, sk_valid, \
                                       q_offset, s);
  switch (hd) {
    FLASH_ATTN_CASE(32)
    FLASH_ATTN_CASE(64)
    FLASH_ATTN_CASE(80)
    FLASH_ATTN_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ATTN_CASE
}
