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
// Two kernels, one per input type.
//
// bf16 (the prefill's type): flash_attn_bf16_kernel, on the tensor cores.
//   * Why tensor-core products are the reference's products.  The reference
//     upcasts bf16 q and k to f32 and multiplies in f32 (kernel.py:43-45).
//     A product of two bf16 values (8-bit significands) is exact in f32, so
//     mma.sync m16n8k16 on bf16 operands with an f32 accumulator forms the
//     same score products; only the order of the f32 sums differs.  scale
//     is applied after the product, in f32, as the reference does: q is not
//     pre-scaled in bf16 (1/sqrt(80) is not a power of two).
//   * The split of P.  p = exp(s - m) is f32 (kernel.py:57,63-64), and one
//     bf16 rounding of it (FlashAttention's usual choice) moves o by more
//     than one bf16 step of the output.  So P.V runs as kPTerms bf16
//     products against the same exact bf16 V: hi = bf16(p), lo = bf16(p -
//     hi), ..., which carries p to about 2^-17 with two terms.  l is summed
//     from the f32 p before the split.
//   * Per-tile sums, as the reference's acc * corr + dot(p, v): each tile's
//     P.V is summed on the tensor cores from zero (8 products deep at two
//     terms) and added to the f32 output accumulator with fmaf on the CUDA
//     cores.  Accumulating across all tiles inside the mma instead (1024
//     products deep at S = 8192) drifts: on an H100 it left twice as many
//     bf16 o a step off the plain version as the two-term split alone does,
//     and a third term made it worse, not better.
//   * Bound on this card: tensor-core operations, 4*hd per live (query,
//     key) pair at 989 TFLOP/s bf16 (the split makes the kernel do 6*hd;
//     the bound counts the function's).  The softmax's IEEE expf and the
//     split run on the CUDA cores beside it.
//   * Design (FlashAttention-2 on mma.sync): one CTA of 4 warps per (bh,
//     block of 64 query rows), the grid walking query blocks from the last
//     (the longest causal row) down; each warp owns 16 query rows.  K and V
//     tiles of 64 keys go into shared memory with 16-byte cp.async in a
//     2-stage ring, rows past Sk zero-filled through cp.async's src-size;
//     rows are padded by 16 bytes (an odd number of 16-byte units for every
//     hd), so the eight rows an ldmatrix reads fall in eight bank groups.
//     Q goes through shared memory once into registers (ldmatrix).  S = Q K^T
//     is a 16 x 64 f32 fragment per warp; its accumulator layout is the A
//     operand layout of the next m16n8k16, so P stays in registers.  V is
//     read with ldmatrix.trans.  Row max and sum are quad shuffles.  Tiles
//     with no masked key for any row of the warp skip the mask.  Needs
//     16-byte-aligned q, k, v (the wrapper checks); hd a multiple of 16.
//   * What holds it back: instruction issue on the CUDA cores, not the
//     tensor cores.  Per score element a thread issues several times more
//     instructions of softmax (IEEE expf alone is eight, one of them
//     MUFU.EX2), split and rescale than of mma and ldmatrix.  Registers are
//     capped for 3 CTAs an SM at hd <= 64 (2 above): fewer resident warps
//     hide less of the softmax's latency.
//
// f32: flash_attn_f32_kernel, on the CUDA cores.  The
//   reference multiplies in f32 and the port keeps TF32 off, so the rate
//   that counts is f32 outside the tensor cores (67 TFLOP/s).
//   * One CTA of 256 threads per (bh, block of 64 query rows); the grid
//     walks the query blocks from the last (the longest causal row) down.
//     The reference's sequential KV grid axis becomes a loop over 64-key
//     tiles inside the CTA, which stops at the last tile any of its rows can
//     see: the Pallas update is the identity on a tile with no live key, so
//     skipping those tiles changes nothing (the bf16 kernel does the same).
//   * Q (64 x hd) is staged once, K and V (64 x hd) per tile, in shared
//     memory with a row stride of hd + 1 floats, so the lanes that read one
//     column of different rows hit different banks.
//   * Thread (ty, tx) owns query rows 4*ty .. 4*ty + 3.  Scores: keys
//     tx + 16*j (j < 4), a 4 x 4 register tile of fmaf chains over d.  The
//     16 threads of a row are one half-warp: the row max and the sum of p
//     are xor-shuffles inside it.  Output: head dims tx + 16*c (c < hd/16),
//     a 4 x hd/16 register accumulator that stays in f32 across all tiles.
//     P goes through shared memory; it is written and read by the same
//     half-warp, so a warp barrier orders it.
//   * What it leaves on the table: every multiply-add reads one float from
//     shared memory (4-byte loads), so shared-memory issue, not the FMA
//     pipes, bounds it.
//
// Both: size_t offsets (BH * S * hd passes 2^31 at long prefills).
// Deliberate deviation: the Pallas kernel keeps its accumulator in the
// output block, rounding it to bf16 after every KV block when q is bf16;
// here it stays f32 until the final division, nearer the dense oracle.
//
// No fast-math: expf and IEEE division, as the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 64;              // keys per tile
static_assert(kBQ == kBK, "Q and a K or V tile are loaded by the same code");
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTX = 16;              // lanes across keys / head dims
constexpr int kTY = 16;              // row groups
constexpr int kThreads = kTX * kTY;  // 256
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // keys per thread in the score tile

template <int HD>
constexpr size_t f32_smem_bytes() {
  return (size_t)((kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk,
                      float scale, int causal, int sk_valid, int q_offset) {
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
  const float* qb = q + bh * (size_t)Sq * HD;
  const float* kb = k + bh * (size_t)Sk * HD;
  const float* vb = v + bh * (size_t)Sk * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    sQ[r * LD + c] = q0 + r < Sq ? qb[(size_t)(q0 + r) * HD + c] : 0.f;
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
      sK[r * LD + c] = in ? kb[g] : 0.f;
      sV[r * LD + c] = in ? vb[g] : 0.f;
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
    float* orow = o + (bh * (size_t)Sq + row) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[tx + kTX * c] = acc[i][c] / denom;
    if (tx == 0) {
      m_out[bh * (size_t)Sq + row] = m_run[i];
      l_out[bh * (size_t)Sq + row] = l_run[i];
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* m, float* l,
               int BH, int Sq, int Sk, float scale, int causal, int sk_valid, int q_offset,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(flash_attn_f32_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_attn_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, m, l, Sq, Sk, scale,
      causal, sk_valid, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kPTerms = 2;              // bf16 terms of P in the P.V product
constexpr int kTcWarps = 4;             // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
static_assert(kBQ == 16 * kTcWarps, "one m16 row tile per warp");
// CTAs per SM the register budget is cut for: 3 at hd <= 64 (no spills at
// ~160 registers), 2 above (hd 128 needs ~250)
constexpr int tc_min_blocks(int hd) { return hd <= 64 ? 3 : 2; }

template <int HD>
struct TcSmem {
  static constexpr int kRow = HD * 2 + 16;          // bytes per row, 16 of padding
  static constexpr int kTile = kBK * kRow;          // one K or V tile
  static constexpr int kQ = kBQ * kRow;
  static constexpr int kBytes = kQ + 2 * 2 * kTile;  // Q + 2 stages of (K, V)
  static_assert((kRow / 16) % 2 == 1, "rows must span an odd number of 16-byte units");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate; registers
// only, so the compiler may schedule it
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the next bf16 term of (x, y), packed x low; x and y keep what is left
__device__ __forceinline__ uint32_t split_term(float& x, float& y) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(x, y);
  x -= __low2float(t);
  y -= __high2float(t);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Scale, mask, and the online-softmax update of one 16 x 64 score tile.
// s[j][2h + e] is row g + 8h of the warp, key k0 + 8j + 2*t4 + e.  On return
// s holds p (f32), corr the factor for the output accumulator of row g + 8h.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 8][4], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2], float scale,
                                             int k0, int qpos0, int kv_lim, int causal,
                                             int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qpos0 + 8 * h;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][2 * h + e] * scale;
        if (MASK) {
          const int kpos = k0 + 8 * j + 2 * t4 + e;
          x = kpos < kv_lim && (!causal || kpos <= qpos) ? x : kNegInf;
        }
        s[j][2 * h + e] = x;
        tmax = fmaxf(tmax, x);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run[h], tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = expf(s[j][2 * h + e] - m_new);
        if (MASK) {
          const int kpos = k0 + 8 * j + 2 * t4 + e;
          p = kpos < kv_lim && (!causal || kpos <= qpos) ? p : 0.f;
        }
        s[j][2 * h + e] = p;
        psum += p;
      }
    corr[h] = expf(m_run[h] - m_new);
    l_run[h] = l_run[h] * corr[h] + psum;  // this thread's share; quad-summed at the end
    m_run[h] = m_new;
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(HD))
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk,
                       float scale, int causal, int sk_valid, int q_offset) {
  using L = TcSmem<HD>;
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int KC = HD / 16;       // k16 steps of Q K^T; 16-wide head-dim pairs of P V
  constexpr int NT = kBK / 8;       // n8 key tiles of a score tile
  constexpr int CPR = HD * 2 / 16;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t sQ = smem_addr(tc_smem);
  const uint32_t sKV = sQ + L::kQ;  // stage st: K at sKV + 2*st*kTile, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const __nv_bfloat16* qb = q + bh * (size_t)Sq * HD;
  const __nv_bfloat16* kb = k + bh * (size_t)Sk * HD;
  const __nv_bfloat16* vb = v + bh * (size_t)Sk * HD;

  const int kv_lim = min(sk_valid, Sk);
  const int kv_end = causal ? min(kv_lim, q0 + kBQ + q_offset) : kv_lim;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  // rows r0 .. r0 + 63 of a (S, HD) matrix into shared memory, zero past S:
  // thread tid < RPP * CPR copies chunk tid % CPR of rows tid / CPR + RPP * p
  constexpr int RPP = kTcThreads / CPR;  // rows per pass
  constexpr int PASSES = (kBK + RPP - 1) / RPP;
  const int ld_row = tid < RPP * CPR ? tid / CPR : kBK;  // kBK: copies nothing
  const uint32_t ld_dst = ld_row * L::kRow + (tid % CPR) * 16;
  const int ld_src = ld_row * HD + (tid % CPR) * 8;
  auto load_rows = [&](uint32_t dst, const __nv_bfloat16* src, int r0, int S) {
    const __nv_bfloat16* base = src + (size_t)r0 * HD + ld_src;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = ld_row + p * RPP;
      if (r < kBK) {
        const bool in = r0 + r < S;
        cp_async16(dst + ld_dst + p * RPP * L::kRow, in ? base + p * RPP * HD : src, in);
      }
    }
  };
  if (n_tiles > 0) {
    load_rows(sQ, qb, q0, Sq);
    load_rows(sKV, kb, 0, Sk);
    load_rows(sKV + L::kTile, vb, 0, Sk);
  }
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  uint32_t qf[KC][4];
  const int qpos0 = q0 + 16 * warp + g + q_offset;  // this thread's first row
  const int warp_qmin = q0 + 16 * warp + q_offset;  // the warp's first row

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const uint32_t sK = sKV + (t & 1) * 2 * L::kTile, sV = sK + L::kTile;
    __syncthreads();  // the stage written next (tile t - 1's) is no longer read
    if (t + 1 < n_tiles) {
      const uint32_t nK = sKV + ((t + 1) & 1) * 2 * L::kTile;
      load_rows(nK, kb, k0 + kBK, Sk);
      load_rows(nK + L::kTile, vb, k0 + kBK, Sk);
    }
    cp_async_commit();
    cp_async_wait1();  // every group but the newest has landed: Q and tile t
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        ldsm_x4(sQ + (16 * warp + lane % 16) * L::kRow + (16 * kk + 8 * (lane / 16)) * 2,
                qf[kk]);
    }

    // S = Q K^T: B fragments of key tiles 2np and 2np + 1 from one ldmatrix
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(sK + (16 * np + 8 * (lane / 16) + lane % 8) * L::kRow +
                    (16 * kk + 8 * ((lane / 8) % 2)) * 2,
                b);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // no key of the tile masked for any row of the warp: skip the mask
    const bool full = k0 + kBK <= kv_lim && (!causal || k0 + kBK - 1 <= warp_qmin);
    float corr[2];
    if (full)
      softmax_tile<false>(s, m_run, l_run, corr, scale, k0, qpos0, kv_lim, causal, t4);
    else
      softmax_tile<true>(s, m_run, l_run, corr, scale, k0, qpos0, kv_lim, causal, t4);
    // O = O * corr + P V, as the reference's acc * corr + dot(p, v): the
    // tile's P V is summed on the tensor cores from zero (P as kPTerms bf16
    // terms; s[2kc], s[2kc + 1] are the A fragment of keys 16kc .. 16kc + 15)
    // and added to O in f32 on the CUDA cores, so no tensor-core sum runs
    // longer than one tile
    uint32_t pa[NT / 2][kPTerms][4];
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc)
#pragma unroll
      for (int term = 0; term < kPTerms; ++term) {
        pa[kc][term][0] = split_term(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][term][1] = split_term(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][term][2] = split_term(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][term][3] = split_term(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
#pragma unroll
    for (int dp = 0; dp < KC; ++dp) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t b[4];
        ldsm_x4_trans(sV + (16 * kc + 8 * ((lane / 8) % 2) + lane % 8) * L::kRow +
                          (16 * dp + 8 * (lane / 16)) * 2,
                      b);
#pragma unroll
        for (int term = 0; term < kPTerms; ++term) {
          mma_bf16(t0, pa[kc][term], b[0], b[1]);
          mma_bf16(t1, pa[kc][term], b[2], b[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * dp][e] = fmaf(acc[2 * dp][e], corr[e / 2], t0[e]);
        acc[2 * dp + 1][e] = fmaf(acc[2 * dp + 1][e], corr[e / 2], t1[e]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= Sq) continue;
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + (bh * (size_t)Sq + row) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d + 2 * t4) =
          __floats2bfloat162_rn(acc[d][2 * h] / denom, acc[d][2 * h + 1] / denom);
    if (t4 == 0) {
      m_out[bh * (size_t)Sq + row] = m_run[h];
      l_out[bh * (size_t)Sq + row] = l;
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                int BH, int Sq, int Sk, float scale, int causal, int sk_valid, int q_offset,
                cudaStream_t stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  constexpr int smem = TcSmem<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_attn_bf16_kernel<HD><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, m, l, Sq, Sk, scale, causal, sk_valid, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// q, o are (BH, Sq, hd) and k, v (BH, Sk, hd), contiguous, all f32
// (is_bf16 = 0: the CUDA-core kernel) or all bf16 (is_bf16 = 1: the
// tensor-core kernel, 16-byte-aligned pointers); m, l are (BH, Sq) f32.
// hd is 32, 64, 80 or 128.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                                 float* m, float* l, int BH, int Sq, int Sk, int hd,
                                 int is_bf16, float scale, int causal, int sk_valid,
                                 int q_offset, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define FLASH_ATTN_CASE(HD)                                                                 \
  case HD:                                                                                  \
    return is_bf16 ? launch_bf16<HD>(q, k, v, o, m, l, BH, Sq, Sk, scale, causal, sk_valid, \
                                     q_offset, s)                                           \
                   : launch_f32<HD>(q, k, v, o, m, l, BH, Sq, Sk, scale, causal, sk_valid,  \
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
