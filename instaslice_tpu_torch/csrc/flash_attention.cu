// Flash attention for training, for Hopper: the forward (B5) and the two
// backward kernels (B6: dq, B7: dk and dv) over (B*H, S, hd) tensors.
//
// Replaces the Pallas kernels of instaslice_tpu/ops/flash_attention.py:
//   B5 _flash_kernel         (:73, launched by _flash_call:331)
//   B6 _flash_bwd_dq_kernel  (:130, launched by _flash_bwd_call:274)
//   B7 _flash_bwd_dkv_kernel (:183, launched by _flash_bwd_call:292)
// Same contract: fp32 accumulation whatever the input type (fp32 or
// bf16); sm_scale = hd**-0.5 multiplies q in the forward and s, dq and dk
// in the backward, as the TPU bodies apply it; masked logits are -1e30;
// the forward emits o and the per-row logsumexp lse = m + log(max(l,
// 1e-30)); the backward recomputes p = exp(s - lse) tile by tile, with
// ds = p * (dp - delta) and delta = rowsum(do * o) given (plain torch,
// outside the kernels, as in the TPU version). No (S, S) tensor exists.
//
// Bound on the H100: operations. At S = 1024, hd = 128 the three kernels
// do 4, 6 and 8 flops per (q, k, d) triple on the causal half, against
// ~1 KB of q/k/v/o per row: hundreds of flops per byte. So the products
// belong on the tensor cores: bf16 inputs (the training path) take them
// with fp32 sums, all three as warp-specialised wgmma kernels fed by TMA
// (namespace wg, helpers in hopper.cuh); fp32 inputs keep fp32 products
// on the CUDA cores (67 TFLOP/s peak), exact to fp32 sums.
//
// Every body loops over its own key or query tiles (no state carried
// between blocks), with causal block skipping (B5 and B6 stop at the
// diagonal tile, B7 starts at it; B5 and B6 launch the longest query
// tiles first); rows and keys past the end load as 0, their logits are
// masked (p = 0), and nothing past the end is written, so any S and
// kv_len run (causal attention requires S == kv_len, the wrapper checks);
// the softmax state and the accumulators stay in registers.
// The fp32 bodies use tiles of 64 query rows x 64 keys, row reductions
// by warp shuffles.
// CUDA-core path (fp32): 256 threads as a 16 x 16 grid; a thread owns a
// 4 x 4 patch of every 64 x 64 score tile and 4 rows x hd/16 columns of
// every 64 x hd accumulator; both operands of every product are read
// from shared memory "k-major" (the contracted index outermost), one
// float4 each per step: the row operand broadcast over a row group, the
// column operand 16 consecutive float4 (no bank conflicts).
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FA_THREADS = 256;
constexpr int FA_T = 64;           // rows of a query tile, keys of a key tile
constexpr int FA_PAD = 4;          // keeps float4 alignment, spreads banks
constexpr int LDT = FA_T + FA_PAD; // leading dim of a k-major tile [hd][LDT]
constexpr float FA_NEG = -1e30f;

template <int HD>
struct Dims {
  static constexpr int LDN = HD + FA_PAD;  // row-major tile [64][LDN]
  static constexpr int T_ELEMS = HD * LDT;
  static constexpr int N_ELEMS = FA_T * LDN;
  static constexpr int BUF = T_ELEMS > N_ELEMS ? T_ELEMS : N_ELEMS;
  static constexpr int NC = HD / 64;       // 64-column chunks of a row
};

// rows [row0, row0 + 64) of a row-major (n_rows, HD) fp32 matrix into a
// k-major tile: dst[d * LDT + r] = src[row0 + r][d] * scale (0 past the
// end). Consecutive lanes take consecutive rows, so the shared-memory
// writes are conflict-free; each lane reads one float4.
template <int HD>
__device__ __forceinline__ void load_kmajor(float* dst, const float* src,
                                            int row0, int n_rows,
                                            float scale) {
  for (int i = threadIdx.x; i < FA_T * HD / 4; i += FA_THREADS) {
    const int r = i % FA_T, d = (i / FA_T) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + d);
    dst[d * LDT + r] = v.x * scale;
    dst[(d + 1) * LDT + r] = v.y * scale;
    dst[(d + 2) * LDT + r] = v.z * scale;
    dst[(d + 3) * LDT + r] = v.w * scale;
  }
}

// the same rows into a row-major tile: dst[r * LDN + d] = src[row0 + r][d]
template <int HD>
__device__ __forceinline__ void load_rowmajor(float* dst, const float* src,
                                              int row0, int n_rows) {
  for (int i = threadIdx.x; i < FA_T * HD / 4; i += FA_THREADS) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + d);
    *reinterpret_cast<float4*>(dst + r * Dims<HD>::LDN + d) = v;
  }
}

// acc[i][4c + j] += sum_k A[k * lda + m0 + i] * B[k * ldb + n0 + 64c + j]
// for i, j < 4 and c < NC: both operands k-major in shared memory.
template <int K, int NC>
__device__ __forceinline__ void mm(float (&acc)[4][4 * NC], const float* A,
                                   int lda, const float* B, int ldb, int m0,
                                   int n0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + m0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[4 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + k * ldb + n0 + 64 * c);
      bv[4 * c] = b.x; bv[4 * c + 1] = b.y;
      bv[4 * c + 2] = b.z; bv[4 * c + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// reductions over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// write rows (ty*4 + r) < n_rows of a 64 x HD accumulator tile, times scale
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, int row0, int n_rows,
                                           const float (&acc)[4][HD / 16],
                                           const float* row_scale, int ty,
                                           int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      *reinterpret_cast<float4*>(dst + (size_t)row * HD + 64 * c + tx * 4) =
          make_float4(acc[r][4 * c] * row_scale[r],
                      acc[r][4 * c + 1] * row_scale[r],
                      acc[r][4 * c + 2] * row_scale[r],
                      acc[r][4 * c + 3] * row_scale[r]);
    }
  }
}

// ------------------------------------------ CUDA-core path (fp32 inputs)
// ---------------------------------------------------------------- B5
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
    fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int S, int KV, float sm_scale) {
  using D = Dims<HD>;
  extern __shared__ float smem[];
  float* qt = smem;               // [HD][LDT] q * sm_scale, k-major
  float* kv = qt + D::T_ELEMS;    // k (k-major), then v (row-major)
  float* pt = kv + D::BUF;        // [64 keys][LDT] p, k-major
  const int nq = (S + FA_T - 1) / FA_T;
  const int qi = CAUSAL ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qi * FA_T;
  const float* qb = q + (size_t)bh * S * HD;
  const float* kb = k + (size_t)bh * KV * HD;
  const float* vb = v + (size_t)bh * KV * HD;

  load_kmajor<HD>(qt, qb, q0, S, sm_scale);
  float m[4], l[4], acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = FA_NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[r][c] = 0.f;
  }
  const int nk = (KV + FA_T - 1) / FA_T;
  const int n_live = CAUSAL ? min(nk, qi + 1) : nk;
  for (int j = 0; j < n_live; ++j) {
    const int k0 = j * FA_T;
    __syncthreads();  // the previous tile's v reads are done
    load_kmajor<HD>(kv, kb, k0, KV, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    mm<HD, 1>(s, qt, LDT, kv, LDT, ty * 4, tx * 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      float mx = FA_NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx * 4 + c;
        const bool ok = kp < KV && (!CAUSAL || kp <= qp);
        if (!ok) s[r][c] = FA_NEG;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) pt[(tx * 4 + c) * LDT + ty * 4 + r] = s[r][c];
    __syncthreads();  // every thread is done with k
    load_rowmajor<HD>(kv, vb, k0, KV);
    __syncthreads();
    mm<FA_T, D::NC>(acc, pt, LDT, kv, D::LDN, ty * 4, tx * 4);
  }
  float inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[r][c] /= l[r];
    const int qp = q0 + ty * 4 + r;
    if (tx == 0 && qp < S) lse[(size_t)bh * S + qp] = m[r] + logf(l[r]);
  }
  store_rows<HD>(o + (size_t)bh * S * HD, q0, S, acc, inv, ty, tx);
}

// ---------------------------------------------------------------- B6
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
    fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int S, int KV, float sm_scale) {
  using D = Dims<HD>;
  extern __shared__ float smem[];
  float* qt = smem;                  // [HD][LDT] q, k-major
  float* dot = qt + D::T_ELEMS;      // [HD][LDT] do, k-major
  float* kt = dot + D::T_ELEMS;      // [HD][LDT] k, k-major
  float* buf = kt + D::T_ELEMS;      // v (k-major), then k (row-major)
  float* dst = buf + D::BUF;         // [64 keys][LDT] ds, k-major
  const int nq = (S + FA_T - 1) / FA_T;
  const int qi = CAUSAL ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qi * FA_T;
  const size_t qoff = (size_t)bh * S * HD, koff = (size_t)bh * KV * HD;

  load_kmajor<HD>(qt, q + qoff, q0, S, 1.f);
  load_kmajor<HD>(dot, dout + qoff, q0, S, 1.f);
  float lse_r[4], delta_r[4], acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    lse_r[r] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
    delta_r[r] = qp < S ? delta[(size_t)bh * S + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[r][c] = 0.f;
  }
  const int nk = (KV + FA_T - 1) / FA_T;
  const int n_live = CAUSAL ? min(nk, qi + 1) : nk;
  for (int j = 0; j < n_live; ++j) {
    const int k0 = j * FA_T;
    __syncthreads();  // the previous tile's reads of kt and buf are done
    load_kmajor<HD>(kt, k + koff, k0, KV, 1.f);
    load_kmajor<HD>(buf, v + koff, k0, KV, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    mm<HD, 1>(s, qt, LDT, kt, LDT, ty * 4, tx * 4);
    mm<HD, 1>(dp, dot, LDT, buf, LDT, ty * 4, tx * 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx * 4 + c;
        const bool ok = qp < S && kp < KV && (!CAUSAL || kp <= qp);
        const float p = ok ? expf(sm_scale * s[r][c] - lse_r[r]) : 0.f;
        dst[(tx * 4 + c) * LDT + ty * 4 + r] = p * (dp[r][c] - delta_r[r]);
      }
    }
    __syncthreads();  // every thread is done with v
    load_rowmajor<HD>(buf, k + koff, k0, KV);
    __syncthreads();
    mm<FA_T, D::NC>(acc, dst, LDT, buf, D::LDN, ty * 4, tx * 4);
  }
  const float sc[4] = {sm_scale, sm_scale, sm_scale, sm_scale};
  store_rows<HD>(dq + qoff, q0, S, acc, sc, ty, tx);
}

// ---------------------------------------------------------------- B7
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
    fa_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int KV, float sm_scale) {
  using D = Dims<HD>;
  extern __shared__ float smem[];
  float* kt = smem;                  // [HD][LDT] k, k-major
  float* vt = kt + D::T_ELEMS;       // [HD][LDT] v, k-major
  float* bq = vt + D::T_ELEMS;       // q: k-major, then row-major
  float* bdo = bq + D::BUF;          // do: k-major, then row-major
  float* pq = bdo + D::BUF;          // [64 queries][LDT] p, k-major
  float* dsq = pq + FA_T * LDT;      // [64 queries][LDT] ds, k-major
  float* lse_s = dsq + FA_T * LDT;   // [64]
  float* delta_s = lse_s + FA_T;     // [64]
  const int kj = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = kj * FA_T;
  const size_t qoff = (size_t)bh * S * HD, koff = (size_t)bh * KV * HD;

  load_kmajor<HD>(kt, k + koff, k0, KV, 1.f);
  load_kmajor<HD>(vt, v + koff, k0, KV, 1.f);
  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const int nq = (S + FA_T - 1) / FA_T;
  // causal (S == KV): query tiles before this key tile's diagonal see none
  // of its keys
  for (int i = CAUSAL ? kj : 0; i < nq; ++i) {
    const int q0 = i * FA_T;
    __syncthreads();  // the previous tile's reads of bq, bdo are done
    load_kmajor<HD>(bq, q + qoff, q0, S, 1.f);
    load_kmajor<HD>(bdo, dout + qoff, q0, S, 1.f);
    if (tid < FA_T) {
      const bool in = q0 + tid < S;
      lse_s[tid] = in ? lse[(size_t)bh * S + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[(size_t)bh * S + q0 + tid] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this block's keys, columns the queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[r][c] = dpt[r][c] = 0.f;
    mm<HD, 1>(st, kt, LDT, bq, LDT, ty * 4, tx * 4);
    mm<HD, 1>(dpt, vt, LDT, bdo, LDT, ty * 4, tx * 4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qc = tx * 4 + c, qp = q0 + qc;
      const float lq = lse_s[qc], dl = delta_s[qc];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kp = k0 + ty * 4 + r;
        const bool ok = qp < S && kp < KV && (!CAUSAL || kp <= qp);
        const float p = ok ? expf(sm_scale * st[r][c] - lq) : 0.f;
        pq[qc * LDT + ty * 4 + r] = p;
        dsq[qc * LDT + ty * 4 + r] = p * (dpt[r][c] - dl);
      }
    }
    __syncthreads();  // every thread is done with the k-major q and do
    load_rowmajor<HD>(bq, q + qoff, q0, S);
    load_rowmajor<HD>(bdo, dout + qoff, q0, S);
    __syncthreads();
    mm<FA_T, D::NC>(dv_acc, pq, LDT, bdo, D::LDN, ty * 4, tx * 4);
    mm<FA_T, D::NC>(dk_acc, dsq, LDT, bq, D::LDN, ty * 4, tx * 4);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float sc[4] = {sm_scale, sm_scale, sm_scale, sm_scale};
  store_rows<HD>(dk + koff, k0, KV, dk_acc, sc, ty, tx);
  store_rows<HD>(dv + koff, k0, KV, dv_acc, one, ty, tx);
}

// ------------------------- warp-specialised path (bf16, hd 128): B5-B7
// One block = one producer warpgroup and two consumer warpgroups (384
// threads, one block per SM). The producer (registers lowered to 40 by
// setmaxnreg) loads tiles by TMA into a ring of shared-memory stages, one
// "full" and one "empty" mbarrier per stage; the consumers (232 registers)
// run wgmma m64nNk16 on them, 64 rows each, accumulators in registers.
// Tiles are rows of hd = 128 bf16 stored as two 64-column boxes with
// 128-byte swizzle (csrc/hopper.cuh), read by wgmma straight from shared
// memory: K-major where hd is the contracted index (q k^T, do v^T,
// k q^T, v do^T), MN-major through the descriptor's transpose bit where
// the tile's rows are contracted (p v, ds k, p^T do, ds^T q), so no tile
// is ever transposed by a copy. As in FlashAttention-2, p and ds are
// rounded to bf16 in registers where they feed a product (the A operand
// of o = p v, dq = ds k, dv = p^T do, dk = ds^T q): one bf16 rounding of
// each term, below the rounding of the bf16 output itself. No kernel
// uses atomics: each block owns its rows (B5, B6) or keys (B7), so two
// runs are bit-equal. Exponentials are exp2 with log2(e) folded into the
// scale; only the tiles that cut the causal diagonal or the ragged end
// are masked. Rows past S and keys past kv_len load as zero (3-D tensor
// maps over (BH, rows, hd) never reach the next head) and are not written.
namespace wg {

using bf16 = __nv_bfloat16;
using hopper::ROW_BYTES;
constexpr int HD = 128;
constexpr int THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// B5: query rows per block and per consumer warpgroup, keys per tile
constexpr int FWD_BQ = 128, FWD_WQ = 64, FWD_TK = 128, FWD_STAGES = 3;
// B6: query rows per block and per consumer warpgroup, keys per tile
constexpr int DQ_BQ = 128, DQ_WQ = 64, DQ_TK = 64, DQ_STAGES = 4;
// B7: keys per block and per consumer warpgroup, query rows per tile
// and per score product (half a tile)
constexpr int DKV_BK = 128, DKV_WK = 64, DKV_TQ = 64, DKV_STAGES = 3;
constexpr int DKV_HQ = 32;

// bytes of a (rows, hd) bf16 tile, and the offset of its column box c
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return rows * HD * 2;
}
__host__ __device__ constexpr uint32_t box_off(int rows, int c) {
  return c * rows * ROW_BYTES;
}

// ---- tile schedules (mirrored in ops/flash_attention.py, tested there)
struct Span {
  int first, count;
};
// B5 block y: its query tile, longest first when causal
__host__ __device__ inline int fwd_query_tile(int S, bool causal, int y) {
  const int nq = (S + FWD_BQ - 1) / FWD_BQ;
  return causal ? nq - 1 - y : y;
}
// the key tiles of query tile qi: all, or up to the diagonal tile
// (causal: S == KV and FWD_BQ == FWD_TK, so tile qi holds the diagonal)
__host__ __device__ inline Span fwd_keys(int KV, bool causal, int qi) {
  const int nk = (KV + FWD_TK - 1) / FWD_TK;
  return {0, causal && qi + 1 < nk ? qi + 1 : nk};
}
// consumer warpgroup w of query tile qi has rows below S
__host__ __device__ inline bool fwd_live(int S, int qi, int w) {
  return qi * FWD_BQ + w * FWD_WQ < S;
}
// B6 block y: its query tile, longest first when causal
__host__ __device__ inline int dq_query_tile(int S, bool causal, int y) {
  const int nq = (S + DQ_BQ - 1) / DQ_BQ;
  return causal ? nq - 1 - y : y;
}
// the key tiles (from tile 0) that query rows up to `row_end` need: all,
// or up to the tile holding row_end - 1 when causal (S == KV)
__host__ __device__ inline int dq_key_count(int KV, bool causal,
                                            int row_end) {
  const int nk = (KV + DQ_TK - 1) / DQ_TK;
  const int diag = (row_end + DQ_TK - 1) / DQ_TK;
  return causal && diag < nk ? diag : nk;
}
// the key tiles block qi streams through its ring (its last warpgroup's)
__host__ __device__ inline int dq_block_keys(int KV, bool causal, int qi) {
  return dq_key_count(KV, causal, (qi + 1) * DQ_BQ);
}
// the key tiles consumer warpgroup w of query tile qi computes on (its
// diagonal tile last when causal); 0 when its rows all lie past S
__host__ __device__ inline int dq_keys(int S, int KV, bool causal, int qi,
                                       int w) {
  const int row0 = qi * DQ_BQ + w * DQ_WQ;
  return row0 < S ? dq_key_count(KV, causal, row0 + DQ_WQ) : 0;
}
// B7 block kj: its query tiles, from the first that reaches its keys
__host__ __device__ inline Span dkv_queries(int S, bool causal, int kj) {
  const int nq = (S + DKV_TQ - 1) / DKV_TQ;
  const int first = causal ? kj * DKV_BK / DKV_TQ : 0;
  return {first, nq - first};
}
// the first query tile consumer warpgroup w of block kj computes on (the
// tile holding its diagonal when causal: the ones before see none of its
// keys), and whether it has keys below KV at all
__host__ __device__ inline int dkv_first(bool causal, int kj, int w) {
  return causal ? (kj * DKV_BK + w * DKV_WK) / DKV_TQ : 0;
}
__host__ __device__ inline bool dkv_live(int KV, int kj, int w) {
  return kj * DKV_BK + w * DKV_WK < KV;
}

// reductions over the 4 lanes that share a row of a wgmma accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}
// the A fragments (k16 steps) of an m64nN fp32 accumulator, as bf16
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}
// the K-major descriptor of k16 step kk of a (rows, hd) tile at `tile`,
// from its row `row0`
__device__ __forceinline__ uint64_t k_step(uint32_t tile, int rows, int row0,
                                           int kk) {
  return hopper::kmajor_desc(tile + box_off(rows, kk / 4) + row0 * ROW_BYTES +
                             (kk % 4) * 32);
}
// the MN-major descriptor of k16 step kk (rows 16 kk ...) of such a tile
__device__ __forceinline__ uint64_t mn_step(uint32_t tile, int rows, int kk) {
  return hopper::desc(tile + kk * 16 * ROW_BYTES, box_off(rows, 1));
}
// write rows r0 and r0 + 8 (those below n_rows) of a warp's share of a
// 64 x 128 accumulator, times scale[], as bf16
__device__ __forceinline__ void store_rows(bf16* dst, int r0, int n_rows,
                                           const float (&d)[64],
                                           const float (&scale)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= n_rows) continue;
    bf16* row = dst + (size_t)(r0 + 8 * h) * HD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      *reinterpret_cast<uint32_t*>(row + 8 * nb) =
          pack(d[4 * nb + 2 * h] * scale[h],
                   d[4 * nb + 2 * h + 1] * scale[h]);
  }
}

// ---- B5
// shared memory from a 1024-byte boundary: Q, then K and V per stage,
// then the barriers (q full; k full, v full and empty per stage)
struct FwdSmem {
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + tile_bytes(FWD_BQ);
  static constexpr uint32_t V = K + FWD_STAGES * tile_bytes(FWD_TK);
  static constexpr uint32_t BAR = V + FWD_STAGES * tile_bytes(FWD_TK);
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 3 * FWD_STAGES) + 1024;
};
static_assert(FwdSmem::BYTES <= 232448, "B5 stages do not fit");

// one key tile of the online softmax on a warpgroup's 64 x 128 scores in
// the wgmma layout (element e: row r0 + 8 ((e >> 1) & 1), key k0 +
// 8 (e >> 2) + 2 t + (e & 1)): masks the diagonal tile (`diag`, the
// block's last when causal) or a ragged one to -inf, moves the row
// maxima m (log2 domain, quad-uniform) to the new ones with alpha =
// exp2(m_old - m_new), turns s into p = exp2(s sm log2e - m_new) in
// place and adds its row sums (this thread's part) into sum
template <bool CAUSAL>
__device__ __forceinline__ void fwd_softmax(float (&s)[64], float (&m)[2],
                                            float (&alpha)[2],
                                            float (&sum)[2], bool diag,
                                            int k0, int KV, int r0, int t,
                                            float sc) {
  if ((CAUSAL && diag) || k0 + FWD_TK > KV) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      const int row = r0 + 8 * ((e >> 1) & 1);
      if (key >= KV || (CAUSAL && key > row)) s[e] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 64; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]) * sc);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int h = (e >> 1) & 1;
    s[e] = ex2(fmaf(s[e], sc, -m[h]));
    sum[h] += s[e];
  }
}

// issue s = q k^T for consumer warpgroup w over the K tile of stage st:
// 8 k16 steps over hd, both operands K-major (committed, not waited)
__device__ __forceinline__ void fwd_scores(float (&s)[64], uint32_t base,
                                           int st, int w) {
  const uint32_t kt = base + FwdSmem::K + st * tile_bytes(FWD_TK);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_m64n128_ss(
        s, k_step(base + FwdSmem::Q, FWD_BQ, w * FWD_WQ, kk),
        k_step(kt, FWD_TK, 0, kk), kk > 0);
  hopper::wgmma_commit();
}

// issue o += p v over the V tile of stage st once it has landed: 8 k16
// steps over the tile's keys, p from registers, v MN-major (committed,
// not waited)
__device__ __forceinline__ void fwd_pv(float (&acc)[64],
                                       const uint32_t (&pa)[8][4],
                                       uint32_t base, int st, uint32_t par,
                                       uint64_t* v_full) {
  const uint32_t vt = base + FwdSmem::V + st * tile_bytes(FWD_TK);
  hopper::mbar_wait(v_full + st, par);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < FWD_TK / 16; ++kk)
    hopper::wgmma_m64n128_rs_t(acc, pa[kk], mn_step(vt, FWD_TK, kk), 1);
  hopper::wgmma_commit();
}

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               bf16* __restrict__ o, float* __restrict__ lse, int S, int KV,
               float sm_scale) {
  extern __shared__ uint8_t fwd_smem_raw[];
  uint8_t* sm = align1024(fwd_smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + FwdSmem::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FWD_STAGES;
  uint64_t* empty = v_full + FWD_STAGES;
  const int bh = blockIdx.x;
  const int qi = fwd_query_tile(S, CAUSAL, blockIdx.y);
  const Span keys = fwd_keys(KV, CAUSAL, qi);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    // ---- producer: Q once, then K and V tiles through the ring
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      hopper::mbar_arrive_expect_tx(q_full, tile_bytes(FWD_BQ));
      for (int c = 0; c < 2; ++c)
        hopper::tma_load_3d(sm + FwdSmem::Q + box_off(FWD_BQ, c), &q_map,
                            q_full, 64 * c, qi * FWD_BQ, bh);
      for (int n = 0; n < keys.count; ++n) {
        const int s = n % FWD_STAGES;
        hopper::mbar_wait(empty + s, ((n / FWD_STAGES) & 1) ^ 1);
        const int k0 = (keys.first + n) * FWD_TK;
        uint8_t* kt = sm + FwdSmem::K + s * tile_bytes(FWD_TK);
        uint8_t* vt = sm + FwdSmem::V + s * tile_bytes(FWD_TK);
        hopper::mbar_arrive_expect_tx(k_full + s, tile_bytes(FWD_TK));
        for (int c = 0; c < 2; ++c)
          hopper::tma_load_3d(kt + box_off(FWD_TK, c), &k_map, k_full + s,
                              64 * c, k0, bh);
        hopper::mbar_arrive_expect_tx(v_full + s, tile_bytes(FWD_TK));
        for (int c = 0; c < 2; ++c)
          hopper::tma_load_3d(vt + box_off(FWD_TK, c), &v_map, v_full + s,
                              64 * c, k0, bh);
      }
    }
  } else {
    // ---- consumer warpgroup w: query rows [q0 + 64 w, q0 + 64 w + 64).
    // Tile n's p v is issued together with tile n + 1's q k^T, and tile
    // n + 1's softmax runs while p v is on the tensor cores.
    hopper::regs_inc<CONSUMER_REGS>();
    const int w = role - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = qi * FWD_BQ + w * FWD_WQ + warp * 16 + g;  // and r0 + 8
    const bool live = fwd_live(S, qi, w);
    const uint32_t base = hopper::smem_u32(sm);
    const float sc = sm_scale * LOG2E;
    if (!live) {
      // no rows below S: only keep the ring's phases in step
      for (int n = 0; n < keys.count; ++n) {
        const int st = n % FWD_STAGES;
        hopper::mbar_wait(k_full + st, (n / FWD_STAGES) & 1);
        hopper::mbar_arrive(empty + st);
      }
      return;
    }
    float acc[64], s[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};  // m: log2 domain
    float alpha[2];
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full, 0);
    fwd_scores(s, base, 0, w);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    fwd_softmax<CAUSAL>(s, m, alpha, l, keys.count == 1, keys.first * FWD_TK,
                        KV, r0, t, sc);
    to_a<128>(pa, s);
    // every tile but the last: its p v and the next tile's q k^T in flight
    // together (the loop issues both unconditionally, so ptxas keeps the
    // wgmma pipeline), the next softmax under the p v
    for (int n = 0; n + 1 < keys.count; ++n) {
      const int st = n % FWD_STAGES, st1 = (n + 1) % FWD_STAGES;
      const uint32_t sb = hopper::opaque(base);
      hopper::mbar_wait(k_full + st1, ((n + 1) / FWD_STAGES) & 1);
      fwd_scores(s, sb, st1, w);
      fwd_pv(acc, pa, sb, st, (n / FWD_STAGES) & 1, v_full);
      hopper::wgmma_wait<1>();  // q k^T done, p v in flight
      hopper::fence_regs(s);
      float sum[2] = {0.f, 0.f};
      fwd_softmax<CAUSAL>(s, m, alpha, sum, n + 2 == keys.count,
                          (keys.first + n + 1) * FWD_TK, KV, r0, t, sc);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(empty + st);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
      to_a<128>(pa, s);
    }
    const int last = keys.count - 1;
    fwd_pv(acc, pa, base, last % FWD_STAGES, (last / FWD_STAGES) & 1, v_full);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(empty + last % FWD_STAGES);
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lq = fmaxf(quad_sum(l[h]), 1e-30f);
      inv[h] = __fdividef(1.f, lq);  // lq >= 1; no slow-path call
      const int row = r0 + 8 * h;
      if (t == 0 && row < S)
        lse[(size_t)bh * S + row] = m[h] * LN2 + logf(lq);
    }
    store_rows(o + (size_t)bh * S * HD, r0, S, acc, inv, t);
  }
}

// ---- B6
// shared memory from a 1024-byte boundary: Q and dO (the block's 128
// rows), then K and V per stage, then the barriers (q/do full; full and
// empty per stage)
struct DqSmem {
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DO = Q + tile_bytes(DQ_BQ);
  static constexpr uint32_t K = DO + tile_bytes(DQ_BQ);
  static constexpr uint32_t V = K + DQ_STAGES * tile_bytes(DQ_TK);
  static constexpr uint32_t BAR = V + DQ_STAGES * tile_bytes(DQ_TK);
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 2 * DQ_STAGES) + 1024;
};
static_assert(DqSmem::BYTES <= 232448, "B6 stages do not fit");

// dq = sm ds k with ds = p (dp - delta), p = exp(s sm - lse) recomputed,
// s = q k^T and dp = do v^T, over the 128 query rows of block (bh, y):
// per key tile of DQ_TK keys each consumer warpgroup issues s and dp
// (two m64n64 products over hd, all four operands K-major) under one
// commit, turns them into ds in registers (masked only on the tile that
// cuts its diagonal or the ragged end), rounds ds to bf16 as the A
// operand of dq += ds k (m64n128 over the tile's keys, k MN-major) and
// releases the stage once that product has read it
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int KV, float sm_scale) {
  extern __shared__ uint8_t dq_smem_raw[];
  uint8_t* sm = align1024(dq_smem_raw);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + DqSmem::BAR);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + DQ_STAGES;
  const int bh = blockIdx.x;
  const int qi = dq_query_tile(S, CAUSAL, blockIdx.y);
  const int n_tiles = dq_block_keys(KV, CAUSAL, qi);
  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    // ---- producer: Q and dO once, then K and V tiles through the ring
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      hopper::mbar_arrive_expect_tx(qd_full, 2 * tile_bytes(DQ_BQ));
      for (int c = 0; c < 2; ++c) {
        hopper::tma_load_3d(sm + DqSmem::Q + box_off(DQ_BQ, c), &q_map,
                            qd_full, 64 * c, qi * DQ_BQ, bh);
        hopper::tma_load_3d(sm + DqSmem::DO + box_off(DQ_BQ, c), &do_map,
                            qd_full, 64 * c, qi * DQ_BQ, bh);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % DQ_STAGES;
        hopper::mbar_wait(empty + s, ((n / DQ_STAGES) & 1) ^ 1);
        uint8_t* kt = sm + DqSmem::K + s * tile_bytes(DQ_TK);
        uint8_t* vt = sm + DqSmem::V + s * tile_bytes(DQ_TK);
        hopper::mbar_arrive_expect_tx(full + s, 2 * tile_bytes(DQ_TK));
        for (int c = 0; c < 2; ++c) {
          hopper::tma_load_3d(kt + box_off(DQ_TK, c), &k_map, full + s,
                              64 * c, n * DQ_TK, bh);
          hopper::tma_load_3d(vt + box_off(DQ_TK, c), &v_map, full + s,
                              64 * c, n * DQ_TK, bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroup w: query rows [q0 + 64 w, q0 + 64 w + 64)
    hopper::regs_inc<CONSUMER_REGS>();
    const int w = role - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = qi * DQ_BQ + w * DQ_WQ;
    const int r0 = row0 + warp * 16 + g;  // and r0 + 8
    const int count = dq_keys(S, KV, CAUSAL, qi, w);
    const uint32_t base = hopper::smem_u32(sm);
    const float sc = sm_scale * LOG2E;
    // lse (log2 domain) and delta of this thread's two rows; rows past S
    // have q = do = 0 (zero-filled tiles), so their ds is 0
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      lse2[h] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
      dl[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    if (count > 0) hopper::mbar_wait(qd_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % DQ_STAGES;
      hopper::mbar_wait(full + st, (n / DQ_STAGES) & 1);
      if (n < count) {
        const uint32_t sb = hopper::opaque(base);
        const uint32_t kt = sb + DqSmem::K + st * tile_bytes(DQ_TK);
        const uint32_t vt = sb + DqSmem::V + st * tile_bytes(DQ_TK);
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::wgmma_m64n64_ss(s, k_step(sb + DqSmem::Q, DQ_BQ, w * DQ_WQ,
                                            kk),
                                  k_step(kt, DQ_TK, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::wgmma_m64n64_ss(dp, k_step(sb + DqSmem::DO, DQ_BQ,
                                             w * DQ_WQ, kk),
                                  k_step(vt, DQ_TK, 0, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        // element e: row r0 + 8 ((e >> 1) & 1), key k0 + 8 (e >> 2) +
        // 2 t + (e & 1); ds in place of s
        const int k0 = n * DQ_TK;
        const bool edge =
            (CAUSAL && k0 + DQ_TK - 1 > row0) || k0 + DQ_TK > KV;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h = (e >> 1) & 1;
          float p = ex2(fmaf(s[e], sc, -lse2[h]));
          if (edge) {
            const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            if (key >= KV || (CAUSAL && key > r0 + 8 * h)) p = 0.f;
          }
          s[e] = p * (dp[e] - dl[h]);
        }
        uint32_t da[DQ_TK / 16][4];
        to_a<DQ_TK>(da, s);
        // dq += ds k: k16 steps over the tile's keys, k MN-major
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_TK / 16; ++kk)
          hopper::wgmma_m64n128_rs_t(acc, da[kk], mn_step(kt, DQ_TK, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(da);
      }
      hopper::mbar_arrive(empty + st);  // after dq's product read k
    }
    if (count > 0) {
      const float sc_q[2] = {sm_scale, sm_scale};
      store_rows(dq + (size_t)bh * S * HD, r0, S, acc, sc_q, t);
    }
  }
}

// ---- B7
// shared memory from a 1024-byte boundary: K, V, then per stage Q and
// dO, then lse * log2(e) and delta per stage, then the barriers (k/v
// full; full and empty per stage)
struct DkvSmem {
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + tile_bytes(DKV_BK);
  static constexpr uint32_t Q = V + tile_bytes(DKV_BK);
  static constexpr uint32_t DO = Q + DKV_STAGES * tile_bytes(DKV_TQ);
  static constexpr uint32_t LSE = DO + DKV_STAGES * tile_bytes(DKV_TQ);
  static constexpr uint32_t DELTA = LSE + DKV_STAGES * DKV_TQ * 4;
  static constexpr uint32_t BAR = DELTA + DKV_STAGES * DKV_TQ * 4;
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 2 * DKV_STAGES) + 1024;
};
static_assert(DkvSmem::BYTES <= 232448, "B7 stages do not fit");

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int KV,
               float sm_scale) {
  extern __shared__ uint8_t dkv_smem_raw[];
  uint8_t* sm = align1024(dkv_smem_raw);
  float* lse_s = reinterpret_cast<float*>(sm + DkvSmem::LSE);
  float* delta_s = reinterpret_cast<float*>(sm + DkvSmem::DELTA);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + DkvSmem::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;
  const int bh = blockIdx.x, kj = blockIdx.y;
  const Span qs = dkv_queries(S, CAUSAL, kj);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(full + s, 32);
      hopper::mbar_init(empty + s, 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 0) {
    // ---- producer warp: K and V once, then (Q, dO, lse, delta) tiles
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 < 32) {
      const int lane = threadIdx.x % 128;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * tile_bytes(DKV_BK));
        for (int c = 0; c < 2; ++c) {
          hopper::tma_load_3d(sm + DkvSmem::K + box_off(DKV_BK, c), &k_map,
                              kv_full, 64 * c, kj * DKV_BK, bh);
          hopper::tma_load_3d(sm + DkvSmem::V + box_off(DKV_BK, c), &v_map,
                              kv_full, 64 * c, kj * DKV_BK, bh);
        }
      }
      for (int n = 0; n < qs.count; ++n) {
        const int s = n % DKV_STAGES;
        hopper::mbar_wait(empty + s, ((n / DKV_STAGES) & 1) ^ 1);
        const int q0 = (qs.first + n) * DKV_TQ;
        if (lane == 0) {
          uint8_t* qt = sm + DkvSmem::Q + s * tile_bytes(DKV_TQ);
          uint8_t* dot = sm + DkvSmem::DO + s * tile_bytes(DKV_TQ);
          hopper::mbar_expect_tx(full + s, 2 * tile_bytes(DKV_TQ));
          for (int c = 0; c < 2; ++c) {
            hopper::tma_load_3d(qt + box_off(DKV_TQ, c), &q_map, full + s,
                                64 * c, q0, bh);
            hopper::tma_load_3d(dot + box_off(DKV_TQ, c), &do_map, full + s,
                                64 * c, q0, bh);
          }
        }
        // lse and delta of the tile's rows by plain loads (a TMA map over
        // (BH, S) fp32 would need S % 4 == 0)
        for (int r = lane; r < DKV_TQ; r += 32) {
          const bool in = q0 + r < S;
          const size_t i = (size_t)bh * S + q0 + r;
          lse_s[s * DKV_TQ + r] = in ? lse[i] * LOG2E : 0.f;
          delta_s[s * DKV_TQ + r] = in ? delta[i] : 0.f;
        }
        hopper::mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumer warpgroup w: keys [k0 + 64 w, k0 + 64 w + 64)
    hopper::regs_inc<CONSUMER_REGS>();
    const int w = role - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kr0 = kj * DKV_BK + w * DKV_WK + warp * 16 + g;  // and + 8
    const bool live = dkv_live(KV, kj, w);
    const int first = dkv_first(CAUSAL, kj, w);
    const uint32_t base = hopper::smem_u32(sm);
    const float sc = sm_scale * LOG2E;
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) dk_acc[e] = dv_acc[e] = 0.f;
    if (live) hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < qs.count; ++n) {
      const int s = n % DKV_STAGES;
      const int i = qs.first + n, q0 = i * DKV_TQ;
      hopper::mbar_wait(full + s, (n / DKV_STAGES) & 1);
      if (live && i >= first) {
        const uint32_t sb = hopper::opaque(base);
        const uint32_t qt = sb + DkvSmem::Q + s * tile_bytes(DKV_TQ);
        const uint32_t dot = sb + DkvSmem::DO + s * tile_bytes(DKV_TQ);
        const float* ls = lse_s + s * DKV_TQ;
        const float* dl = delta_s + s * DKV_TQ;
        const bool edge = (CAUSAL && i == first) || q0 + DKV_TQ > S;
        // the tile's queries in two halves of DKV_HQ, one at a time, so
        // that the score tiles (16 fp32 each) fit beside dk and dv in
        // registers
#pragma unroll 1
        for (int hq = 0; hq < DKV_TQ / DKV_HQ; ++hq) {
          float st[16], dpt[16];
          // s^T = k q^T and dp^T = v do^T: rows this warpgroup's keys,
          // columns the half's queries; all four operands K-major
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            hopper::wgmma_m64n32_ss(
                st, k_step(sb + DkvSmem::K, DKV_BK, w * DKV_WK, kk),
                k_step(qt, DKV_TQ, hq * DKV_HQ, kk), kk > 0);
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            hopper::wgmma_m64n32_ss(
                dpt, k_step(sb + DkvSmem::V, DKV_BK, w * DKV_WK, kk),
                k_step(dot, DKV_TQ, hq * DKV_HQ, kk), kk > 0);
          hopper::wgmma_commit();
          // p^T = exp2(s^T sm log2e - lse log2e) while dp^T is in flight;
          // element e: key kr0 + 8 ((e >> 1) & 1), query column
          // hq DKV_HQ + 8 (e >> 2) + 2 t + (e & 1)
          hopper::wgmma_wait<1>();
          hopper::fence_regs(st);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int qc = hq * DKV_HQ + 8 * (e >> 2) + 2 * t + (e & 1);
            float p = ex2(fmaf(st[e], sc, -ls[qc]));
            if (edge) {
              const int key = kr0 + 8 * ((e >> 1) & 1);
              if (q0 + qc >= S || (CAUSAL && key > q0 + qc)) p = 0.f;
            }
            st[e] = p;
          }
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dpt);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int qc = hq * DKV_HQ + 8 * (e >> 2) + 2 * t + (e & 1);
            dpt[e] = st[e] * (dpt[e] - dl[qc]);  // ds^T
          }
          uint32_t pa[2][4], da[2][4];
          to_a<32>(pa, st);
          to_a<32>(da, dpt);
          // dv += p^T do and dk += ds^T q: 2 k16 steps over the half's
          // queries, do and q MN-major
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DKV_HQ / 16; ++kk)
            hopper::wgmma_m64n128_rs_t(
                dv_acc, pa[kk], mn_step(dot, DKV_TQ, hq * DKV_HQ / 16 + kk), 1);
#pragma unroll
          for (int kk = 0; kk < DKV_HQ / 16; ++kk)
            hopper::wgmma_m64n128_rs_t(
                dk_acc, da[kk], mn_step(qt, DKV_TQ, hq * DKV_HQ / 16 + kk), 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
          hopper::fence_regs(pa);
          hopper::fence_regs(da);
        }
      }
      hopper::mbar_arrive(empty + s);
    }
    if (live) {
      const float sc_k[2] = {sm_scale, sm_scale}, one[2] = {1.f, 1.f};
      const size_t off = (size_t)bh * KV * HD;
      store_rows(dk + off, kr0, KV, dk_acc, sc_k, t);
      store_rows(dv + off, kr0, KV, dv_acc, one, t);
    }
  }
}

}  // namespace wg

// shared-memory bytes of the CUDA-core kernels
template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (Dims<HD>::T_ELEMS + Dims<HD>::BUF + FA_T * LDT);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (3 * Dims<HD>::T_ELEMS + Dims<HD>::BUF + FA_T * LDT);
}
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * Dims<HD>::T_ELEMS + 2 * Dims<HD>::BUF +
                          2 * FA_T * LDT + 2 * FA_T);
}
static_assert(dkv_smem<128>() <= 232448, "B7 tile does not fit");

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int BH, S, KV;
  float sm_scale;
  cudaStream_t st;
};

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// process and kernel (the first launch happens outside any CUDA graph
// capture, so a captured launch never makes this call). One card per
// process.
template <typename F>
cudaError_t allow_smem(F* fn, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// fp32 inputs: the CUDA-core kernels, 64-row tiles
template <int HD, bool CAUSAL>
int launch_f32(int which, const Args& a) {
  static bool smem_ok[3] = {false, false, false};
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const dim3 q_grid((a.S + FA_T - 1) / FA_T, a.BH);
  const dim3 k_grid((a.KV + FA_T - 1) / FA_T, a.BH);
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    auto* fn = fa_fwd_kernel<HD, CAUSAL>;
    if ((err = allow_smem(fn, fwd_smem<HD>(), smem_ok[0])) != cudaSuccess)
      return (int)err;
    fn<<<q_grid, FA_THREADS, fwd_smem<HD>(), a.st>>>(
        q, k, v, static_cast<float*>(a.o), static_cast<float*>(a.lse_out),
        a.S, a.KV, a.sm_scale);
  } else if (which == 1) {
    auto* fn = fa_bwd_dq_kernel<HD, CAUSAL>;
    if ((err = allow_smem(fn, dq_smem<HD>(), smem_ok[1])) != cudaSuccess)
      return (int)err;
    fn<<<q_grid, FA_THREADS, dq_smem<HD>(), a.st>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.dq), a.S, a.KV,
        a.sm_scale);
  } else {
    auto* fn = fa_bwd_dkv_kernel<HD, CAUSAL>;
    if ((err = allow_smem(fn, dkv_smem<HD>(), smem_ok[2])) != cudaSuccess)
      return (int)err;
    fn<<<k_grid, FA_THREADS, dkv_smem<HD>(), a.st>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.S, a.KV, a.sm_scale);
  }
  return (int)cudaGetLastError();
}

// bf16 inputs at hd 128: the warp-specialised kernels of namespace wg.
// Tensor maps are encoded on every launch.
template <bool CAUSAL>
int launch_bf16(int which, const Args& a) {
  using bf16 = __nv_bfloat16;
  constexpr int HD = wg::HD;
  static bool smem_ok[3] = {false, false, false};
  cudaError_t err = cudaSuccess;
  CUtensorMap q_map, k_map, v_map, do_map;
  const int q_box = which == 0 ? wg::FWD_BQ
                               : (which == 1 ? wg::DQ_BQ : wg::DKV_TQ);
  const int k_box = which == 0 ? wg::FWD_TK
                               : (which == 1 ? wg::DQ_TK : wg::DKV_BK);
  if (!hopper::tma_map_bf16(&q_map, a.q, a.BH, a.S, HD, q_box) ||
      !hopper::tma_map_bf16(&k_map, a.k, a.BH, a.KV, HD, k_box) ||
      !hopper::tma_map_bf16(&v_map, a.v, a.BH, a.KV, HD, k_box))
    return (int)cudaErrorInvalidValue;
  if (which == 0) {
    auto* fn = wg::fwd_kernel<CAUSAL>;
    if ((err = allow_smem(fn, wg::FwdSmem::BYTES, smem_ok[0])) != cudaSuccess)
      return (int)err;
    const dim3 grid(a.BH, (a.S + wg::FWD_BQ - 1) / wg::FWD_BQ);
    fn<<<grid, wg::THREADS, wg::FwdSmem::BYTES, a.st>>>(
        q_map, k_map, v_map, static_cast<bf16*>(a.o),
        static_cast<float*>(a.lse_out), a.S, a.KV, a.sm_scale);
    return (int)cudaGetLastError();
  }
  if (!hopper::tma_map_bf16(&do_map, a.dout, a.BH, a.S, HD, q_box))
    return (int)cudaErrorInvalidValue;
  if (which == 1) {
    auto* fn = wg::dq_kernel<CAUSAL>;
    if ((err = allow_smem(fn, wg::DqSmem::BYTES, smem_ok[1])) != cudaSuccess)
      return (int)err;
    const dim3 grid(a.BH, (a.S + wg::DQ_BQ - 1) / wg::DQ_BQ);
    fn<<<grid, wg::THREADS, wg::DqSmem::BYTES, a.st>>>(
        q_map, k_map, v_map, do_map, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.S,
        a.KV, a.sm_scale);
    return (int)cudaGetLastError();
  }
  auto* fn = wg::dkv_kernel<CAUSAL>;
  if ((err = allow_smem(fn, wg::DkvSmem::BYTES, smem_ok[2])) != cudaSuccess)
    return (int)err;
  const dim3 grid(a.BH, (a.KV + wg::DKV_BK - 1) / wg::DKV_BK);
  fn<<<grid, wg::THREADS, wg::DkvSmem::BYTES, a.st>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.S, a.KV, a.sm_scale);
  return (int)cudaGetLastError();
}

// hd 128 only: every configuration on the port's training path uses it
int dispatch(int which, int dtype, int HD, int causal, const Args& a) {
  if (a.BH <= 0 || a.S <= 0 || a.KV <= 0 || a.BH > 65535 || HD != 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == ISL_F32)
    return causal ? launch_f32<128, true>(which, a)
                  : launch_f32<128, false>(which, a);
  if (dtype == ISL_BF16)
    return causal ? launch_bf16<true>(which, a) : launch_bf16<false>(which, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All tensors contiguous. q (BH, S, HD), k and v (BH, KV, HD), all of one
// dtype (fp32 or bf16) -> o (BH, S, HD) in that dtype and lse (BH, S)
// fp32. Returns the launch's cudaError_t.
int isl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int dtype, int BH, int S, int KV, int HD,
                  int causal, float sm_scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr,
         nullptr, BH, S, KV, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, HD, causal, a);
}

// + do (BH, S, HD) in the input dtype, lse and delta (BH, S) fp32 ->
// dq (BH, S, HD) in the input dtype
int isl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int dtype, int BH, int S, int KV, int HD,
                     int causal, float sm_scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr,
         nullptr, BH, S, KV, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, HD, causal, a);
}

// the same inputs -> dk and dv (BH, KV, HD) in the input dtype
int isl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int dtype, int BH, int S, int KV,
                      int HD, int causal, float sm_scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk,
         dv, BH, S, KV, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(2, dtype, HD, causal, a);
}

// The bf16 kernels' tile schedule, for the tests to hold
// ops/flash_attention.py's mirror against: the tile constants, and the
// tiles one consumer warpgroup visits. B5 (kernel 0) and B6 (kernel 1):
// block y, warpgroup w -> its query tile and the first and number of key
// tiles it computes on (0 when its rows all lie past S). B7 (kernel 2):
// key block y, warpgroup w -> its first query tile and their number (0
// when its keys all lie past KV).
int isl_flash_tile_consts(int* out) {
  const int v[12] = {wg::FWD_BQ, wg::FWD_WQ, wg::FWD_TK, wg::FWD_STAGES,
                     wg::DQ_BQ,  wg::DQ_WQ,  wg::DQ_TK,  wg::DQ_STAGES,
                     wg::DKV_BK, wg::DKV_WK, wg::DKV_TQ, wg::DKV_STAGES};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

int isl_flash_tiles(int which, int S, int KV, int causal, int y, int w,
                    int* tile, int* first, int* count) {
  if (which == 0) {
    *tile = wg::fwd_query_tile(S, causal, y);
    const wg::Span keys = wg::fwd_keys(KV, causal, *tile);
    const bool live = wg::fwd_live(S, *tile, w);
    *first = keys.first;
    *count = live ? keys.count : 0;
    return 0;
  }
  if (which == 1) {
    *tile = wg::dq_query_tile(S, causal, y);
    *first = 0;
    *count = wg::dq_keys(S, KV, causal, *tile, w);
    return 0;
  }
  if (which == 2) {
    *tile = y;
    const wg::Span qs = wg::dkv_queries(S, causal, y);
    const int f = wg::dkv_first(causal, y, w);
    *first = f;
    *count = wg::dkv_live(KV, y, w) ? qs.first + qs.count - f : 0;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
