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
// belong on the tensor cores: bf16 inputs (the training path) take
// mma.sync m16n8k16 with fp32 sums (namespace tc below); fp32 inputs keep
// fp32 products on the CUDA cores (67 TFLOP/s peak), exact to fp32 sums.
// wgmma with TMA-fed tiles is the later redesign.
//
// Design, common to both paths (one body per kernel and path, templated
// on hd and causal):
// - tiles of 64 query rows x 64 keys; causal block skipping: B5 and B6
//   stop at the diagonal tile, B7 starts at it; B5/B6 launch the longest
//   query tiles first;
// - any S and kv_len: rows and keys past the end load as 0, their
//   logits are masked (p = 0), and nothing past the end is written.
//   Causal attention requires S == kv_len (the wrapper checks);
// - the softmax state (m, l) and the accumulators stay in registers;
//   row reductions are warp shuffles.
// CUDA-core path (fp32): 256 threads as a 16 x 16 grid; a thread owns a
// 4 x 4 patch of every 64 x 64 score tile and 4 rows x hd/16 columns of
// every 64 x hd accumulator; both operands of every product are read
// from shared memory "k-major" (the contracted index outermost), one
// float4 each per step: the row operand broadcast over a row group, the
// column operand 16 consecutive float4 (no bank conflicts).
#include <cstring>
#include <type_traits>

#include "common.cuh"

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

// ------------------------------------------ tensor-core path (bf16 inputs)
// bf16 inputs take mma.sync m16n8k16 (bf16 operands, fp32 sums) with
// the same tiles (64 query rows x 64 keys) and the same masking and
// causal skipping as the CUDA-core bodies above, which fp32 inputs keep.
// Four warps per block, each owning 16 rows of every product; tiles stay
// bf16 in shared memory (row stride hd + 8: the fragment loads below hit
// 32 distinct banks); scores, the softmax state and the accumulators
// live in registers in the mma C layout. As in FlashAttention-2, p and
// ds are rounded to bf16 where they feed a product (o = p v, dq = ds k,
// dv = p^T do, dk = ds^T q): one bf16 rounding of each term, below the
// rounding of the bf16 output itself. The forward scales the fp32 scores
// by sm_scale instead of q (a bf16 q * sm_scale would round q).
namespace tc {

constexpr int THREADS = 128;
using bf16 = __nv_bfloat16;

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// A fragment: rows [r0, r0 + 16) x columns [c0, c0 + 16) of X
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* X,
                                       int ldx, int r0, int c0, int g,
                                       int t) {
  const bf16* p = X + (r0 + g) * ldx + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ldx);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ldx + 8);
}
// B fragment of B[k][n] = Y[n0 + n][k0 + k] (Y's rows are the n index)
__device__ __forceinline__ void frag_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* Y, int ldy, int n0,
                                        int k0, int g, int t) {
  const bf16* p = Y + (n0 + g) * ldy + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}
// B fragment of B[k][n] = Z[k0 + k][n0 + n] (Z's rows are the k index)
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* Z, int ldz, int k0,
                                       int n0, int g, int t) {
  const bf16* p = Z + (k0 + 2 * t) * ldz + n0 + g;
  b0 = pack(p[0], p[ldz]);
  b1 = pack(p[8 * ldz], p[9 * ldz]);
}
// the A fragment of columns [16j, 16j + 16) of a C-layout score tile
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [row0, row0 + 64) of a row-major (n_rows, HD) bf16 matrix into a
// tile of stride ld<HD>() (zeros past the end), 16 bytes per thread
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n_rows) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < FA_T * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld<HD>() + c) = v;
  }
}

// store rows g and g + 8 of a warp's 16 x HD accumulator, times scale[]
template <int HD>
__device__ __forceinline__ void store16(bf16* dst, int row, int n_rows,
                                        const float (&acc)[HD / 8][4],
                                        const float (&scale)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n_rows) continue;
    bf16* p = dst + (size_t)(row + 8 * h) * HD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(p + nt * 8) =
          pack(acc[nt][2 * h] * scale[h], acc[nt][2 * h + 1] * scale[h]);
  }
}

// ---- B5 on tensor cores
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int S, int KV, float sm_scale) {
  constexpr int L = ld<HD>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* ks = qs + FA_T * L;
  bf16* vs = ks + FA_T * L;
  const int nq = (S + FA_T - 1) / FA_T;
  const int qi = CAUSAL ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int q0 = qi * FA_T;
  const int qp[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const size_t koff = (size_t)bh * KV * HD;

  load_tile<HD>(qs, q + (size_t)bh * S * HD, q0, S);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) frag_a(qa[kk], qs, L, r0, kk * 16, g, t);
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
  const int nk = (KV + FA_T - 1) / FA_T;
  const int n_live = CAUSAL ? min(nk, qi + 1) : nk;
  for (int j = 0; j < n_live; ++j) {
    const int k0 = j * FA_T;
    __syncthreads();  // every warp is done with the previous k and v
    load_tile<HD>(ks, k + koff, k0, KV);
    load_tile<HD>(vs, v + koff, k0, KV);
    __syncthreads();
    float s[FA_T / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_T / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < FA_T / 8; ++nt) {
        uint32_t b0, b1;
        frag_bt(b0, b1, ks, L, nt * 8, kk * 16, g, t);
        mma(s[nt], qa[kk], b0, b1);
      }
    float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
    for (int nt = 0; nt < FA_T / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * t + (e & 1), h = e >> 1;
        const bool ok = kp < KV && (!CAUSAL || kp <= qp[h]);
        s[nt][e] = ok ? s[nt][e] * sm_scale : FA_NEG;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < FA_T / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < FA_T / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t b0, b1;
        frag_b(b0, b1, vs, L, kk * 16, nt * 8, g, t);
        mma(acc[nt], a, b0, b1);
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / l[h];
    if (t == 0 && qp[h] < S) lse[(size_t)bh * S + qp[h]] = m[h] + logf(l[h]);
  }
  store16<HD>(o + (size_t)bh * S * HD, qp[0], S, acc, inv, t);
}

// ---- B6 on tensor cores
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, int KV, float sm_scale) {
  constexpr int L = ld<HD>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + FA_T * L;
  bf16* ks = dos + FA_T * L;
  bf16* vs = ks + FA_T * L;
  const int nq = (S + FA_T - 1) / FA_T;
  const int qi = CAUSAL ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int q0 = qi * FA_T;
  const int qp[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const size_t qoff = (size_t)bh * S * HD, koff = (size_t)bh * KV * HD;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = qp[h] < S ? lse[(size_t)bh * S + qp[h]] : 0.f;
    delta_r[h] = qp[h] < S ? delta[(size_t)bh * S + qp[h]] : 0.f;
  }
  load_tile<HD>(qs, q + qoff, q0, S);
  load_tile<HD>(dos, dout + qoff, q0, S);
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int nk = (KV + FA_T - 1) / FA_T;
  const int n_live = CAUSAL ? min(nk, qi + 1) : nk;
  for (int j = 0; j < n_live; ++j) {
    const int k0 = j * FA_T;
    __syncthreads();
    load_tile<HD>(ks, k + koff, k0, KV);
    load_tile<HD>(vs, v + koff, k0, KV);
    __syncthreads();
    float s[FA_T / 8][4], dp[FA_T / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_T / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ad[4];
      frag_a(a, qs, L, r0, kk * 16, g, t);
      frag_a(ad, dos, L, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < FA_T / 8; ++nt) {
        uint32_t b0, b1;
        frag_bt(b0, b1, ks, L, nt * 8, kk * 16, g, t);
        mma(s[nt], a, b0, b1);
        frag_bt(b0, b1, vs, L, nt * 8, kk * 16, g, t);
        mma(dp[nt], ad, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < FA_T / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nt * 8 + 2 * t + (e & 1), h = e >> 1;
        const bool ok = qp[h] < S && kp < KV && (!CAUSAL || kp <= qp[h]);
        const float p = ok ? expf(sm_scale * s[nt][e] - lse_r[h]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[h]);      // ds
      }
#pragma unroll
    for (int kk = 0; kk < FA_T / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t b0, b1;
        frag_b(b0, b1, ks, L, kk * 16, nt * 8, g, t);
        mma(acc[nt], a, b0, b1);
      }
    }
  }
  const float sc[2] = {sm_scale, sm_scale};
  store16<HD>(dq + qoff, qp[0], S, acc, sc, t);
}

// ---- B7 on tensor cores: each warp owns 16 keys; query tiles of 64 are
// taken 32 columns at a time to bound the registers
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int KV,
               float sm_scale) {
  constexpr int L = ld<HD>();
  constexpr int SUB = 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + FA_T * L;
  bf16* qs = vs + FA_T * L;
  bf16* dos = qs + FA_T * L;
  float* lse_s = reinterpret_cast<float*>(dos + FA_T * L);
  float* delta_s = lse_s + FA_T;
  const int kj = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int k0 = kj * FA_T;
  const int kp[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const size_t qoff = (size_t)bh * S * HD, koff = (size_t)bh * KV * HD;
  load_tile<HD>(ks, k + koff, k0, KV);
  load_tile<HD>(vs, v + koff, k0, KV);
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  const int nq = (S + FA_T - 1) / FA_T;
  for (int i = CAUSAL ? kj : 0; i < nq; ++i) {
    const int q0 = i * FA_T;
    __syncthreads();
    load_tile<HD>(qs, q + qoff, q0, S);
    load_tile<HD>(dos, dout + qoff, q0, S);
    if (threadIdx.x < FA_T) {
      const bool in = q0 + threadIdx.x < S;
      lse_s[threadIdx.x] = in ? lse[(size_t)bh * S + q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] =
          in ? delta[(size_t)bh * S + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < FA_T; c0 += SUB) {
      // transposed scores: rows this warp's keys, columns 32 queries
      float st[SUB / 8][4], dpt[SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], av[4];
        frag_a(a, ks, L, r0, kk * 16, g, t);
        frag_a(av, vs, L, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < SUB / 8; ++nt) {
          uint32_t b0, b1;
          frag_bt(b0, b1, qs, L, c0 + nt * 8, kk * 16, g, t);
          mma(st[nt], a, b0, b1);
          frag_bt(b0, b1, dos, L, c0 + nt * 8, kk * 16, g, t);
          mma(dpt[nt], av, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + nt * 8 + 2 * t + (e & 1), qpos = q0 + qc;
          const int h = e >> 1;
          const bool ok = qpos < S && kp[h] < KV && (!CAUSAL || kp[h] <= qpos);
          const float p = ok ? expf(sm_scale * st[nt][e] - lse_s[qc]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - delta_s[qc]);  // ds^T
        }
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        c_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          uint32_t b0, b1;
          frag_b(b0, b1, dos, L, c0 + kk * 16, nt * 8, g, t);
          mma(dv_acc[nt], ap, b0, b1);
          frag_b(b0, b1, qs, L, c0 + kk * 16, nt * 8, g, t);
          mma(dk_acc[nt], ads, b0, b1);
        }
      }
    }
  }
  const float sc[2] = {sm_scale, sm_scale}, one[2] = {1.f, 1.f};
  store16<HD>(dk + koff, kp[0], KV, dk_acc, sc, t);
  store16<HD>(dv + koff, kp[0], KV, dv_acc, one, t);
}

template <int HD>
constexpr size_t fwd_smem() { return sizeof(bf16) * 3 * FA_T * ld<HD>(); }
template <int HD>
constexpr size_t dq_smem() { return sizeof(bf16) * 4 * FA_T * ld<HD>(); }
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(bf16) * 4 * FA_T * ld<HD>() + sizeof(float) * 2 * FA_T;
}

}  // namespace tc

// shared-memory bytes of each kernel
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
// process (the first launch happens outside any CUDA graph capture, so
// a captured launch never makes this call). One card per process.
template <typename F>
cudaError_t allow_smem(F* fn, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// the kernels of an input type: tensor cores for bf16, CUDA cores for fp32
template <int HD, typename T, bool CAUSAL>
struct Pick {
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int threads = TC ? tc::THREADS : FA_THREADS;
  static auto fwd() {
    if constexpr (TC) return tc::fwd_kernel<HD, CAUSAL>;
    else return fa_fwd_kernel<HD, CAUSAL>;
  }
  static auto dq() {
    if constexpr (TC) return tc::dq_kernel<HD, CAUSAL>;
    else return fa_bwd_dq_kernel<HD, CAUSAL>;
  }
  static auto dkv() {
    if constexpr (TC) return tc::dkv_kernel<HD, CAUSAL>;
    else return fa_bwd_dkv_kernel<HD, CAUSAL>;
  }
  static constexpr size_t smem(int which) {
    if constexpr (TC)
      return which == 0 ? tc::fwd_smem<HD>()
                        : which == 1 ? tc::dq_smem<HD>() : tc::dkv_smem<HD>();
    else
      return which == 0 ? fwd_smem<HD>()
                        : which == 1 ? dq_smem<HD>() : dkv_smem<HD>();
  }
};

template <int HD, typename T, bool CAUSAL>
int launch(int which, const Args& a) {
  using K = Pick<HD, T, CAUSAL>;
  static bool smem_ok[3] = {false, false, false};
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const dim3 block(K::threads);
  const dim3 q_grid((a.S + FA_T - 1) / FA_T, a.BH);
  const dim3 k_grid((a.KV + FA_T - 1) / FA_T, a.BH);
  const size_t smem = K::smem(which);
  cudaError_t err = cudaSuccess;
  if (which == 0) {
    auto* fn = K::fwd();
    if ((err = allow_smem(fn, smem, smem_ok[0])) != cudaSuccess)
      return (int)err;
    fn<<<q_grid, block, smem, a.st>>>(q, k, v, static_cast<T*>(a.o),
                                      static_cast<float*>(a.lse_out), a.S,
                                      a.KV, a.sm_scale);
  } else if (which == 1) {
    auto* fn = K::dq();
    if ((err = allow_smem(fn, smem, smem_ok[1])) != cudaSuccess)
      return (int)err;
    fn<<<q_grid, block, smem, a.st>>>(q, k, v, dout, lse, delta,
                                      static_cast<T*>(a.dq), a.S, a.KV,
                                      a.sm_scale);
  } else {
    auto* fn = K::dkv();
    if ((err = allow_smem(fn, smem, smem_ok[2])) != cudaSuccess)
      return (int)err;
    fn<<<k_grid, block, smem, a.st>>>(q, k, v, dout, lse, delta,
                                      static_cast<T*>(a.dk),
                                      static_cast<T*>(a.dv), a.S, a.KV,
                                      a.sm_scale);
  }
  return (int)cudaGetLastError();
}

// hd 128 only: every configuration on the port's training path uses it
template <typename T>
int dispatch_hd(int which, int HD, int causal, const Args& a) {
  if (HD == 128)
    return causal ? launch<128, T, true>(which, a)
                  : launch<128, T, false>(which, a);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int which, int dtype, int HD, int causal, const Args& a) {
  if (a.BH <= 0 || a.S <= 0 || a.KV <= 0 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == ISL_F32) return dispatch_hd<float>(which, HD, causal, a);
  if (dtype == ISL_BF16) return dispatch_hd<__nv_bfloat16>(which, HD, causal, a);
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

}  // extern "C"
