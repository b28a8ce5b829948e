// w8a16 matmul for Hopper: bf16/fp32 activations x int8 weights -> fp32.
//
// Replaces the Pallas kernels of instaslice_tpu/ops/quant_matmul.py:
//   _qmm_stacked_kernel (:138) and _qmm_kernel (:66)  -> (K, N) bodies
//   _qmm_t_kernel (:89)                               -> (N, K) bodies
// The TPU kernels convert the int8 tile to x's dtype and hand the product
// to the matrix unit with fp32 sums; so do these.
//
// Bound on the H100: the int8 weight bytes. Out^T (N x M) = W . x^T, with
// the weight's output channels on the tensor-core instruction's 16-row
// side and the batch on its 8-wide side (nothing is padded at M = 8),
// does 2 M operations per weight byte; the tensor cores become the limit
// near 295, so up to M ~ 147 the byte time is the larger one (w_in at
// M = 128: 21.5 GFLOP = 21.7 us at 989 TFLOP/s against ~28 us of bytes)
// and at the ceiling M = 256 the two are within 2x. So the design's job
// is to stream int8 at the memory rate, convert each byte once, and
// never write a dequantized copy.
//
// bf16 x, 16-byte-aligned rows: namespace tc below (qmm_tc_kernel).
//  * One pass over the weight for any M <= 256: a block owns a tile of
//    output channels (128 or 256), a K range, and ALL rows of x. The grid
//    is (channel tiles, K splits): no grid dimension over M, every weight
//    byte is read from device memory and converted once per call.
//  * A ring of 3-4 stages in shared memory, each 64 or 128 k of the
//    block's channels (int8) plus the matching columns of x (bf16),
//    filled with cp.async 16 bytes a thread; all but one stage (24-64 KB a
//    block) are in flight while that one is multiplied, and the warps
//    hardly ever wait for data to land.
//    Edges (rows of x past M, channels past N, k past the block's range)
//    are zero-filled by the copy itself. An (N, K) stage is 128 k deep so
//    that a channel's run in it is a whole 128-byte line.
//  * int8 -> bf16 in registers, exact: the byte, with its sign bit
//    flipped, is dropped by one prmt into the mantissa of 2^23 as fp32,
//    2^23 + 128 is subtracted, and the high halves of two such floats
//    are packed by one more prmt (|q| <= 128 has 8 significant bits, so
//    the truncation loses nothing). Products go to mma.sync m16n8k16
//    (bf16 operands, fp32 sums); a warp owns 32 channels (two 16-row
//    tiles) and up to 128 columns of the batch, its sums stay in
//    registers (128 at most) for the whole K range.
//  * (N, K) table (the unembedding): a channel's k run is contiguous, so
//    a thread reads 16 bytes = 16 consecutive k of one channel from the
//    stage and uses bytes 4j..4j+3 as the k columns (2t, 2t+1, 2t+8,
//    2t+9) of the j-th mma. The sum over k does not care about the order
//    as long as x uses the same one: its fragment is the 8 bytes at
//    k = 16t + 4j, read two mmas at a time as one 16-byte load.
//  * (K, N) projections: consecutive k of one channel lie N bytes apart.
//    Chosen: 4-byte reads of four k rows (2t, 2t+1, 2t+8, 2t+9) x four
//    consecutive channels from the stage, and the same prmt that
//    converts a byte also picks it, so the 4 x 4 byte transpose costs
//    nothing beyond the conversion; thread (g, t) then owns channels
//    4g..4g+3 of the warp's 32 as rows g and g+8 of its two 16-row
//    tiles, which makes the output a 16-byte store per row of x. The
//    alternative (convert the tile to bf16 in shared memory and let
//    wgmma read it MN-major) writes and re-reads two bytes of shared
//    memory per weight byte and needs descriptor layouts on top; the
//    register route moves each weight byte through shared memory once.
//    The stage's rows are padded by 16 bytes so the four-row reads and
//    the ldmatrix reads of x hit 32 distinct banks.
//  * Small N leaves too few channel tiles for 132 SMs, so K is split
//    across blocks (grid.y, chosen per shape by the wrapper's planner)
//    and a second pass sums the splits in split order and applies the
//    scale: no atomics, results are bit-equal from run to run. The
//    per-channel scale multiplies the finished fp32 sum once
//    (sum_k x_k q_kn s_n = s_n sum_k x_k q_kn). The stacked layer index
//    is a pointer offset the wrapper applies: the stack is never sliced.
//  * What holds it (H100, ops/qmm_probe.py): at decode row counts it
//    streams 2.1-2.5 TB/s of the 3.35 TB/s, and the ring alone, with the
//    multiply taken out, is no faster. At M = 128 a stage costs a warp
//    about as long to start its cp.async copies (the x tile is as large
//    as the weight tile there) as to convert and multiply it, and the two
//    do not overlap within a warp: 0.9-1.3 TB/s. Tried and not kept:
//    wgmma with x read from shared memory by the tensor cores (no faster
//    while starting the copies dominates), per-row bulk copies
//    (cp.async.bulk of 128-256 bytes: several times slower), a copying
//    warpgroup with mbarriers (about a tenth faster on the projections,
//    slower on the table). Tiles through tensor-map TMA are the next
//    step.
//
// fp32 x, or rows that are not 16-byte aligned: the masked CUDA-core
// bodies (qmm_kn_kernel, qmm_nk_kernel) with exact int8 -> fp32 converts
// and fp32 fmaf, as before: rounding an fp32 x to bf16 would change the
// function. They tile M by 8 rows on blockIdx.x. (K, N): a warp's lanes
// own 8 consecutive columns each, 8 warps take interleaved rows of the
// block's K range and fold their sums in a fixed order. (N, K): each
// warp owns 4 rows of q, lanes read 4 consecutive bytes of each, a warp
// shuffle finishes every output.
#include "common.cuh"

namespace {

constexpr int KN_THREADS = 256;
constexpr int KN_WARPS = KN_THREADS / 32;
constexpr int KN_COLS = 8;             // int8 columns per thread (8 bytes)
constexpr int KN_NT = 32 * KN_COLS;    // columns per block
constexpr int KN_MT = 8;               // rows of x per block
constexpr int KN_KCH = 256;            // rows of K staged per chunk
constexpr int KN_U = 8;                // rows each warp loads at once

template <typename XT, typename ST>
__global__ void __launch_bounds__(KN_THREADS)
    qmm_kn_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                  const ST* __restrict__ s, float* __restrict__ out,
                  float* __restrict__ part, int M, int K, int N, int k_len,
                  int splits) {
  __shared__ float xs[KN_MT][KN_KCH];
  // column c of the tile is stored at (c % KN_COLS) * 32 + c / KN_COLS
  // so that the per-warp folds below are free of bank conflicts
  __shared__ float red[KN_MT][KN_NT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * KN_MT;
  const int nb = blockIdx.y * KN_NT;
  const int n0 = nb + lane * KN_COLS;
  const int k_begin = blockIdx.z * k_len;
  const int k_end = min(K, k_begin + k_len);
  const bool vec = (N % KN_COLS) == 0;

  float acc[KN_MT][KN_COLS];
#pragma unroll
  for (int m = 0; m < KN_MT; ++m)
#pragma unroll
    for (int j = 0; j < KN_COLS; ++j) acc[m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += KN_KCH) {
    const int kn = min(KN_KCH, k_end - kc);
    __syncthreads();
    for (int i = tid; i < KN_MT * KN_KCH; i += KN_THREADS) {
      const int m = i / KN_KCH, kk = i % KN_KCH;
      xs[m][kk] = (m0 + m < M && kk < kn)
                      ? isl::to_f32(x[(size_t)(m0 + m) * K + kc + kk])
                      : 0.f;
    }
    __syncthreads();
    if (n0 < N && vec) {
      // KN_U rows per warp step: all their loads are in flight before any
      // is used
      for (int kk0 = warp; kk0 < kn; kk0 += KN_WARPS * KN_U) {
        int2 raw[KN_U];
#pragma unroll
        for (int u = 0; u < KN_U; ++u) {
          const int kk = kk0 + u * KN_WARPS;
          raw[u] = kk < kn ? __ldg(reinterpret_cast<const int2*>(
                                 q + (size_t)(kc + kk) * N + n0))
                           : make_int2(0, 0);
        }
#pragma unroll
        for (int u = 0; u < KN_U; ++u) {
          const int kk = kk0 + u * KN_WARPS;
          if (kk >= kn) break;
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw[u]);
          float w[KN_COLS];
#pragma unroll
          for (int j = 0; j < KN_COLS; ++j) w[j] = (float)b[j];
#pragma unroll
          for (int m = 0; m < KN_MT; ++m) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int j = 0; j < KN_COLS; ++j)
              acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
    } else if (n0 < N) {
      // ragged N (not a multiple of 8): byte loads, masked columns
      for (int kk = warp; kk < kn; kk += KN_WARPS) {
        const int8_t* row = q + (size_t)(kc + kk) * N + n0;
#pragma unroll
        for (int m = 0; m < KN_MT; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int j = 0; j < KN_COLS; ++j)
            if (n0 + j < N) acc[m][j] = fmaf(xv, (float)row[j], acc[m][j]);
        }
      }
    }
  }

  // fold the warps' partial sums in warp order (deterministic)
  for (int w = 0; w < KN_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < KN_MT; ++m)
#pragma unroll
        for (int j = 0; j < KN_COLS; ++j) {
          float* r = &red[m][j * 32 + lane];
          *r = (w == 0 ? 0.f : *r) + acc[m][j];
        }
    }
    __syncthreads();
  }

  for (int i = tid; i < KN_MT * KN_NT; i += KN_THREADS) {
    const int m = i / KN_NT, c = i % KN_NT, n = nb + c;
    if (m0 + m >= M || n >= N) continue;
    const float v = red[m][(c % KN_COLS) * 32 + c / KN_COLS];
    if (splits == 1)
      out[(size_t)(m0 + m) * N + n] = v * isl::to_f32(s[n]);
    else
      part[((size_t)blockIdx.z * M + m0 + m) * N + n] = v;
  }
}

// sums the K splits in split order, then applies the column scale
template <typename ST>
__global__ void qmm_split_reduce(const float* __restrict__ part,
                                 const ST* __restrict__ s,
                                 float* __restrict__ out, int M, int N,
                                 int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += part[(size_t)z * total + i];
    out[i] = v * isl::to_f32(s[i % N]);
  }
}

constexpr int NK_THREADS = 256;
constexpr int NK_WARPS = NK_THREADS / 32;
constexpr int NK_ROWS = 4;       // rows of q per warp
constexpr int NK_MT = 8;         // rows of x per block
constexpr int NK_KCH = 1024;     // columns of x staged per chunk

template <typename XT, typename ST>
__global__ void __launch_bounds__(NK_THREADS, 2)
    qmm_nk_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                  const ST* __restrict__ s, float* __restrict__ out, int M,
                  int K, int N) {
  __shared__ __align__(16) float xs[NK_MT][NK_KCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * NK_MT;
  const int row0 = (blockIdx.y * NK_WARPS + warp) * NK_ROWS;
  const bool vec = (K % 4) == 0;

  float acc[NK_ROWS][NK_MT];
#pragma unroll
  for (int r = 0; r < NK_ROWS; ++r)
#pragma unroll
    for (int m = 0; m < NK_MT; ++m) acc[r][m] = 0.f;

  for (int kc = 0; kc < K; kc += NK_KCH) {
    const int kn = min(NK_KCH, K - kc);
    __syncthreads();
    for (int i = tid; i < NK_MT * NK_KCH; i += NK_THREADS) {
      const int m = i / NK_KCH, kk = i % NK_KCH;
      xs[m][kk] = (m0 + m < M && kk < kn)
                      ? isl::to_f32(x[(size_t)(m0 + m) * K + kc + kk])
                      : 0.f;
    }
    __syncthreads();
    // each step: this lane's 4 columns of x for all NK_MT rows, read
    // once from shared memory and used for all NK_ROWS rows of q (whose
    // loads are in flight together)
    for (int kk = lane * 4; kk < kn; kk += 128) {
      float4 xv[NK_MT];
#pragma unroll
      for (int m = 0; m < NK_MT; ++m)
        xv[m] = *reinterpret_cast<const float4*>(&xs[m][kk]);
      float w[NK_ROWS][4];
#pragma unroll
      for (int r = 0; r < NK_ROWS; ++r) {
        const int n = row0 + r;
        const int8_t* qp = q + (size_t)n * K + kc + kk;
        if (vec && n < N) {
          const char4 raw = __ldg(reinterpret_cast<const char4*>(qp));
          w[r][0] = (float)raw.x; w[r][1] = (float)raw.y;
          w[r][2] = (float)raw.z; w[r][3] = (float)raw.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[r][j] = (n < N && kk + j < kn) ? (float)qp[j] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < NK_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < NK_MT; ++m) {
          float a = acc[r][m];
          a = fmaf(xv[m].x, w[r][0], a);
          a = fmaf(xv[m].y, w[r][1], a);
          a = fmaf(xv[m].z, w[r][2], a);
          a = fmaf(xv[m].w, w[r][3], a);
          acc[r][m] = a;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < NK_ROWS; ++r) {
    const int n = row0 + r;
#pragma unroll
    for (int m = 0; m < NK_MT; ++m) {
      const float v = isl::warp_sum(acc[r][m]);
      if (lane == m && n < N && m0 + m < M)
        out[(size_t)(m0 + m) * N + n] = v * isl::to_f32(s[n]);
    }
  }
}

template <typename XT, typename ST>
void launch_kn(const void* x, const void* q, const void* s, void* out,
               void* part, int M, int K, int N, int k_len, int splits,
               cudaStream_t st) {
  const dim3 grid((M + KN_MT - 1) / KN_MT, (N + KN_NT - 1) / KN_NT, splits);
  qmm_kn_kernel<XT, ST><<<grid, KN_THREADS, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q),
      static_cast<const ST*>(s), static_cast<float*>(out),
      static_cast<float*>(part), M, K, N, k_len, splits);
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const size_t want = (total + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    qmm_split_reduce<ST><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<const ST*>(s),
        static_cast<float*>(out), M, N, splits);
  }
}

template <typename XT, typename ST>
void launch_nk(const void* x, const void* q, const void* s, void* out, int M,
               int K, int N, cudaStream_t st) {
  const int rows_per_block = NK_WARPS * NK_ROWS;
  const dim3 grid((M + NK_MT - 1) / NK_MT,
                  (N + rows_per_block - 1) / rows_per_block);
  qmm_nk_kernel<XT, ST><<<grid, NK_THREADS, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q),
      static_cast<const ST*>(s), static_cast<float*>(out), M, K, N);
}


// ------------------------------------------ tensor-core path (bf16 x)
namespace tc {

using bf16 = __nv_bfloat16;
// NK: (N, K) weight, else (K, N). A block has WC x WM warps; each owns 32
// channels and 8 * NT8 rows of x. A ring stage holds KT k; the ring has
// STAGES slots (STAGES - 1 in flight).
template <bool NK, int WC, int WM, int NT8, int KT_, int ST_>
struct Tile {
  static constexpr int KT = KT_;
  static constexpr int STAGES = ST_;
  static constexpr int XLD = 2 * KT + 16;       // bytes per staged row of x
  static constexpr int THREADS = 32 * WC * WM;
  static constexpr int CT = 32 * WC;            // channels per block
  static constexpr int MPAD = 8 * NT8 * WM;     // rows of x per block
  static constexpr int WLD = NK ? KT : CT + 16; // bytes per weight row
  static constexpr int W_BYTES = NK ? CT * KT : KT * (CT + 16);
  static constexpr int X_BYTES = MPAD * XLD;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  // (N, K) rows longer than 64 bytes: 16-byte chunk c of row r is stored
  // at c ^ swz(r), so that two neighbouring rows' chunks hit other banks
  __host__ __device__ static constexpr int swz(int row) {
    return (NK && KT > 64) ? ((row & 1) << 2) : 0;
  }
};

// 16 bytes global -> shared, zeros when !pred (nothing is read then)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// byte I of wx (four int8, sign bits flipped) as fp32, exact
template <int I>
__device__ __forceinline__ float i8f(uint32_t wx) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650 + I)) -
         8388736.f;
}
// two exact small integers in fp32 -> packed bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// bytes I of wa and wb -> bf16 pair
template <int I>
__device__ __forceinline__ uint32_t cvt_col(uint32_t wa, uint32_t wb) {
  return pack2(i8f<I>(wa), i8f<I>(wb));
}
// bytes I, I + 1 of w -> bf16 pair
template <int I>
__device__ __forceinline__ uint32_t cvt_row(uint32_t w) {
  return pack2(i8f<I>(w), i8f<I + 1>(w));
}
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float scale_at(const void* s, int s_bf16, int n) {
  return s_bf16 ? __bfloat162float(static_cast<const bf16*>(s)[n])
                : static_cast<const float*>(s)[n];
}

// fills ring slot `slot` with k range [k0, k0 + KT) of the block's
// channels and of x; zero-fills past M, N and k_end
template <typename T, bool NK>
__device__ __forceinline__ void load_stage(
    uint8_t* smem, int slot, const bf16* __restrict__ x,
    const int8_t* __restrict__ q, int M, int K, int N, int n0, int k0,
    int k_end) {
  constexpr int KT = T::KT, XLD = T::XLD;
  uint8_t* wt = smem + slot * T::STAGE;
  uint8_t* xs = wt + T::W_BYTES;
  const int tid = threadIdx.x;
  if (NK) {
    for (int c = tid; c < T::CT * (KT / 16); c += T::THREADS) {
      const int row = c / (KT / 16), part = c % (KT / 16);
      const int n = n0 + row, k = k0 + part * 16;
      const bool ok = n < N && k < k_end;
      cp16(wt + row * T::WLD + (part ^ T::swz(row)) * 16,
           ok ? q + (size_t)n * K + k : q, ok);
    }
  } else {
    for (int c = tid; c < KT * (T::CT / 16); c += T::THREADS) {
      const int row = c / (T::CT / 16), part = c % (T::CT / 16);
      const int k = k0 + row, n = n0 + part * 16;
      const bool ok = k < k_end && n < N;
      cp16(wt + row * T::WLD + part * 16,
           ok ? q + (size_t)k * N + n : q, ok);
    }
  }
  for (int c = tid; c < T::MPAD * (KT / 8); c += T::THREADS) {
    const int row = c / (KT / 8), part = c % (KT / 8);
    const int k = k0 + part * 8;
    const bool ok = row < M && k < k_end;
    cp16(xs + row * XLD + part * 16, ok ? x + (size_t)row * K + k : x, ok);
  }
}

// out (or one K split's partial sums) for x (M, K) bf16 and int8 q.
// Requires 16-byte-aligned rows: K % 16 == 0 for (N, K); N % 16 == 0 and
// K % 8 == 0 for (K, N); k_len % KT == 0.
template <bool NK, int WC, int WM, int NT8, int KT, int STAGES>
__global__ void __launch_bounds__(32 * WC * WM)
    qmm_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                  const void* __restrict__ s, int s_bf16,
                  float* __restrict__ out, float* __restrict__ part, int M,
                  int K, int N, int k_len, int splits) {
  using T = Tile<NK, WC, WM, NT8, KT, STAGES>;
  constexpr int XLD = T::XLD;
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % WC, wm = warp / WC;
  const int n0 = blockIdx.x * T::CT;
  const int k_begin = blockIdx.y * k_len;
  const int k_end = min(K, k_begin + k_len);
  const int nk = (k_end - k_begin + KT - 1) / KT;
  const int m_base = wm * 8 * NT8;

  float acc[2][NT8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_stage<T, NK>(smem, st, x, q, M, K, N, n0, k_begin + st * KT,
                        k_end);
    cp_commit();
  }

  for (int it = 0; it < nk; ++it) {
    // stage `it` has landed; every warp is done with stage it - 1, whose
    // slot the next load reuses
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < nk)
      load_stage<T, NK>(smem, (it + STAGES - 1) % STAGES, x, q, M, K, N, n0,
                        k_begin + (it + STAGES - 1) * KT, k_end);
    cp_commit();

    const uint8_t* wt = smem + (it % STAGES) * T::STAGE;
    const uint8_t* xs = wt + T::W_BYTES;
    if (NK) {
#pragma unroll
      for (int kb = 0; kb < KT / 64; ++kb) {
        // rows g, g + 8 of the warp's two 16-channel tiles, 16 k each
        uint4 wv[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 32 * wc + 16 * i + 8 * h + g;
            wv[i][h] = *reinterpret_cast<const uint4*>(
                wt + row * T::WLD + ((4 * kb + t) ^ T::swz(row)) * 16);
          }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t a[2][2][4];         // [mma of the pair][tile][fragment]
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t lo = word(wv[i][0], 2 * jp + jj) ^ 0x80808080u;
              const uint32_t hi = word(wv[i][1], 2 * jp + jj) ^ 0x80808080u;
              a[jj][i][0] = cvt_row<0>(lo);
              a[jj][i][1] = cvt_row<0>(hi);
              a[jj][i][2] = cvt_row<2>(lo);
              a[jj][i][3] = cvt_row<2>(hi);
            }
          // x[m][64 kb + 16 t + 8 jp ..+7]: the b fragments of mmas
          // 2 jp and 2 jp + 1; a group's loads first, then its mmas
          constexpr int NG = NT8 < 8 ? NT8 : 8;
#pragma unroll
          for (int n0t = 0; n0t < NT8; n0t += NG) {
            uint4 xv[NG];
#pragma unroll
            for (int u = 0; u < NG; ++u)
              xv[u] = *reinterpret_cast<const uint4*>(
                  xs + (m_base + 8 * (n0t + u) + g) * XLD + 128 * kb +
                  32 * t + 16 * jp);
#pragma unroll
            for (int u = 0; u < NG; ++u) {
              mma(acc[0][n0t + u], a[0][0], xv[u].x, xv[u].y);
              mma(acc[1][n0t + u], a[0][1], xv[u].x, xv[u].y);
              mma(acc[0][n0t + u], a[1][0], xv[u].z, xv[u].w);
              mma(acc[1][n0t + u], a[1][1], xv[u].z, xv[u].w);
            }
          }
        }
      }
    } else {
      const uint8_t* wp = wt + (2 * t) * T::WLD + 32 * wc + 4 * g;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        // k rows 2t, 2t+1, 2t+8, 2t+9 of this k16 x channels 4g..4g+3
        const uint8_t* p = wp + kk * 16 * T::WLD;
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(p + T::WLD) ^ 0x80808080u;
        const uint32_t w2 =
            *reinterpret_cast<const uint32_t*>(p + 8 * T::WLD) ^ 0x80808080u;
        const uint32_t w3 =
            *reinterpret_cast<const uint32_t*>(p + 9 * T::WLD) ^ 0x80808080u;
        // tile i: row g = channel 4g + 2i, row g + 8 = channel 4g + 2i + 1
        uint32_t a[2][4];
        a[0][0] = cvt_col<0>(w0, w1);
        a[0][1] = cvt_col<1>(w0, w1);
        a[0][2] = cvt_col<0>(w2, w3);
        a[0][3] = cvt_col<1>(w2, w3);
        a[1][0] = cvt_col<2>(w0, w1);
        a[1][1] = cvt_col<3>(w0, w1);
        a[1][2] = cvt_col<2>(w2, w3);
        a[1][3] = cvt_col<3>(w2, w3);
        if constexpr (NT8 == 1) {
          uint32_t b[2];
          ldsm2(b, xs + (m_base + (lane & 7)) * XLD + kk * 32 +
                       ((lane >> 3) & 1) * 16);
          mma(acc[0][0], a[0], b[0], b[1]);
          mma(acc[1][0], a[1], b[0], b[1]);
        } else {
          // all of this k16's x fragments first, then the mmas back to
          // back: the loads' latency is paid once
          uint32_t b[NT8 / 2][4];
#pragma unroll
          for (int np = 0; np < NT8 / 2; ++np)
            ldsm4(b[np], xs + (m_base + (2 * np + (lane >> 4)) * 8 +
                               (lane & 7)) * XLD +
                             kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int np = 0; np < NT8 / 2; ++np) {
            mma(acc[0][2 * np], a[0], b[np][0], b[np][1]);
            mma(acc[1][2 * np], a[1], b[np][0], b[np][1]);
            mma(acc[0][2 * np + 1], a[0], b[np][2], b[np][3]);
            mma(acc[1][2 * np + 1], a[1], b[np][2], b[np][3]);
          }
        }
      }
    }
  }

  // finished sums: times the scale into out, or raw into this split's
  // partial plane (the second pass scales)
  float* dst = splits == 1 ? out : part + (size_t)blockIdx.y * M * N;
  if (NK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 32 * wc + 16 * i + 8 * h + g;
        if (n >= N) continue;
        const float sc = splits == 1 ? scale_at(s, s_bf16, n) : 1.f;
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m_base + 8 * nt + 2 * t + e;
            if (m < M) dst[(size_t)m * N + n] = acc[i][nt][2 * h + e] * sc;
          }
      }
  } else {
    const int n = n0 + 32 * wc + 4 * g;
    if (n < N) {
      float sc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[c] = splits == 1 ? scale_at(s, s_bf16, n + c) : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m_base + 8 * nt + 2 * t + e;
          if (m >= M) continue;
          *reinterpret_cast<float4*>(dst + (size_t)m * N + n) = make_float4(
              acc[0][nt][e] * sc[0], acc[0][nt][2 + e] * sc[1],
              acc[1][nt][e] * sc[2], acc[1][nt][2 + e] * sc[3]);
        }
    }
  }
}

template <bool NK, int WC, int WM, int NT8, int KT, int STAGES>
cudaError_t launch(const void* x, const void* q, const void* s, int s_bf16,
                   void* out, void* part, int M, int K, int N, int k_len,
                   int splits, cudaStream_t st) {
  using T = Tile<NK, WC, WM, NT8, KT, STAGES>;
  auto kern = qmm_tc_kernel<NK, WC, WM, NT8, KT, STAGES>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((N + T::CT - 1) / T::CT, splits);
  kern<<<grid, T::THREADS, T::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q), s, s_bf16,
      static_cast<float*>(out), static_cast<float*>(part), M, K, N, k_len,
      splits);
  return cudaGetLastError();
}

// The tile a row count takes, (warps over channels, warps over rows,
// 8-row tiles a warp, k per stage, ring slots), set from timings on an
// H100 (ops/qmm_probe.py): 128 channels and 4 warps a block up to M = 64
// so that several blocks share an SM, 256 channels at M <= 128 so that x
// crosses the L2 once per 256 channels, two warps over the rows above
// that. An (N, K) stage is 128 k deep: a channel's run in a stage is
// then a whole 128-byte line (64-byte runs read 1.4x slower).
// ops/quant_matmul.py mirrors the table (_TC_TILES) and isl_qmm_tc_tile
// reports it.
#define ISL_TC_BY_M(NK_, M, CALL)                                   \
  if (NK_) {                                                        \
    if ((M) <= 8) { CALL(true, 4, 1, 1, 128, 4) }                   \
    else if ((M) <= 16) { CALL(true, 4, 1, 2, 128, 4) }             \
    else if ((M) <= 32) { CALL(true, 4, 1, 4, 128, 3) }             \
    else if ((M) <= 64) { CALL(true, 4, 1, 8, 128, 3) }             \
    else if ((M) <= 128) { CALL(true, 8, 1, 16, 128, 3) }           \
    else if ((M) <= 256) { CALL(true, 4, 2, 16, 64, 4) }            \
  } else {                                                          \
    if ((M) <= 8) { CALL(false, 4, 1, 1, 64, 4) }                   \
    else if ((M) <= 16) { CALL(false, 4, 1, 2, 64, 4) }             \
    else if ((M) <= 32) { CALL(false, 4, 1, 4, 64, 4) }             \
    else if ((M) <= 64) { CALL(false, 4, 1, 8, 64, 4) }             \
    else if ((M) <= 128) { CALL(false, 8, 1, 16, 64, 4) }           \
    else if ((M) <= 256) { CALL(false, 4, 2, 16, 64, 4) }           \
  }

template <bool NK>
int run(const void* x, const void* q, const void* s, int s_dtype, void* out,
        void* part, int M, int K, int N, int k_len, int splits,
        cudaStream_t st) {
  if (M < 1 || M > 256 || k_len % 128 || splits < 1 ||
      (s_dtype != ISL_F32 && s_dtype != ISL_BF16))
    return (int)cudaErrorInvalidValue;
  const int s_bf16 = s_dtype == ISL_BF16;
  cudaError_t e = cudaErrorInvalidValue;
#define ISL_TC_LAUNCH(NK_, WC, WM, NT8, KT, ST)                          \
  e = launch<NK_, WC, WM, NT8, KT, ST>(x, q, s, s_bf16, out, part, M, K, \
                                       N, k_len, splits, st);
  ISL_TC_BY_M(NK, M, ISL_TC_LAUNCH)
#undef ISL_TC_LAUNCH
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const size_t want = (total + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    if (s_bf16)
      qmm_split_reduce<bf16><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(part), static_cast<const bf16*>(s),
          static_cast<float*>(out), M, N, splits);
    else
      qmm_split_reduce<float><<<blocks, 256, 0, st>>>(
          static_cast<const float*>(part), static_cast<const float*>(s),
          static_cast<float*>(out), M, N, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// out (M, N) fp32 = x (M, K) @ q (K, N) int8, times s (N,) per column.
// part holds splits * M * N fp32 when splits > 1 (unused otherwise).
// Returns cudaGetLastError() after the launches.
int isl_qmm_kn(const void* x, int x_dtype, const void* q, const void* s,
               int s_dtype, void* out, void* part, int M, int K, int N,
               int k_len, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == ISL_F32 && s_dtype == ISL_F32)
    launch_kn<float, float>(x, q, s, out, part, M, K, N, k_len, splits, st);
  else if (x_dtype == ISL_F32 && s_dtype == ISL_BF16)
    launch_kn<float, __nv_bfloat16>(x, q, s, out, part, M, K, N, k_len,
                                    splits, st);
  else if (x_dtype == ISL_BF16 && s_dtype == ISL_F32)
    launch_kn<__nv_bfloat16, float>(x, q, s, out, part, M, K, N, k_len,
                                    splits, st);
  else if (x_dtype == ISL_BF16 && s_dtype == ISL_BF16)
    launch_kn<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, part, M, K, N,
                                            k_len, splits, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out (M, N) fp32 = x (M, K) @ q (N, K)^T int8, times s (N,) per row of q.
int isl_qmm_nk(const void* x, int x_dtype, const void* q, const void* s,
               int s_dtype, void* out, int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == ISL_F32 && s_dtype == ISL_F32)
    launch_nk<float, float>(x, q, s, out, M, K, N, st);
  else if (x_dtype == ISL_F32 && s_dtype == ISL_BF16)
    launch_nk<float, __nv_bfloat16>(x, q, s, out, M, K, N, st);
  else if (x_dtype == ISL_BF16 && s_dtype == ISL_F32)
    launch_nk<__nv_bfloat16, float>(x, q, s, out, M, K, N, st);
  else if (x_dtype == ISL_BF16 && s_dtype == ISL_BF16)
    launch_nk<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, M, K, N, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Tensor-core entries (bf16 x, 16-byte-aligned rows; see the head of the
// file). part holds splits * M * N fp32 when splits > 1.
// out (M, N) fp32 = x (M, K) bf16 @ q (K, N) int8, times s (N,).
int isl_qmm_kn_tc(const void* x, const void* q, const void* s, int s_dtype,
                  void* out, void* part, int M, int K, int N, int k_len,
                  int splits, void* stream) {
  if (N % 16 || K % 8) return (int)cudaErrorInvalidValue;
  return tc::run<false>(x, q, s, s_dtype, out, part, M, K, N, k_len, splits,
                        static_cast<cudaStream_t>(stream));
}

// out (M, N) fp32 = x (M, K) bf16 @ q (N, K)^T int8, times s (N,).
int isl_qmm_nk_tc(const void* x, const void* q, const void* s, int s_dtype,
                  void* out, void* part, int M, int K, int N, int k_len,
                  int splits, void* stream) {
  if (K % 16) return (int)cudaErrorInvalidValue;
  return tc::run<true>(x, q, s, s_dtype, out, part, M, K, N, k_len, splits,
                       static_cast<cudaStream_t>(stream));
}

// The tile the tensor-core entries take at M rows: channels per block,
// rows of x per block, threads and dynamic shared memory (bytes).
int isl_qmm_tc_tile(int nk, int M, int* ct, int* mpad, int* threads,
                    int* smem, int* kt, int* stages) {
  if (M < 1 || M > 256) return (int)cudaErrorInvalidValue;
#define ISL_TC_REPORT(NK_, WC, WM, NT8, KT_, ST_)  \
  {                                                \
    using T = tc::Tile<NK_, WC, WM, NT8, KT_, ST_>;\
    *ct = T::CT; *mpad = T::MPAD;                  \
    *threads = T::THREADS; *smem = T::SMEM;        \
    *kt = T::KT; *stages = T::STAGES;              \
  }
  ISL_TC_BY_M(nk, M, ISL_TC_REPORT)
#undef ISL_TC_REPORT
  return 0;
}

}  // extern "C"
