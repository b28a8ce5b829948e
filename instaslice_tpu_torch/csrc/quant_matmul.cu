// w8a16 matmul for Hopper: fp32/bf16 activations x int8 weights -> fp32.
//
// Replaces the Pallas kernels of instaslice_tpu/ops/quant_matmul.py:
//   _qmm_stacked_kernel (:138) and _qmm_kernel (:66)  -> qmm_kn_kernel
//   _qmm_t_kernel (:89)                               -> qmm_nk_kernel
//
// Bound on the H100: the int8 weight bytes. At decode row counts
// (M = batch) every weight byte feeds M multiply-adds, far below the
// ~295 operations per byte where the tensor cores would become the
// limit, so the kernels only have to stream int8 at full rate and never
// write a dequantized copy. The int8 -> fp32 convert is exact, sums are
// fp32, and the per-output-channel scale multiplies the finished sum
// once (sum_k x_k q_kn s_n = s_n sum_k x_k q_kn), as the TPU kernels do.
//
// (K, N) layout (projections): a warp's lanes own 8 consecutive columns
// each, so one row of a 256-column tile is one 256-byte coalesced read;
// the 8 warps of a block take interleaved rows of the block's K range,
// 8 rows' loads in flight per warp, and fold their partial sums in a
// fixed order through shared memory.
// x is staged in shared memory 256 rows at a time. Small tiles leave too
// few blocks for 132 SMs, so K is split across blocks (grid.z) and a
// second pass sums the splits in order and applies the scale: results
// are deterministic from run to run. The stacked layer index is a
// pointer offset the wrapper applies: the stack is never sliced.
//
// (N, K) layout (the embedding as unembedding): each warp owns 4 output
// rows of q, its lanes read 4 consecutive bytes of each (128 bytes per
// row and warp step), x is staged 1024 columns at a time and each
// lane's slice of it, read once per step, serves all 4 rows; a warp
// shuffle reduction finishes every output.
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

}  // extern "C"
