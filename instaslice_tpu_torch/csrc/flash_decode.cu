// Decode attention (one query step, T = 1) over the stacked int8 KV
// cache, for Hopper.
//
// Replaces the Pallas kernel instaslice_tpu/ops/flash_decode.py:59
// _fd_kernel (launched by _fd_call, wrapped by quant_decode_attention).
// Same contract: for layer `layer` of the head-major cache
// (L, B, Hkv, S, hd) int8 with fp32 per-position scales, the G query
// rows of each (b, kv head) attend the positions s < min(lengths[b],
// s_attn); the kernel returns the unnormalized fp32 accumulator and the
// running max m and sum l, so the caller folds in the step's own fresh
// entry with the online-softmax identity (merge_local).
//
// Bound on the H100: the bytes of the live int8 K/V prefix plus its
// fp32 scales (about 264 bytes per position and KV head at hd 128). The
// arithmetic is about 16 flops per byte, held to fp32 (1e-5), so it
// stays on the CUDA cores, whose 67 TFLOP/s need nearly as long for it
// as the memory needs for the bytes: what sets the time is getting every
// byte in flight at once and spending few instructions per byte once it
// has landed. Design:
// - the prefix is split across blocks: the grid is (B, Hkv, n_split),
//   and block z of (b, kv head) takes the positions [z P, (z + 1) P) of
//   the row's live prefix [0, min(lengths[b], s_attn)). P, a multiple of
//   64, and n_split = ceil(s_attn / P) come from B, Hkv and s_attn alone
//   (fd_plan), never from `lengths`, so the host never waits on the card
//   and a captured step replays with any lengths. The rule: the smallest
//   P that keeps the grid at no more than FD_TARGET_BLOCKS (about four
//   blocks of 128 threads per SM, all resident at once), at most 256;
//   at batch 8 x 8 KV heads that is 256 blocks at s_attn 256 and 512 at
//   s_attn 1024;
// - a block first issues the cp.async copies of its whole chunk, K as
//   one group and V as a second (16 bytes a thread, every byte in flight
//   together), then the scales and its query rows by plain loads into
//   registers, and waits for K only when the scores need it and for V
//   only after the softmax;
// - the layer index and the batch row are pointer offsets into the
//   stacked buffer, so no slice of the cache is ever copied; the batch
//   stride is a parameter (a slot subset of a larger cache is a strided
//   view);
// - scores: hd / 16 lanes per position, 16 int8 values each, against
//   the lane's 16 query dims in registers; the scale multiplies the
//   finished dot; the softmax runs over the whole chunk at once, one
//   warp per query row (no rescaling inside a block);
// - values: each thread owns 4 dims and every PG-th position of the
//   chunk; the position groups are summed through shared memory in a
//   fixed order;
// - a block whose chunk starts at or past its row's length writes the
//   empty partial (m = -1e30, l = 0, acc = 0) and returns;
// - the partials (B, Hkv, n_split, G, hd + 2) are combined by
//   fd_combine_kernel over (B, Hkv, G) with the online-softmax identity,
//   split by split in order, so two runs are bit-equal and an all-empty
//   row comes out exactly (-1e30, 0, 0). With one split the combine
//   copies the partial unchanged (its factor is exp(0) = 1).
#include "common.cuh"

namespace {

constexpr int FD_THREADS = 128;
constexpr int FD_TILE = 64;             // P is a multiple of this
constexpr int FD_MAX_TILES = 4;         // P <= 256
constexpr int FD_TARGET_BLOCKS = 512;   // ~4 resident blocks per SM
constexpr int SC_PER_THREAD = FD_TILE * FD_MAX_TILES / FD_THREADS;
constexpr float FD_NEG = -1e30f;

struct Plan {
  int P, n_split;
};

// the split of the prefix, from host-known values only (mirrored by
// ops/flash_decode.py split_plan)
inline Plan fd_plan(int B, int Hkv, int s_attn) {
  const long long tiles = (s_attn + FD_TILE - 1) / FD_TILE;
  long long per = (tiles * B * Hkv + FD_TARGET_BLOCKS - 1) / FD_TARGET_BLOCKS;
  per = per < 1 ? 1 : (per > FD_MAX_TILES ? FD_MAX_TILES : per);
  const int P = FD_TILE * (int)per;
  return {P, (s_attn + P - 1) / P};
}

// dims per thread (value phase) and position groups of the block
template <int HD>
struct Layout {
  static constexpr int LP = HD / 16;           // lanes per position
  static constexpr int PP = 32 / LP;           // positions per warp pass
  static constexpr int DG = HD / 4;            // dim groups of 4
  static constexpr int PG = FD_THREADS / DG;   // position groups
  static_assert(HD == 64 || HD == 128, "head dim 64 or 128");
};

// shared-memory bytes of a chunk of P positions: the K tile (whose bytes
// the value phase's partial sums reuse) or those sums if larger, the V
// tile, scores, scales, and the rows' m and l
template <int HD, int G>
__host__ __device__ constexpr size_t fd_red_bytes() {
  return 4 * (size_t)Layout<HD>::PG * G * HD;
}
template <int HD, int G>
__host__ __device__ constexpr size_t fd_k_bytes(int P) {
  return (size_t)P * HD > fd_red_bytes<HD, G>() ? (size_t)P * HD
                                                 : fd_red_bytes<HD, G>();
}
template <int HD, int G>
__host__ __device__ constexpr size_t fd_smem(int P) {
  return fd_k_bytes<HD, G>(P) + (size_t)P * HD +
         4 * ((size_t)G * P + 2 * P + 2 * G);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four int8 packed in a word -> four exact floats without the
// quarter-rate I2F conversion: each byte, offset by 128, becomes the low
// mantissa byte of 2^23 (one byte permute), and 2^23 + 128 is subtracted
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) -
           8388736.f;
}

// 16 consecutive query values times `scale`, by 16-byte loads
__device__ __forceinline__ void load16(const float* p, float scale,
                                       float (&out)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + c);
    out[4 * c] = v.x * scale;
    out[4 * c + 1] = v.y * scale;
    out[4 * c + 2] = v.z * scale;
    out[4 * c + 3] = v.w * scale;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float scale,
                                       float (&out)[16]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + c);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[8 * c + j] = __bfloat162float(h[j]) * scale;
  }
}

// the empty partial (acc 0, m -1e30, l 0) of G rows, (G, HD + 2)
template <int HD, int G>
__device__ __forceinline__ void put_empty(float* part) {
  for (int i = threadIdx.x; i < G * (HD + 2); i += FD_THREADS)
    part[i] = i % (HD + 2) == HD ? FD_NEG : 0.f;
}

template <int HD, int G, typename QT>
__global__ void __launch_bounds__(FD_THREADS)
    fd_kernel(const QT* __restrict__ q4, const int8_t* __restrict__ k3,
              const float* __restrict__ ks3, const int8_t* __restrict__ v3,
              const float* __restrict__ vs3, const int* __restrict__ lengths,
              float* __restrict__ part, int Hkv,
              int S, long long kv_layer_stride, long long kv_batch_stride,
              long long sc_layer_stride, long long sc_batch_stride, int layer,
              int s_attn, int P, float sm_scale) {
  using Ly = Layout<HD>;
  extern __shared__ __align__(16) uint8_t fd_smem_raw[];
  int8_t* sK = reinterpret_cast<int8_t*>(fd_smem_raw);      // [P][HD]
  float* red = reinterpret_cast<float*>(fd_smem_raw);       // [PG][G][HD]
  int8_t* sV = sK + fd_k_bytes<HD, G>(P);                   // [P][HD]
  float* sS = reinterpret_cast<float*>(sV + P * HD);        // [G][P]
  float* sKs = sS + G * P;                                  // [P]
  float* sVs = sKs + P;                                     // [P]
  float* sM = sVs + P;                                      // [G]
  float* sL = sM + G;                                       // [G]

  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * Hkv + h;
  part += (row * gridDim.z + z) * G * (HD + 2);
  const int len = max(0, min(lengths[b], s_attn));
  const int start = z * P;
  if (start >= len) {
    // nothing of the prefix in this chunk
    put_empty<HD, G>(part);
    return;
  }
  const int n = min(len - start, P);
  const size_t kv_off = layer * kv_layer_stride + b * kv_batch_stride +
                        ((size_t)h * S + start) * HD;
  const size_t sc_off = layer * sc_layer_stride + b * sc_batch_stride +
                        (size_t)h * S + start;

  // the chunk's K, then its V, in flight together
  for (int i = tid; i < n * HD / 16; i += FD_THREADS)
    cp_async16(sK + i * 16, k3 + kv_off + (size_t)i * 16);
  cp_async_commit();
  for (int i = tid; i < n * HD / 16; i += FD_THREADS)
    cp_async16(sV + i * 16, v3 + kv_off + (size_t)i * 16);
  cp_async_commit();
  // the chunk's scales and this lane's 16 dims of every query row
  // (pre-scaled): plain loads, all issued before any is used
  float ksc[SC_PER_THREAD], vsc[SC_PER_THREAD];
#pragma unroll
  for (int j = 0; j < SC_PER_THREAD; ++j) {
    const int p = tid + j * FD_THREADS;
    ksc[j] = p < n ? __ldg(ks3 + sc_off + p) : 0.f;
    vsc[j] = p < n ? __ldg(vs3 + sc_off + p) : 0.f;
  }
  const int sub = lane % Ly::LP, grp = lane / Ly::LP;
  float qr[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load16(q4 + (row * G + g) * HD + sub * 16, sm_scale, qr[g]);
#pragma unroll
  for (int j = 0; j < SC_PER_THREAD; ++j) {
    const int p = tid + j * FD_THREADS;
    if (p < n) {
      sKs[p] = ksc[j];
      sVs[p] = vsc[j];
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  // scores s[g][p] = (q_g . k_p) * k_scale_p
  for (int p0 = 0; p0 < n; p0 += FD_THREADS / 32 * Ly::PP) {
    const int p = p0 + warp * Ly::PP + grp;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
    if (p < n) kraw = *reinterpret_cast<const uint4*>(sK + p * HD + sub * 16);
    const uint32_t kw[4] = {kraw.x, kraw.y, kraw.z, kraw.w};
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float kf[4];
      i8x4_to_f32(kw[c], kf);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < G; ++g)
          dot[g] = fmaf(qr[g][4 * c + j], kf[j], dot[g]);
    }
#pragma unroll
    for (int off = Ly::LP / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
    if (sub == 0 && p < n)
#pragma unroll
      for (int g = 0; g < G; ++g) sS[g * P + p] = dot[g] * sKs[p];
  }
  __syncthreads();

  // softmax over the chunk, one warp per query row: m, l, and p times
  // the value scale in place of the score
  for (int g = warp; g < G; g += FD_THREADS / 32) {
    float mx = FD_NEG;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, sS[g * P + p]);
    mx = isl::warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float e = expf(sS[g * P + p] - mx);
      sum += e;
      sS[g * P + p] = e * sVs[p];
    }
    sum = isl::warp_sum(sum);
    if (lane == 0) {
      sM[g] = mx;
      sL[g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // values: dims [4 dg, 4 dg + 4) over positions pg, pg + PG, ...; the
  // sums go to `red`, over the K tile (every read of it ended before the
  // barrier above)
  const int dg = tid % Ly::DG, pg = tid / Ly::DG;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
#pragma unroll 4
  for (int p = pg; p < n; p += Ly::PG) {
    float v[4];
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(sV + p * HD + 4 * dg), v);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pv = sS[g * P + p];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(pv, v[j], acc[g][j]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(pg * G + g) * HD + 4 * dg + j] = acc[g][j];
  __syncthreads();
  for (int i = tid; i < G * (HD + 2); i += FD_THREADS) {
    const int g = i / (HD + 2), d = i % (HD + 2);
    float v;
    if (d < HD) {
      v = 0.f;
#pragma unroll
      for (int q = 0; q < Ly::PG; ++q) v += red[(q * G + g) * HD + d];
    } else {
      v = d == HD ? sM[g] : sL[g];
    }
    part[i] = v;
  }
}

// the n_split partials (n_split, G, HD + 2) of each (b, kv head) -> its
// (acc, m, l): m the largest of the splits' maxima, acc and l summed
// split by split in order, each split's term rescaled by exp(m_z - m).
// Block (b, kv head, g), one thread per output (d == HD: l): every load
// of the block is issued before the one barrier (the maxima into shared
// memory, a thread's first FD_CC terms into registers), so the block
// waits on memory about once.
constexpr int FD_CC = 8;
template <int HD, int G>
__global__ void __launch_bounds__(HD + 1)
    fd_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int n_split) {
  extern __shared__ float m_z[];                  // [n_split]
  const int g = blockIdx.z, d = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
  const size_t stride = G * (HD + 2);             // between splits
  const float* pr = part + row * n_split * stride + g * (HD + 2);
  const float* src = pr + (d < HD ? d : HD + 1);
  for (int z = d; z < n_split; z += HD + 1) m_z[z] = pr[z * stride + HD];
  float t[FD_CC];
#pragma unroll
  for (int j = 0; j < FD_CC; ++j) t[j] = j < n_split ? src[j * stride] : 0.f;
  __syncthreads();
  float m = FD_NEG;
  for (int z = 0; z < n_split; ++z) m = fmaxf(m, m_z[z]);
  float v = 0.f;
  for (int z0 = 0; z0 < n_split; z0 += FD_CC) {
    if (z0 > 0) {
#pragma unroll
      for (int j = 0; j < FD_CC; ++j)
        t[j] = z0 + j < n_split ? src[(z0 + j) * stride] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < FD_CC; ++j)
      if (z0 + j < n_split) v = fmaf(t[j], expf(m_z[z0 + j] - m), v);
  }
  if (d < HD) {
    o[(row * G + g) * HD + d] = v;
  } else {
    m_out[row * G + g] = m;
    l_out[row * G + g] = v;
  }
}

template <int HD, int G, typename QT>
cudaError_t launch_fd(const void* q4, const void* k3, const void* ks3,
                      const void* v3, const void* vs3, const void* lengths,
                      void* o, void* m, void* l, void* part, int B, int Hkv,
                      int S, long long kv_ls, long long kv_bs, long long sc_ls,
                      long long sc_bs, int layer, int s_attn, float sm_scale,
                      cudaStream_t st) {
  // more than 48 KB of dynamic shared memory at the largest chunk: opted
  // into once per instantiation (the first launch happens outside any
  // CUDA graph capture); one card per process
  static bool smem_ok = false;
  auto* fn = fd_kernel<HD, G, QT>;
  if (!smem_ok) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)fd_smem<HD, G>(FD_TILE * FD_MAX_TILES));
    // all of the SM's unified memory as shared memory: as many resident
    // blocks as it holds chunks
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    smem_ok = true;
  }
  const Plan plan = fd_plan(B, Hkv, s_attn);
  fn<<<dim3(B, Hkv, plan.n_split), FD_THREADS, fd_smem<HD, G>(plan.P), st>>>(
      static_cast<const QT*>(q4), static_cast<const int8_t*>(k3),
      static_cast<const float*>(ks3), static_cast<const int8_t*>(v3),
      static_cast<const float*>(vs3), static_cast<const int*>(lengths),
      static_cast<float*>(part), Hkv, S, kv_ls, kv_bs, sc_ls, sc_bs, layer,
      s_attn, plan.P, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_combine_kernel<HD, G><<<dim3(B, Hkv, G), HD + 1, 4 * plan.n_split, st>>>(
      static_cast<const float*>(part), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), plan.n_split);
  return cudaGetLastError();
}

template <int HD, typename QT>
cudaError_t dispatch_g(int G, const void* q4, const void* k3, const void* ks3,
                       const void* v3, const void* vs3, const void* lengths,
                       void* o, void* m, void* l, void* part, int B, int Hkv,
                       int S, long long kv_ls, long long kv_bs,
                       long long sc_ls, long long sc_bs, int layer,
                       int s_attn, float sm_scale, cudaStream_t st) {
#define ISL_FD_CASE(GV)                                                    \
  case GV:                                                                 \
    return launch_fd<HD, GV, QT>(q4, k3, ks3, v3, vs3, lengths, o, m, l,   \
                                 part, B, Hkv, S, kv_ls, kv_bs, sc_ls,     \
                                 sc_bs, layer, s_attn, sm_scale, st);
  switch (G) {
    ISL_FD_CASE(1)
    ISL_FD_CASE(2)
    ISL_FD_CASE(4)
    ISL_FD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef ISL_FD_CASE
}

template <typename QT>
cudaError_t dispatch_hd(int HD, int G, const void* q4, const void* k3,
                        const void* ks3, const void* v3, const void* vs3,
                        const void* lengths, void* o, void* m, void* l,
                        void* part, int B, int Hkv, int S, long long kv_ls,
                        long long kv_bs, long long sc_ls, long long sc_bs,
                        int layer, int s_attn, float sm_scale,
                        cudaStream_t st) {
  if (HD == 64)
    return dispatch_g<64, QT>(G, q4, k3, ks3, v3, vs3, lengths, o, m, l, part,
                              B, Hkv, S, kv_ls, kv_bs, sc_ls, sc_bs, layer,
                              s_attn, sm_scale, st);
  if (HD == 128)
    return dispatch_g<128, QT>(G, q4, k3, ks3, v3, vs3, lengths, o, m, l,
                               part, B, Hkv, S, kv_ls, kv_bs, sc_ls, sc_bs,
                               layer, s_attn, sm_scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The split of the prefix for (B, Hkv, s_attn): positions per block P and
// the number of splits (the wrapper sizes the partials by it).
int isl_fd_plan(int B, int Hkv, int s_attn, int* P, int* n_split) {
  if (B <= 0 || Hkv <= 0 || s_attn <= 0) return (int)cudaErrorInvalidValue;
  const Plan plan = fd_plan(B, Hkv, s_attn);
  *P = plan.P;
  *n_split = plan.n_split;
  return 0;
}

// q4 (B, Hkv, G, HD) f32/bf16; k3/v3 int8 and ks3/vs3 fp32 with
// contiguous (Hkv, S[, HD]) inner dims and the given layer/batch strides
// (in elements); lengths (B,) int32 -> o (B, Hkv, G, HD), m and l
// (B, Hkv, G), all fp32. `part` is fp32 scratch of (B, Hkv, n_split, G,
// HD + 2), `n_split` the plan's (isl_fd_plan). Returns the launches'
// cudaError_t.
int isl_flash_decode(const void* q4, int q_dtype, const void* k3,
                     const void* ks3, const void* v3, const void* vs3,
                     const void* lengths, void* o, void* m, void* l,
                     void* part, int n_split, int B, int Hkv, int G, int S,
                     int HD, long long kv_layer_stride,
                     long long kv_batch_stride, long long sc_layer_stride,
                     long long sc_batch_stride, int layer, int s_attn,
                     float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hkv > 65535 || s_attn <= 0 || s_attn > S)
    return (int)cudaErrorInvalidValue;
  const Plan plan = fd_plan(B, Hkv, s_attn);
  if (plan.n_split != n_split || part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == ISL_F32)
    return (int)dispatch_hd<float>(HD, G, q4, k3, ks3, v3, vs3, lengths, o, m,
                                   l, part, B, Hkv, S, kv_layer_stride,
                                   kv_batch_stride, sc_layer_stride,
                                   sc_batch_stride, layer, s_attn, sm_scale,
                                   st);
  if (q_dtype == ISL_BF16)
    return (int)dispatch_hd<__nv_bfloat16>(
        HD, G, q4, k3, ks3, v3, vs3, lengths, o, m, l, part, B, Hkv, S,
        kv_layer_stride, kv_batch_stride, sc_layer_stride, sc_batch_stride,
        layer, s_attn, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
