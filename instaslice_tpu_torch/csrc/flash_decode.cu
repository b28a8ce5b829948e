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
// fp32 scales (about 264 bytes per position and KV head at hd 128); the
// arithmetic per byte is tiny. Design:
// - one block per (b, kv head): the TPU's grid (B,) would light 8 of
//   132 SMs at batch 8; each block keeps its G query rows in registers;
// - the layer index (and the batch row) are pointer offsets into the
//   stacked buffer, so no slice of the cache is ever copied;
// - positions are walked in tiles of 64 and only up to the row's own
//   length (rows at depth 0 run no tile: m = -1e30, l = 0, acc = 0,
//   which merge_local turns into exactly the local-only softmax);
// - scores: 8 lanes per position, 16 int8 bytes each (one coalesced
//   128-byte row per position group), dequantized in registers; the
//   scale multiplies the finished dot;
// - values: each warp takes 16 positions of the tile, every lane owns
//   hd/32 dims; the warps' partial accumulators share one rescaling
//   history, so they are summed once at the end.
// Splitting S across blocks (with a merge pass) is later work.
#include "common.cuh"

namespace {

constexpr int FD_WARPS = 4;
constexpr int FD_THREADS = FD_WARPS * 32;
constexpr int FD_TS = 64;                  // positions per tile
constexpr int FD_PW = FD_TS / FD_WARPS;    // positions per warp and tile
constexpr int FD_VB = 8;                   // value rows loaded together

template <int VD>
__device__ __forceinline__ void load_values(const int8_t* p, float* out) {
  if constexpr (VD % 4 == 0) {
#pragma unroll
    for (int d = 0; d < VD; d += 4) {
      const char4 raw = __ldg(reinterpret_cast<const char4*>(p + d));
      out[d] = (float)raw.x; out[d + 1] = (float)raw.y;
      out[d + 2] = (float)raw.z; out[d + 3] = (float)raw.w;
    }
  } else {
    static_assert(VD == 2, "hd must be 64 or a multiple of 128");
    const char2 raw = __ldg(reinterpret_cast<const char2*>(p));
    out[0] = (float)raw.x; out[1] = (float)raw.y;
  }
}

template <int HD, int G, typename QT>
__global__ void __launch_bounds__(FD_THREADS)
    fd_kernel(const QT* __restrict__ q4, const int8_t* __restrict__ k3,
              const float* __restrict__ ks3, const int8_t* __restrict__ v3,
              const float* __restrict__ vs3, const int* __restrict__ lengths,
              float* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, int Hkv, int S,
              long long kv_layer_stride, long long kv_batch_stride,
              long long sc_layer_stride, long long sc_batch_stride,
              int layer, int s_attn, float sm_scale) {
  constexpr int LP = HD / 16;      // lanes per position (score phase)
  constexpr int PP = 32 / LP;      // positions per warp pass
  constexpr int VD = HD / 32;      // dims per lane (value phase)
  static_assert(HD % 32 == 0 && FD_PW % PP == 0, "unsupported head dim");
  static_assert(FD_TS == 64, "softmax phase reads two entries per lane");

  __shared__ float sc[G][FD_TS];
  __shared__ float alpha_s[G];
  __shared__ float m_s[G];
  __shared__ float l_s[G];
  __shared__ float red[FD_WARPS][G][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LP, grp = lane / LP;

  const int8_t* kb = k3 + layer * kv_layer_stride + b * kv_batch_stride +
                     (long long)h * S * HD;
  const int8_t* vb = v3 + layer * kv_layer_stride + b * kv_batch_stride +
                     (long long)h * S * HD;
  const float* ksb = ks3 + layer * sc_layer_stride + b * sc_batch_stride +
                     (long long)h * S;
  const float* vsb = vs3 + layer * sc_layer_stride + b * sc_batch_stride +
                     (long long)h * S;
  const int len = max(0, min(lengths[b], s_attn));

  // this lane's 16 dims of every query row, pre-scaled
  float qr[G][16];
  const QT* qb = q4 + ((size_t)b * Hkv + h) * G * HD;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      qr[g][j] = isl::to_f32(qb[g * HD + sub * 16 + j]) * sm_scale;

  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[G][VD];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int d = 0; d < VD; ++d) acc[g][d] = 0.f;
  __syncthreads();

  const int n_tiles = (len + FD_TS - 1) / FD_TS;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * FD_TS;
    // scores of this warp's positions, PP at a time; every pass's K row
    // and scale are loaded before any is used (loads in flight together)
    constexpr int NP = FD_PW / PP;
    int4 kraw[NP];
    float ksc[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int s = t0 + warp * FD_PW + p * PP + grp;
      kraw[p] = make_int4(0, 0, 0, 0);
      ksc[p] = 0.f;
      if (s < len) {
        kraw[p] = __ldg(
            reinterpret_cast<const int4*>(kb + (size_t)s * HD + sub * 16));
        ksc[p] = __ldg(ksb + s);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int t = warp * FD_PW + p * PP + grp;
      const int8_t* kv = reinterpret_cast<const int8_t*>(&kraw[p]);
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float kf = (float)kv[j];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = fmaf(qr[g][j], kf, part[g]);
      }
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (sub == 0) {
        const bool valid = t0 + t < len;
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[g][t] = valid ? part[g] * ksc[p] : -1e30f;
      }
    }
    __syncthreads();

    // online softmax update, one warp per query row
    for (int g = warp; g < G; g += FD_WARPS) {
      const float a = sc[g][lane], c = sc[g][lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, isl::warp_max(fmaxf(a, c)));
      const float pa = (t0 + lane < len) ? expf(a - m_new) : 0.f;
      const float pc = (t0 + lane + 32 < len) ? expf(c - m_new) : 0.f;
      const float sum = isl::warp_sum(pa + pc);
      sc[g][lane] = pa;
      sc[g][lane + 32] = pc;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // values
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = alpha_s[g];
#pragma unroll
      for (int d = 0; d < VD; ++d) acc[g][d] *= alpha;
    }
    // this warp's positions, FD_VB at a time: their values and scales
    // are loaded before any is used (positions past len load as 0, and
    // their probabilities are 0)
#pragma unroll
    for (int i0 = 0; i0 < FD_PW; i0 += FD_VB) {
      float vf[FD_VB][VD];
      float vsc[FD_VB];
#pragma unroll
      for (int i = 0; i < FD_VB; ++i) {
        const int s = t0 + warp * FD_PW + i0 + i;
        vsc[i] = 0.f;
#pragma unroll
        for (int d = 0; d < VD; ++d) vf[i][d] = 0.f;
        if (s < len) {
          load_values<VD>(vb + (size_t)s * HD + lane * VD, vf[i]);
          vsc[i] = __ldg(vsb + s);
        }
      }
#pragma unroll
      for (int i = 0; i < FD_VB; ++i) {
        const int t = warp * FD_PW + i0 + i;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[g][t] * vsc[i];
#pragma unroll
          for (int d = 0; d < VD; ++d) acc[g][d] = fmaf(p, vf[i][d], acc[g][d]);
        }
      }
    }
    __syncthreads();
  }

  // the warps' partial accumulators share one rescaling history: sum them
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int d = 0; d < VD; ++d) red[warp][g][lane * VD + d] = acc[g][d];
  __syncthreads();
  const size_t row = (size_t)b * Hkv + h;
  for (int i = tid; i < G * HD; i += FD_THREADS) {
    const int g = i / HD, d = i % HD;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) v += red[w][g][d];
    o[(row * G + g) * HD + d] = v;
  }
  if (tid < G) {
    m_out[row * G + tid] = m_s[tid];
    l_out[row * G + tid] = l_s[tid];
  }
}

template <int HD, int G, typename QT>
void launch_fd(const void* q4, const void* k3, const void* ks3, const void* v3,
               const void* vs3, const void* lengths, void* o, void* m, void* l,
               int B, int Hkv, int S, long long kv_ls, long long kv_bs,
               long long sc_ls, long long sc_bs, int layer, int s_attn,
               float sm_scale, cudaStream_t st) {
  fd_kernel<HD, G, QT><<<dim3(B, Hkv), FD_THREADS, 0, st>>>(
      static_cast<const QT*>(q4), static_cast<const int8_t*>(k3),
      static_cast<const float*>(ks3), static_cast<const int8_t*>(v3),
      static_cast<const float*>(vs3), static_cast<const int*>(lengths),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      Hkv, S, kv_ls, kv_bs, sc_ls, sc_bs, layer, s_attn, sm_scale);
}

template <int HD, typename QT>
bool dispatch_g(int G, const void* q4, const void* k3, const void* ks3,
                const void* v3, const void* vs3, const void* lengths, void* o,
                void* m, void* l, int B, int Hkv, int S, long long kv_ls,
                long long kv_bs, long long sc_ls, long long sc_bs, int layer,
                int s_attn, float sm_scale, cudaStream_t st) {
#define ISL_FD_CASE(GV)                                                      \
  case GV:                                                                   \
    launch_fd<HD, GV, QT>(q4, k3, ks3, v3, vs3, lengths, o, m, l, B, Hkv, S, \
                          kv_ls, kv_bs, sc_ls, sc_bs, layer, s_attn,         \
                          sm_scale, st);                                     \
    return true;
  switch (G) {
    ISL_FD_CASE(1)
    ISL_FD_CASE(2)
    ISL_FD_CASE(4)
    ISL_FD_CASE(8)
    default:
      return false;
  }
#undef ISL_FD_CASE
}

template <typename QT>
bool dispatch_hd(int HD, int G, const void* q4, const void* k3,
                 const void* ks3, const void* v3, const void* vs3,
                 const void* lengths, void* o, void* m, void* l, int B,
                 int Hkv, int S, long long kv_ls, long long kv_bs,
                 long long sc_ls, long long sc_bs, int layer, int s_attn,
                 float sm_scale, cudaStream_t st) {
  if (HD == 64)
    return dispatch_g<64, QT>(G, q4, k3, ks3, v3, vs3, lengths, o, m, l, B,
                              Hkv, S, kv_ls, kv_bs, sc_ls, sc_bs, layer,
                              s_attn, sm_scale, st);
  if (HD == 128)
    return dispatch_g<128, QT>(G, q4, k3, ks3, v3, vs3, lengths, o, m, l, B,
                               Hkv, S, kv_ls, kv_bs, sc_ls, sc_bs, layer,
                               s_attn, sm_scale, st);
  return false;
}

}  // namespace

extern "C" {

// q4 (B, Hkv, G, HD) f32/bf16; k3/v3 int8 and ks3/vs3 fp32 with
// contiguous (Hkv, S[, HD]) inner dims and the given layer/batch strides
// (in elements); lengths (B,) int32 -> o (B, Hkv, G, HD), m and l
// (B, Hkv, G), all fp32. Returns cudaGetLastError() after the launch.
int isl_flash_decode(const void* q4, int q_dtype, const void* k3,
                     const void* ks3, const void* v3, const void* vs3,
                     const void* lengths, void* o, void* m, void* l, int B,
                     int Hkv, int G, int S, int HD, long long kv_layer_stride,
                     long long kv_batch_stride, long long sc_layer_stride,
                     long long sc_batch_stride, int layer, int s_attn,
                     float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (q_dtype == ISL_F32)
    ok = dispatch_hd<float>(HD, G, q4, k3, ks3, v3, vs3, lengths, o, m, l, B,
                            Hkv, S, kv_layer_stride, kv_batch_stride,
                            sc_layer_stride, sc_batch_stride, layer, s_attn,
                            sm_scale, st);
  else if (q_dtype == ISL_BF16)
    ok = dispatch_hd<__nv_bfloat16>(HD, G, q4, k3, ks3, v3, vs3, lengths, o,
                                    m, l, B, Hkv, S, kv_layer_stride,
                                    kv_batch_stride, sc_layer_stride,
                                    sc_batch_stride, layer, s_attn, sm_scale,
                                    st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
