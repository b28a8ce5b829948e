// Hopper (sm_90a) building blocks for the port's warp-specialised kernels:
// mbarriers, TMA tile loads through a tensor map, wgmma on shared-memory
// and register operands (its descriptor, fence, commit and wait), and
// setmaxnreg. Used by csrc/flash_attention.cu (B5, B6, B7).
//
// Layout convention: every shared-memory operand is a tile of rows of 64
// bf16 (128 bytes) written by TMA with CU_TENSOR_MAP_SWIZZLE_128B, so the
// 16-byte chunks of row r sit XOR-ed by r % 8 inside 1024-byte groups of
// 8 rows. A tile wider than 64 columns is several such "column boxes",
// one after the other. The wgmma descriptors below use the matching
// 128-byte swizzle mode; a tile must start on a 1024-byte boundary.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr uint32_t BOX_COLS = 64;       // bf16 columns of one swizzled box
constexpr uint32_t ROW_BYTES = 128;     // bytes of one row of a box
constexpr uint32_t GROUP_BYTES = 1024;  // 8 rows: one swizzle period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed. No timeout
// path: a trap reachable inside the wait makes ptxas serialise every
// wgmma of the kernel (warning C7512) and spill its accumulators.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA
// one box of a 3-D tensor map at element coordinates (c0, c1, c2) into
// shared memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands
// (the contracted index contiguous): 8-row groups GROUP_BYTES apart, the
// leading offset unused (1); a k16 step moves the start 32 bytes inside
// the 128-byte row, a 64-column step moves it to the next column box.
// MN-major operands (the other index contiguous, the transpose bit set):
// `lead` is the distance between 64-column boxes of the MN index, 8-row
// groups of the contracted index GROUP_BYTES apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(GROUP_BYTES >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return desc(addr, 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers at this point of the program (accumulators and register
// A operands of an asynchronous wgmma live until its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// `v` as a value the compiler must take as new here: addresses derived
// from it inside a loop are then built next to their use instead of
// being hoisted out of the loop and held in registers across it
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

#define ISL_D8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ISL_D32(d) ISL_D8(d, 0), ISL_D8(d, 8), ISL_D8(d, 16), ISL_D8(d, 24)
#define ISL_D64(d) ISL_D32(d), ISL_D8(d, 32), ISL_D8(d, 40), ISL_D8(d, 48), \
                   ISL_D8(d, 56)
#define ISL_R16                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define ISL_R32                                                         \
  ISL_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "   \
          "%27, %28, %29, %30, %31"
#define ISL_R64                                                         \
  ISL_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "   \
          "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
          "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 32 fp32, accumulated unless scale_d == 0) += A (64 x 16) B
// (16 x 32); A and B bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" ISL_R16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ISL_D8(d, 0), ISL_D8(d, 8)
      : "l"(a), "l"(b), "r"(scale_d));
}
// d (64 x 64) += A B with A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" ISL_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ISL_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
// d (64 x 128) += A B with A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" ISL_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ISL_D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
// d (64 x 128) += A B with A in registers (the mma.sync m16n8k16 A
// fragment of each warp's 16 rows) and B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128_rs_t(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" ISL_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ISL_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef ISL_D8
#undef ISL_D32
#undef ISL_D64
#undef ISL_R16
#undef ISL_R32
#undef ISL_R64

// ---------------------------------------------------------------- registers
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled is a driver-API call; the libraries link only
// the runtime, so it is looked up in the driver the process has loaded.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a contiguous bf16 (batch, rows, cols) tensor, boxes of
// (1, box_rows, 64) with 128-byte swizzle. A 3-D map keeps each batch's
// rows apart: rows past `rows` read as zero instead of the next batch's.
// Encoded on every launch (no stream call, so it is legal inside a CUDA
// graph capture) and never cached: the allocator reuses addresses.
inline bool tma_map_bf16(CUtensorMap* map, const void* base, int batch,
                         int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {BOX_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
