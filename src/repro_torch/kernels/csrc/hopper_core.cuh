// Hopper's asynchronous machinery, for the kernel library's GEMM
// (matmul.cu): TMA descriptors and 2-D tile loads, mbarriers, the
// warpgroup product wgmma.mma_async (m64n256k16, fp32 accumulation, A
// K-major, B MN-major) and setmaxnreg.  sm_90a only.
//
// * TMA.  cuTensorMapEncodeTiled is a driver function and the libraries
//   link only the CUDA runtime (build.py's NVCC_FLAGS have no -lcuda), so
//   encode_tiled() asks the runtime for the driver's entry point once
//   (cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint before
//   CUDA 12.5).  A descriptor travels to the kernel by value as a
//   `const __grid_constant__ CUtensorMap` parameter.  Boxes are 128 bytes
//   wide (64 16-bit elements) with 128-byte swizzle; elements outside the
//   tensor arrive as zeros, which masks every edge of a tile.  The global
//   base address and row stride must be multiples of 16 bytes.
// * Shared tiles under 128-byte swizzle start on 1024-byte boundaries
//   (eight 128-byte rows, one swizzle atom), so that TMA's swizzle and
//   wgmma's agree (the descriptor's base offset stays 0).
// * wgmma reads both operands from shared memory through 64-bit
//   descriptors: start address, leading byte offset (LBO) and stride byte
//   offset (SBO), each in 16-byte units, and the layout (1 = 128-byte
//   swizzle).  K-major A (rows of 64 K values, 128 bytes): SBO = 1024, the
//   step from 8 rows to the next 8; LBO unused; the k-th 16-wide step
//   starts 32 k bytes into the rows.  MN-major B (row-major K x N, rows of
//   64 N values a box): LBO = the step from one 64-column box to the next,
//   SBO = 1024, the step from 8 K rows to the next 8; the transpose-B bit
//   (16-bit types only) says B is MN-major.
// * A wrong mbarrier phase parity waits forever: the producer waits for
//   the (r - 1)-th release of a stage before its r-th load, the consumers
//   for the r-th arrival, parity r & 1.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums: declarations only
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hc {

// ---- host: TMA descriptors -------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or nullptr where the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) tensor of 16-bit T with a row stride of `ld`
// elements, read in boxes of box_rows x 64 elements with 128-byte swizzle
// (out-of-bounds elements read as zeros).  False if the driver refuses it.
template <typename T>
inline bool tensor_map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint64_t ld, uint32_t box_rows) {
  static_assert(sizeof(T) == 2, "16-bit elements: a 128-byte box row is 64 of them");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * sizeof(T)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: barriers and copies --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transfers in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 along the contiguous dimension, c1 along the other)
// into shared memory at dst, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- device: registers and warpgroup products --------------------------------

// Registers a thread of this warpgroup may hold from here on (a multiple of
// 8 in [24, 256]); every warp of the warpgroup executes it.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Keeps the compiler from moving an accumulator across an asynchronous
// product that writes it.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

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

// The descriptor of a 128-byte-swizzled operand tile at p (see above).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// d (64 x 256, fp32, the warpgroup's accumulator) += A (64 x 16, K-major) .
// B (16 x 256, MN-major), asynchronously.  Thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + 8 h and columns 8 j + 2 (t % 4) + e in
// d[4 j + 2 h + e].
#define HC_D8(i)                                                                          \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]),   \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HC_D32(i) HC_D8(i), HC_D8((i) + 8), HC_D8((i) + 16), HC_D8((i) + 24)
#define HC_WGMMA_N256(TYPES)                                                              \
  asm volatile(                                                                           \
      "{\n"                                                                               \
      ".reg .pred p;\n"                                                                   \
      "setp.ne.b32 p, %130, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPES " "                            \
      "{"                                                                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                          \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                          \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                                          \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                                          \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                                          \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                                          \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                                          \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                                      \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                                  \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                                  \
      "%120, %121, %122, %123, %124, %125, %126, %127 "                                   \
      "}, %128, %129, p, 1, 1, 0, 1;\n"                                                   \
      "}\n"                                                                               \
      : HC_D32(0), HC_D32(32), HC_D32(64), HC_D32(96)                                     \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    HC_WGMMA_N256("f16.f16");
  else
    HC_WGMMA_N256("bf16.bf16");
}
#undef HC_WGMMA_N256
#undef HC_D32
#undef HC_D8

}  // namespace hc
