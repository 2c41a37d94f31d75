// Hopper's asynchronous machinery, for the kernel library's GEMM
// (matmul.cu), FlashMLA (mla.cu), the head-width-256 attention walk
// (hopper_attention.cuh), the paged decode's bulk-copy walk
// (decode_walk.cuh) and the dequantized GEMM's walk (dequant_wgmma.cuh):
// TMA descriptors (16-bit tiles, and byte tiles of any swizzle) and 2-D /
// 3-D / 4-D tile loads, 1-D bulk copies, mbarriers, named barriers, the
// warpgroup product wgmma.mma_async (fp32 accumulation: m64n256k16 with A
// from shared memory or registers and B MN-major; m64nNk16, N 32, 48 or 64,
// with A and B both K-major; m64nNk16 with A from registers and B K-major,
// and its s8 twin m64nNk32 with s32 accumulation, N 8 to 256 in powers of
// two) and setmaxnreg.  sm_90a only.
//
// * TMA.  cuTensorMapEncodeTiled is a driver function and the libraries
//   link only the CUDA runtime (build.py's NVCC_FLAGS have no -lcuda), so
//   encode_tiled() asks the runtime for the driver's entry point once
//   (cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint before
//   CUDA 12.5).  A descriptor travels to the kernel by value as a
//   `const __grid_constant__ CUtensorMap` parameter.  Boxes are 128 bytes
//   wide (64 16-bit elements) with 128-byte swizzle; elements outside the
//   tensor arrive as zeros, which masks every edge of a tile (a 3-D map's
//   box stops at the end of its own batch row).  The global base address
//   and row strides must be multiples of 16 bytes.
// * Shared tiles under 128-byte swizzle start on 1024-byte boundaries
//   (eight 128-byte rows, one swizzle atom), so that TMA's swizzle and
//   wgmma's agree (the descriptor's base offset stays 0).  Row r's 16-byte
//   chunk c of such a tile lies at r * 128 + ((c ^ r % 8) * 16).
// * wgmma reads its shared operands through 64-bit descriptors: start
//   address, leading byte offset (LBO) and stride byte offset (SBO), each
//   in 16-byte units, and the layout (1 = 128-byte swizzle).  K-major
//   operand (rows of 64 K values, 128 bytes; A, or B stored N x K as the
//   keys of an attention score): SBO = 1024, the step from 8 rows to the
//   next 8; LBO unused; the k-th 16-wide step starts 32 k bytes into the
//   rows.  MN-major B (row-major K x N, rows of 64 N values a box): LBO =
//   the step from one 64-column box to the next, SBO = 1024, the step from
//   8 K rows to the next 8; the transpose-B bit (16-bit types only) says B
//   is MN-major.  A from registers takes mma.sync's A fragment layout
//   (m16n8k16) in each warp's 16 rows: an fp32 accumulator's pairs,
//   rounded and packed, are already an A operand (FlashAttention-3's trick).
// * A wrong mbarrier phase parity waits forever: the producer waits for
//   the (r - 1)-th release of a stage before its r-th load, the consumers
//   for the r-th arrival, parity r & 1.
// * Named barriers (bar.sync / bar.arrive with a thread count) hand data
//   between warpgroups without stopping the others: the writer arrives, the
//   reader syncs.  Generic stores that a wgmma of another warpgroup reads
//   need fence_proxy_async() before the writer arrives.

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

// A tensor of `type` elements of `elem` bytes read in boxes of box_cols
// contiguous elements x box_rows rows (x 1 in a third and fourth dimension)
// with `swizzle` (out-of-bounds elements read as zeros): `rank` 2 to 4
// dimensions, the contiguous one first; strides in elements, the contiguous
// one's (1) left out, in any order (a (B, S, H, D) projection read as (D, S,
// H, B) has its row stride above its head stride).  A swizzled box row is
// the swizzle's span at most (32, 64 or 128 bytes).  False if
// cuTensorMapEncodeTiled refuses it.
inline bool tensor_map_raw(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem,
                           const void* base, uint32_t rank, const uint64_t* dims,
                           const uint64_t* strides, uint32_t box_cols, uint32_t box_rows,
                           CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rank < 2 || rank > 4) return false;
  cuuint64_t d[4], st[3];
  for (uint32_t i = 0; i < rank; ++i) d[i] = dims[i];
  for (uint32_t i = 0; i + 1 < rank; ++i) st[i] = strides[i] * elem;
  const cuuint32_t box[4] = {box_cols, box_rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), d, st, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor of 16-bit T read in boxes of 64 contiguous elements x box_rows
// rows with 128-byte swizzle (tensor_map_raw's rules).
template <typename T>
inline bool tensor_map(CUtensorMap* map, const void* base, uint32_t rank, const uint64_t* dims,
                       const uint64_t* strides, uint32_t box_rows) {
  static_assert(sizeof(T) == 2, "16-bit elements: a 128-byte box row is 64 of them");
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return tensor_map_raw(map, type, 2, base, rank, dims, strides, 64, box_rows,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

// A row-major (rows, cols) tensor of bytes with a row stride of `ld` bytes,
// read in boxes of box_cols bytes (16, 32, 64 or 128) x box_rows rows, the
// box row swizzled over its own span (none at 16 bytes): 8 consecutive rows
// of a box then read the same logical 16-byte chunk from 8 distinct bank
// groups.
inline bool byte_map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                        uint64_t ld, uint32_t box_cols, uint32_t box_rows) {
  const CUtensorMapSwizzle sw = box_cols == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (box_cols != 16 && box_cols != 32 && box_cols != 64 && box_cols != 128) return false;
  const uint64_t dims[2] = {cols, rows}, strides[1] = {ld};
  return tensor_map_raw(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, 2, dims, strides, box_cols,
                        box_rows, sw);
}

// A row-major (rows, cols) tensor with a row stride of `ld` elements.
template <typename T>
inline bool tensor_map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint64_t ld, uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {ld};
  return tensor_map<T>(map, base, 2, dims, strides, box_rows);
}

// `batches` row-major (rows, cols) matrices, a row stride of `ld` and a
// batch stride of `batch_ld` elements: a box never crosses into the next
// batch's rows.
template <typename T>
inline bool tensor_map_3d(CUtensorMap* map, const void* base, uint64_t batches, uint64_t rows,
                          uint64_t cols, uint64_t ld, uint64_t batch_ld, uint32_t box_rows) {
  const uint64_t dims[3] = {cols, rows, batches}, strides[2] = {ld, batch_ld};
  return tensor_map<T>(map, base, 3, dims, strides, box_rows);
}

// `batches` x `heads` matrices of `rows` rows and `cols` columns, given by
// their row, head and batch strides in elements (a (B, H, S, D) view of a
// (B, S, H, D) projection, read through its strides): boxes of box_rows
// rows of one (head, batch).  A stride whose dimension is 1 is never
// stepped; it is replaced by 16 bytes' worth, which the driver takes.
template <typename T>
inline bool tensor_map_4d(CUtensorMap* map, const void* base, uint64_t batches, uint64_t heads,
                          uint64_t rows, uint64_t cols, uint64_t ld, uint64_t head_ld,
                          uint64_t batch_ld, uint32_t box_rows) {
  const uint64_t one = 16 / sizeof(T);
  const uint64_t dims[4] = {cols, rows, heads, batches};
  const uint64_t strides[3] = {rows > 1 ? ld : one, heads > 1 ? head_ld : one,
                               batches > 1 ? batch_ld : one};
  return tensor_map<T>(map, base, 4, dims, strides, box_rows);
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

// ... and of a 3-D map: (c0, c1, c2), the batch c2.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ... and of a 4-D map: (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A 1-D bulk copy: `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from device memory at src into shared memory
// at dst, counted on `bar`.  No tensor map: one thread moves a whole page.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads, a
// multiple of 32: sync waits for all of them, arrive counts this warp and
// goes on.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's generic shared-memory stores before later accesses
// of the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ void reg_fence(int32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

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

// The accumulator layout of every form below: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 + 8 h and columns 8 j + 2 (t % 4) +
// e of d (64 x N, fp32) in d[4 j + 2 h + e].
#define HC_D8(i)                                                                          \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]),   \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HC_D32(i) HC_D8(i), HC_D8((i) + 8), HC_D8((i) + 16), HC_D8((i) + 24)
#define HC_OUT128                                                                         \
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
      "%120, %121, %122, %123, %124, %125, %126, %127 "

// d += A (64 x 16, K-major, shared memory) . B (16 x 256, MN-major),
// asynchronously.
#define HC_WGMMA_N256(TYPES)                                                              \
  asm volatile(                                                                           \
      "{\n"                                                                               \
      ".reg .pred p;\n"                                                                   \
      "setp.ne.b32 p, %130, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPES " "                            \
      "{" HC_OUT128 "}, %128, %129, p, 1, 1, 0, 1;\n"                                     \
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

// d += A (64 x 16, registers: a[0..3] of each thread as an mma.sync
// m16n8k16 A fragment of its warp's 16 rows, two 16-bit values a register,
// the lower column in the low half) . B (16 x 256, MN-major),
// asynchronously.
#define HC_WGMMA_N256_RS(TYPES)                                                           \
  asm volatile(                                                                           \
      "{\n"                                                                               \
      ".reg .pred p;\n"                                                                   \
      "setp.ne.b32 p, %133, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPES " "                            \
      "{" HC_OUT128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"                    \
      "}\n"                                                                               \
      : HC_D32(0), HC_D32(32), HC_D32(64), HC_D32(96)                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    HC_WGMMA_N256_RS("f16.f16");
  else
    HC_WGMMA_N256_RS("bf16.bf16");
}

// d (64 x N) = (scale_d ? d : 0) + A (64 x 16, K-major) . B (16 x N,
// stored N rows of K: K-major, both transpose bits 0), asynchronously; N
// 32, 48 or 64.
#define HC_OUT16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HC_OUT24 HC_OUT16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define HC_OUT32 HC_OUT24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define HC_WGMMA_KK(N, OUTS, DA, DB, SC, TYPES, ...)                                      \
  asm volatile(                                                                           \
      "{\n"                                                                               \
      ".reg .pred p;\n"                                                                   \
      "setp.ne.b32 p, " SC ", 0;\n"                                                       \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TYPES " "                         \
      "{" OUTS "}, " DA ", " DB ", p, 1, 1, 0, 0;\n"                                      \
      "}\n"                                                                               \
      : __VA_ARGS__                                                                       \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T, int N>
__device__ __forceinline__ void wgmma_m64nNk16_kk(float (&d)[N / 2], uint64_t da, uint64_t db,
                                                  int scale_d) {
  static_assert(N == 32 || N == 48 || N == 64, "N 32, 48 or 64");
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (N == 32) {
    if constexpr (f16)
      HC_WGMMA_KK(32, HC_OUT16, "%16", "%17", "%18", "f16.f16", HC_D8(0), HC_D8(8));
    else
      HC_WGMMA_KK(32, HC_OUT16, "%16", "%17", "%18", "bf16.bf16", HC_D8(0), HC_D8(8));
  } else if constexpr (N == 48) {
    if constexpr (f16)
      HC_WGMMA_KK(48, HC_OUT24, "%24", "%25", "%26", "f16.f16", HC_D8(0), HC_D8(8), HC_D8(16));
    else
      HC_WGMMA_KK(48, HC_OUT24, "%24", "%25", "%26", "bf16.bf16", HC_D8(0), HC_D8(8),
                  HC_D8(16));
  } else {
    if constexpr (f16)
      HC_WGMMA_KK(64, HC_OUT32, "%32", "%33", "%34", "f16.f16", HC_D8(0), HC_D8(8), HC_D8(16),
                  HC_D8(24));
    else
      HC_WGMMA_KK(64, HC_OUT32, "%32", "%33", "%34", "bf16.bf16", HC_D8(0), HC_D8(8),
                  HC_D8(16), HC_D8(24));
  }
}

#define HC_RS_F8(TYPES) \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %9, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n8k16.f32." TYPES " " \
  "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n" \
  "}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_F16(TYPES) \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %13, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPES " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n" \
  "}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_F32(TYPES) \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %21, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPES " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n" \
  "}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_F64(TYPES) \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n" \
  "}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_F128(TYPES) \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPES " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n" \
  "}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_F256(TYPES) \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %133, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPES " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n" \
  "}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_S8() \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %9, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 " \
  "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n" \
  "}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_S16() \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %13, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 " \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n" \
  "}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_S32() \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %21, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n" \
  "}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_S64() \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n" \
  "}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_S128() \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n" \
  "}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define HC_RS_S256() \
  asm volatile("{\n" ".reg .pred p;\n" "setp.ne.b32 p, %133, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p;\n" \
  "}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// d (64 x N, fp32) = (scale_d ? d : 0) + A (64 x 16, registers: mma.sync's
// m16n8k16 A fragment in each warp's 16 rows, as the m64n256k16 form above)
// . B (16 x N, stored N rows of K: K-major, transpose bit 0), asynchronously;
// N 8, 16, 32, 64, 128 or 256.
template <typename T, int N>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "N a power of two from 8 to 256");
  if constexpr (N == 8) {
    if constexpr (f16) HC_RS_F8("f16.f16"); else HC_RS_F8("bf16.bf16");
  } else if constexpr (N == 16) {
    if constexpr (f16) HC_RS_F16("f16.f16"); else HC_RS_F16("bf16.bf16");
  } else if constexpr (N == 32) {
    if constexpr (f16) HC_RS_F32("f16.f16"); else HC_RS_F32("bf16.bf16");
  } else if constexpr (N == 64) {
    if constexpr (f16) HC_RS_F64("f16.f16"); else HC_RS_F64("bf16.bf16");
  } else if constexpr (N == 128) {
    if constexpr (f16) HC_RS_F128("f16.f16"); else HC_RS_F128("bf16.bf16");
  } else {
    if constexpr (f16) HC_RS_F256("f16.f16"); else HC_RS_F256("bf16.bf16");
  }
}

// d (64 x N, s32) = (scale_d ? d : 0) + A (64 x 32 s8, registers: mma.sync's
// m16n8k32 s8 A fragment in each warp's 16 rows: lane (g, t) holds rows g
// (a[0], a[2]) and g + 8 (a[1], a[3]) at k 4t..4t+3 (a[0], a[1]) and
// 4t+16..4t+19 (a[2], a[3]), the lowest k in the lowest byte) . B (32 x N s8,
// K-major), asynchronously, exactly; N as above.  The accumulator layout is
// the fp32 forms'.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk32_s8_rs(int32_t (&d)[N / 2], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "N a power of two from 8 to 256");
  if constexpr (N == 8) HC_RS_S8();
  else if constexpr (N == 16) HC_RS_S16();
  else if constexpr (N == 32) HC_RS_S32();
  else if constexpr (N == 64) HC_RS_S64();
  else if constexpr (N == 128) HC_RS_S128();
  else HC_RS_S256();
}

#undef HC_RS_F8
#undef HC_RS_F16
#undef HC_RS_F32
#undef HC_RS_F64
#undef HC_RS_F128
#undef HC_RS_F256
#undef HC_RS_S8
#undef HC_RS_S16
#undef HC_RS_S32
#undef HC_RS_S64
#undef HC_RS_S128
#undef HC_RS_S256
#undef HC_WGMMA_KK
#undef HC_OUT32
#undef HC_OUT24
#undef HC_OUT16
#undef HC_WGMMA_N256_RS
#undef HC_WGMMA_N256
#undef HC_OUT128
#undef HC_D32
#undef HC_D8

}  // namespace hc
