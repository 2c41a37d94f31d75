// The kernel library's weight-only dequantized GEMM: C = A . dequant(B)^T.
//
// Replaces the TPU kernel repro/kernels/dequant_matmul.py:25
// (dequant_matmul_program, the paper's Fig. 15/17 W_INTx A_FP16 GEMM):
// A (M, K) activations of fp32, bf16, fp16 or int8; B (N, K / pack) int8
// bytes holding the weight's codes along K, low bits first (int8: one code
// a byte; int4 and nf4: two, the low nibble first; int2: four, the low
// crumb first), each field masked after the arithmetic shift and
// sign-mapped (int4 v >= 8 -> v - 16, int2 v >= 2 -> v - 4) or looked up in
// the NF4 codebook; optional scales (N, K / group); C (M, N) of fp32, bf16
// or fp16.  The reference's kernel writes C^T and its ops.dequant_matmul
// transposes it back; this one writes C.
//
// Numerics, as the TPU kernel's: with 16-bit activations each weight is
// cast to the activation type and multiplied by its group's scale in that
// type (dequant_matmul.py:75-104), then the tensor cores take it, with fp32
// accumulation.  Integer codes are exact in bf16 and fp16; NF4 values and
// scaled weights round there, where the plain version (ref.dequant_matmul)
// keeps them in fp32.  int8 activations with int8, int4 or int2 codes and
// no scales take the s8 tensor cores with int32 accumulation: the sum is
// exact.
//
// Bound on the H100: bytes at the paper's decode shapes (M = 8: the packed
// weight, read once, is nearly all the traffic: 0.02-0.08 ms at 3.35 TB/s
// for 16384 x 16384), operations at M = 256 (0.035 ms at 989 TFLOP/s in
// fp16, 0.017 ms at 1979 TOPS in int8, for 256 x 8192 x 8192).
//
// Two routes, chosen by the wrapper (dequant_matmul.py, route):
//   * wgmma (dequant_wgmma.cuh): 16-bit activations in every format, with or
//     without scales, and int8 activations with int8 / int4 / int2 codes and
//     no scales; K and K / pack multiples of 16, 16-byte aligned operands.
//     One warp-specialised kernel from M = 1 up: a TMA producer warpgroup
//     fills a ring with activation tiles and packed weight tiles; consumer
//     warpgroups (four at BM <= 64, two above), every fourth or second stage
//     each, decode their 64 weight rows' codes in registers straight into
//     wgmma's A operand and multiply the activation tile (B, by descriptor)
//     with wgmma.mma_async m64n{BM}k16
//     (m64n{BM}k32.s8 for int8 activations), BM the activation rows of a
//     block (M rounded up to a power of two, at most 256).  The format is a
//     template parameter of the walk, never a branch in its loop.
//   * CUDA cores, for fp32 activations, nf4 or scales with int8
//     activations, K or K / pack not a multiple of 16 or unaligned data: the
//     CUDA-core GEMM of mma_core.cuh on the weight decoded in fp32 (16-bit
//     activations: rounded as above).
// A scale group may be any divisor of K that the pack factor divides: each
// code takes its own group's scale.
//
// What still holds it back (PERF.md's row 14; tools/dequant_ablation.py):
// at M <= 8 the weight's stream itself (TMA boxes of 64 rows x 128 bytes:
// the loads alone take most of the kernel's time at int4) and, for int2 and
// nf4, the decode's arithmetic (a few instructions a code; nf4 two shared-
// memory lookups a pair); at N 8192 the grid's 128 blocks leave 4 of the 132
// SMs idle; at M 256 each consumer holds two stages of the ring (its current
// one and its last, released late), so six stages leave two for the loads
// ahead; the epilogue's scattered 2- and 4-byte stores; no persistent grid,
// so a block's epilogue does not overlap the next tile's loads.

#include "dequant_wgmma.cuh"

namespace {

using dq::INT2;
using dq::INT4;
using dq::INT8;
using dq::kNf4;
using dq::NF4;

inline int pack_of_fmt(int fmt) { return fmt == INT8 ? 1 : fmt == INT2 ? 4 : 2; }

// Code i (0 = the lowest bits) of a packed byte, as a float; nf4 reads the
// fp32 codebook `cb`.
template <int FMT>
__device__ __forceinline__ float decode(uint32_t byte, int i, const float* cb) {
  if (FMT == INT8) return (float)(int8_t)byte;
  if (FMT == INT2) {
    const int v = (byte >> (2 * i)) & 3;
    return (float)(v >= 2 ? v - 4 : v);
  }
  const int v = (byte >> (4 * i)) & 15;
  if (FMT == NF4) return cb[v];
  return (float)(v >= 8 ? v - 16 : v);
}

// The weight the kernel multiplies: the code in TW, times its scale in TW
// when there are scales (TW = float keeps the plain version's fp32).
template <typename TW>
__device__ __forceinline__ TW weight(float code, const TW* scale) {
  const TW w = gc::from_float<TW>(code);
  if (scale == nullptr) return w;
  return gc::from_float<TW>(gc::to_float(w) * gc::to_float(*scale));
}

// B's element (k, n) for the CUDA-core GEMM: code k of row n, in TW, scaled.
template <typename TW>
struct DequantB {
  const int8_t* b;
  const TW* scales;
  int K, group, fmt, pack;
  __device__ float operator()(int k, int n) const {
    const long brow = K / pack;
    const uint32_t byte = (uint8_t)b[n * brow + k / pack];
    const TW* sc = scales ? scales + (long)n * (K / group) + k / group : nullptr;
    const int q = k % pack;
    float code;
    switch (fmt) {
      case INT8: code = decode<INT8>(byte, q, kNf4); break;
      case INT4: code = decode<INT4>(byte, q, kNf4); break;
      case INT2: code = decode<INT2>(byte, q, kNf4); break;
      default: code = decode<NF4>(byte, q, kNf4);
    }
    return gc::to_float(weight<TW>(code, sc));
  }
};

// TO is float or the activations' own 16-bit type.
template <typename T, typename TO>
int launch(const void* a, const void* b, const void* scales, void* c, int M, int N, int K,
           int fmt, int pack, int group, int route, cudaStream_t stream) {
  if constexpr (sizeof(T) <= 2) {
    if (route == 1)
      return dq::launch<T>(fmt, a, b, scales, c, (int)std::is_same<TO, float>::value, M, N, K,
                           group, stream);
  }
  // the CUDA-core route: the weight in the activation's 16-bit type, else fp32
  using TW = typename std::conditional<sizeof(T) == 2, T, float>::type;
  return gc::launch_simt<T, TO>(
      a, DequantB<TW>{(const int8_t*)b, (const TW*)scales, K, group, fmt, pack}, c, M, N, K,
      stream);
}

}  // namespace

// dtype (activations): 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8;
// out_dtype: 0 = float32, or the activations' own type (1 = bfloat16, 2 =
// float16) for 16-bit ones; fmt: 0 = int8, 1 = int4, 2 = int2, 3 = nf4.
// scales: null, or (N, K / group) of the activation type for 16-bit
// activations and of float32 otherwise.  route: 0 = the CUDA-core GEMM (any
// operands), 1 = the wgmma walk, which needs 16-bit activations, or int8
// ones with int8 / int4 / int2 codes, no scales and K <= 2^17 (the int32
// sums of codes scaled up to 64 times), K a multiple of 16 and K / pack of
// 16, and 16-byte aligned A and B (the caller checks the alignment).  A
// group must divide K and be a multiple of the pack factor.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int dequant_matmul_launch(int dtype, int out_dtype, int fmt, const void* a,
                                     const void* b, const void* scales, void* c, int M, int N,
                                     int K, int group, int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1 || fmt < 0 || fmt > 3 || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  const int pack = pack_of_fmt(fmt);
  if (K % pack != 0) return (int)cudaErrorInvalidValue;
  if (scales != nullptr && (group < 1 || K % group != 0 || group % pack != 0))
    return (int)cudaErrorInvalidValue;
  if (route == 1 &&
      (dtype == 0 || K % 16 != 0 || (K / pack) % 16 != 0 ||
       (dtype == 3 && (fmt == NF4 || scales != nullptr || K > (1 << 17)))))
    return (int)cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != dtype) return (int)cudaErrorInvalidValue;
#define DQ_LAUNCH(T, TO) \
  return launch<T, TO>(a, b, scales, c, M, N, K, fmt, pack, group, route, s)
  if (dtype == 0) return launch<float, float>(a, b, scales, c, M, N, K, fmt, pack, group, 0, s);
  if (dtype == 1 && out_dtype == 0) DQ_LAUNCH(__nv_bfloat16, float);
  if (dtype == 1) DQ_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 2 && out_dtype == 0) DQ_LAUNCH(__half, float);
  if (dtype == 2) DQ_LAUNCH(__half, __half);
  if (dtype == 3) DQ_LAUNCH(int8_t, float);
#undef DQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}
