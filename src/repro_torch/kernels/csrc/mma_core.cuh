// Shared device functions of the kernel library's GEMMs (matmul.cu,
// dequant_matmul.cu): asynchronous copies into shared memory, ldmatrix,
// the warp-level tensor-core product mma.sync m16n8k16 (bf16 or fp16 in,
// fp32 accumulation) over shared-memory tiles, the masked epilogue, and the
// CUDA-core GEMM that takes every shape and type the tensor-core path does
// not.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..);
//   B (16 x 8, "col"): b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//   C (16 x 8, fp32): c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1).
// ldmatrix.x4 hands lane l the address of row l % 8 of 8x8 matrix l / 8;
// matrix i lands in register i.  A tile row-major [m][k] gives A directly; a
// B tile stored [n][k] (k contiguous) gives B directly, one stored [k][n]
// (n contiguous) through ldmatrix.trans.

#pragma once

#include <type_traits>

#include "attention_core.cuh"  // the element conversions, ac::to_float / from_float

namespace gc {

using ac::from_float;
using ac::to_float;

// Two neighbouring outputs in one aligned store.
__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* dst, float x, float y) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy BYTES (4, 8 or 16) from global to shared memory asynchronously; when
// `pred` is false nothing is read and the bytes are zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool pred) {
  const int n = pred ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(smem)),
                 "l"(gmem), "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b, one m16n8k16 product with fp32 accumulation.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This block's output tile (bm, bn) in a grid of ceil(M / BM) x ceil(N /
// BN) tiles launched as one dimension: consecutive blocks run down a group
// of GROUP_M tile rows before the next tile column, so the blocks in flight
// together read a few A and B panels (the reference's T.use_swizzle).
constexpr int GROUP_M = 16;
__device__ __forceinline__ void grouped_tile(int M, int N, int BM, int BN, int& bm, int& bn) {
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int pid = blockIdx.x, per_group = GROUP_M * tiles_n;
  const int first = (pid / per_group) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  bm = first + (pid % per_group) % rows;
  bn = (pid % per_group) / rows;
}

// One warp's share of a block tile: MT x NT m16n8 accumulators at rows
// [wm0, wm0 + 16 MT) and columns [wn0, wn0 + 8 NT) of the block tile.
template <int MT, int NT>
struct WarpAcc {
  float c[MT][NT][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[i][j][q] = 0.f;
  }

  // acc += As[wm0.., 0..BK) . B[0..BK, wn0..): As row-major with row stride
  // `as` elements; B stored [k][n] with row stride `bs` (B_KN) or [n][k]
  // with row stride `bs` (otherwise).
  template <typename T, int BK, bool B_KN>
  __device__ void mma_tile(const T* As, int as, const T* Bs, int bs, int wm0, int wn0) {
    static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], As + (wm0 + i * 16 + (lane & 15)) * as + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        if (B_KN)
          ldmatrix_x4_trans(b, Bs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * bs +
                                   wn0 + j * 8 + (lane >> 4) * 8);
        else
          ldmatrix_x4(b, Bs + (wn0 + j * 8 + (lane >> 4) * 8 + (lane & 7)) * bs + kk +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816<T>(c[i][j], a[i], b[0], b[1]);
          mma16816<T>(c[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // acc += As[wm0.., 0..kdim) . B[0..kdim, wn0..) with B stored [n][k]
  // (row stride bs): mma_tile's loop for a K extent known at run time
  // (a multiple of 16).
  template <typename T>
  __device__ void mma_span(const T* As, int as, const T* Bs, int bs, int wm0, int wn0,
                           int kdim) {
    static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
    const int lane = threadIdx.x & 31;
    for (int kk = 0; kk < kdim; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], As + (wm0 + i * 16 + (lane & 15)) * as + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, Bs + (wn0 + j * 8 + (lane >> 4) * 8 + (lane & 7)) * bs + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816<T>(c[i][j], a[i], b[0], b[1]);
          mma16816<T>(c[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // Multiply this thread's rows by a factor each: rows g and g + 8 of
  // m-tile i take f[i][0] and f[i][1].
  __device__ void scale_rows(const float (&f)[MT][2]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        c[i][j][0] *= f[i][0];
        c[i][j][1] *= f[i][0];
        c[i][j][2] *= f[i][1];
        c[i][j][3] *= f[i][1];
      }
  }

  // Round each sum once to TO and store it at C[m][n] (row stride ldc)
  // for m < M, n < N; (m0, n0) is the warp tile's corner in C.
  template <typename TO>
  __device__ void store(TO* __restrict__ C, long ldc, int M, int N, int m0, int n0) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bool pairs = (ldc & 1) == 0;  // two neighbours share an aligned store
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + i * 16 + g + h * 8, n = n0 + j * 8 + 2 * t;
          if (m >= M) continue;
          TO* dst = C + (long)m * ldc + n;
          const float x = c[i][j][2 * h], y = c[i][j][2 * h + 1];
          if (pairs && n + 1 < N) {
            store2(dst, x, y);
          } else {
            if (n < N) dst[0] = from_float<TO>(x);
            if (n + 1 < N) dst[1] = from_float<TO>(y);
          }
        }
  }
};

// ---- the CUDA-core GEMM ----------------------------------------------------
//
// C[M, N] = sum_k A[m, k] * b(k, n) in fp32 on CUDA cores (fp32 FMAs, no
// TF32): the route for fp32 operands, and for shapes or alignments the
// tensor-core kernels do not take.  A is row-major (M, K) of TA; `b` is a
// functor giving B's element (k, n) as float (a plain matrix, or a weight
// decoded from its packed bytes).  64 x 64 output tiles, K in steps of 16,
// 256 threads of 4 x 4 outputs each; every element is loaded with bounds
// checks, so any M, N, K works.
constexpr int SIMT_BM = 64, SIMT_BN = 64, SIMT_BK = 16, SIMT_THREADS = 256;

template <typename TA, typename TO, typename BFn>
__global__ void __launch_bounds__(SIMT_THREADS)
gemm_simt_kernel(const TA* __restrict__ A, BFn b, TO* __restrict__ C, int M, int N, int K) {
  __shared__ float As[SIMT_BK][SIMT_BM + 4];  // transposed: [k][m]
  __shared__ float Bs[SIMT_BK][SIMT_BN + 4];
  const int m0 = blockIdx.y * SIMT_BM, n0 = blockIdx.x * SIMT_BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SIMT_BK) {
    for (int i = threadIdx.x; i < SIMT_BM * SIMT_BK; i += SIMT_THREADS) {
      const int r = i / SIMT_BK, c = i % SIMT_BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_float(A[(long)m * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < SIMT_BK * SIMT_BN; i += SIMT_THREADS) {
      const int r = i / SIMT_BN, c = i % SIMT_BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? b(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SIMT_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) C[(long)m * N + n] = from_float<TO>(acc[i][j]);
    }
}

template <typename TA, typename TO, typename BFn>
int launch_simt(const void* a, BFn b, void* c, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + SIMT_BN - 1) / SIMT_BN, (M + SIMT_BM - 1) / SIMT_BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gemm_simt_kernel<TA, TO, BFn><<<grid, SIMT_THREADS, 0, stream>>>((const TA*)a, b, (TO*)c, M,
                                                                    N, K);
  return (int)cudaGetLastError();
}

}  // namespace gc
