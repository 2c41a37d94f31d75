// The kernel library's GEMM: C = A . B with fp32 accumulation.
//
// Replaces the TPU kernel repro/kernels/matmul.py:15 (matmul_program, the
// paper's Fig. 16): A (M, K) and B (K, N), both row-major, of fp32, bf16 or
// fp16; C (M, N) of fp32, bf16 or fp16, each element one fp32 sum rounded
// once.  Any M, N, K: the edges are masked.
//
// Bound on the H100: operations for the paper's training GEMMs (Table 2
// M0-M7: 0.07-3.9 ms at 989 TFLOP/s bf16), bytes for its decode GEMVs (V0-V7,
// M = 1: B is read once, 0.16-0.49 ms at 3.35 TB/s).
//
// Design (the counterpart of T.Pipelined(..., num_stages) + T.gemm):
//   * bf16 / fp16: tensor cores, mma.sync m16n8k16 with fp32 accumulation;
//     A and B tiles stream into shared memory through cp.async, STAGES deep,
//     so the loads of tile k + STAGES - 1 are in flight while tile k is
//     multiplied; A fragments by ldmatrix, B (row-major K x N) by
//     ldmatrix.trans; rows padded by 8 elements so that the eight 16-byte
//     rows an ldmatrix reads fall in distinct banks;
//   * two tile shapes: 128 x 128 x 64 over 8 warps (64 x 32 each, two
//     blocks an SM) for M > 16, and 16 x 64 x 128 over 4 warps for M <= 16
//     (the GEMVs), where 4 stages of a deep K tile keep enough of B in
//     flight to stream it (of the tile shapes tried on the card, 128 x 256,
//     256 x 128 and 4-warp 128 x 128 among them, none ran more than 4%
//     faster at M5 / M7);
//   * blocks walk the output in groups of GROUP_M tile rows (the
//     reference's T.use_swizzle), so the blocks resident together share A
//     and B panels in L2 instead of streaming all of B once per tile row;
//   * masked edges: a 16-byte chunk past M, N or K is zero-filled, not read
//     (K and N multiples of 8 keep every chunk wholly in or out);
//   * fp32 operands, or K or N not a multiple of 8 or unaligned pointers:
//     the CUDA-core GEMM of mma_core.cuh (fp32 FMAs, no TF32).
//
// Known first bottleneck: mma.sync reaches a fraction of Hopper's peak;
// wgmma fed by TMA (a warp-specialised producer, a ring of tiles) is the
// way to the card's full rate.

#include "mma_core.cuh"

namespace {

template <typename T, typename TO, int BM, int BN, int BK, int WM, int WN, int STAGES>
struct TcGemm {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int AS = BK + 8, BS = BN + 8;  // padded row strides
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr size_t SMEM = sizeof(T) * STAGES * ((size_t)BM * AS + (size_t)BK * BS);
};

template <typename T, typename TO, int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_tc_kernel(const T* __restrict__ A, const T* __restrict__ B, TO* __restrict__ C, int M,
                 int N, int K) {
  using G = TcGemm<T, TO, BM, BN, BK, WM, WN, STAGES>;
  extern __shared__ uint4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);
  T* Bs = As + STAGES * BM * G::AS;
  int bm, bn;
  gc::grouped_tile(M, N, BM, BN, bm, bn);
  const int m0 = bm * BM, n0 = bn * BN;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int ktiles = (K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    T* as = As + stage * BM * G::AS;
    T* bs = Bs + stage * BK * G::BS;
    for (int i = threadIdx.x; i < BM * (BK / 8); i += G::THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool p = m0 + r < M && k0 + c < K;
      gc::cp_async<16>(as + r * G::AS + c, p ? A + (long)(m0 + r) * K + k0 + c : A, p);
    }
    for (int i = threadIdx.x; i < BK * (BN / 8); i += G::THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool p = k0 + r < K && n0 + c < N;
      gc::cp_async<16>(bs + r * G::BS + c, p ? B + (long)(k0 + r) * N + n0 + c : B, p);
    }
  };

  gc::WarpAcc<G::MT, G::NT> acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    gc::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    gc::cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();                  // ... for every thread, and tile kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next);
    gc::cp_async_commit();
    const int st = kt % STAGES;
    acc.template mma_tile<T, BK, true>(As + st * BM * G::AS, G::AS, Bs + st * BK * G::BS, G::BS,
                                       wm0, wn0);
  }
  gc::cp_async_wait<0>();
  acc.store(C, N, M, N, m0 + wm0, n0 + wn0);
}

template <typename T, typename TO, int BM, int BN, int BK, int WM, int WN, int STAGES>
int launch_tc(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  using G = TcGemm<T, TO, BM, BN, BK, WM, WN, STAGES>;
  auto kernel = matmul_tc_kernel<T, TO, BM, BN, BK, WM, WN, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, G::THREADS, G::SMEM, stream>>>((const T*)a, (const T*)b, (TO*)c, M,
                                                            N, K);
  return (int)cudaGetLastError();
}

template <typename T>
struct PlainB {  // B's element (k, n) of a row-major (K, N) matrix
  const T* b;
  int n;
  __device__ float operator()(int k, int j) const { return gc::to_float(b[(long)k * n + j]); }
};

template <typename T, typename TO>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int tensor_cores,
           cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (tensor_cores) {
      if (M <= 16) return launch_tc<T, TO, 16, 64, 128, 1, 4, 4>(a, b, c, M, N, K, stream);
      return launch_tc<T, TO, 128, 128, 64, 2, 4, 3>(a, b, c, M, N, K, stream);
    }
  }
  return gc::launch_simt<T, TO>(a, PlainB<T>{(const T*)b, N}, c, M, N, K, stream);
}

template <typename T>
int launch_out(int out_dtype, const void* a, const void* b, void* c, int M, int N, int K,
               int tensor_cores, cudaStream_t stream) {
  if (out_dtype == 0) return launch<T, float>(a, b, c, M, N, K, tensor_cores, stream);
  if (out_dtype == 1) return launch<T, __nv_bfloat16>(a, b, c, M, N, K, tensor_cores, stream);
  if (out_dtype == 2) return launch<T, __half>(a, b, c, M, N, K, tensor_cores, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype / out_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  tensor_cores
// != 0 asks for the tensor-core kernel (16-bit inputs only; the caller
// checks that K and N are multiples of 8 and A and B 16-byte aligned);
// otherwise the CUDA-core GEMM runs.  M, N, K >= 1.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int matmul_launch(int dtype, int out_dtype, const void* a, const void* b, void* c,
                             int M, int N, int K, int tensor_cores, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (tensor_cores && (dtype == 0 || K % 8 != 0 || N % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_out<float>(out_dtype, a, b, c, M, N, K, 0, s);
  if (dtype == 1) return launch_out<__nv_bfloat16>(out_dtype, a, b, c, M, N, K, tensor_cores, s);
  if (dtype == 2) return launch_out<__half>(out_dtype, a, b, c, M, N, K, tensor_cores, s);
  return (int)cudaErrorInvalidValue;
}
