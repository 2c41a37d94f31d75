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
// Three routes, chosen by the wrapper (matmul.py, route):
//   * wgmma, 16-bit A and B with M > 16 (the counterpart of
//     T.Pipelined(..., num_stages) + T.gemm on Hopper's full tensor-core
//     rate; mma.sync reached ~300 TFLOP/s, 2.7-2.8x torch.matmul, whatever
//     its tile shape).  A block computes a 128 x 256 tile of C with three
//     warpgroups: one producer warp keeps a ring of STAGES shared-memory
//     stages (A 128 x 64 and B 64 x 256, 48 KB) filled by TMA 2-D loads with
//     128-byte swizzle, each stage's full / empty mbarrier pair handing it
//     between producer and consumers, and gives its registers away
//     (setmaxnreg.dec); two consumer warpgroups (setmaxnreg.inc) each run
//     wgmma.mma_async m64n256k16 over the stage for 64 rows, fp32
//     accumulators in registers, and release a stage once the products
//     that read it are done (one wgmma group stays in flight).  The
//     epilogue rounds each sum once and stores it from registers, the M and
//     N edges masked; TMA's zero fill masks the loads at the M, N and K
//     edges.  Blocks walk C in gc::grouped_tile order.
//   * mma.sync m16n8k16, 16-bit with M <= 16 (the GEMVs, near their bytes
//     bound): 16 x 64 x 128 tiles over 4 warps, A and B through 4 cp.async
//     stages, A by ldmatrix, B (row-major K x N) by ldmatrix.trans; rows
//     padded by 8 elements so that an ldmatrix's eight rows fall in
//     distinct banks; a 16-byte chunk past M, N or K is zero-filled.
//   * CUDA cores, for fp32 operands, K or N not a multiple of 8, or
//     unaligned pointers: the CUDA-core GEMM of mma_core.cuh (fp32 FMAs, no
//     TF32).
//
// Traps of the wgmma path (hopper_core.cuh has the details):
//   * B is row-major (K, N), an MN-major operand for wgmma: the descriptor
//     takes the transpose-B bit, LBO = 8 KB (one 64-column TMA box to the
//     next) and SBO = 1 KB (8 K rows), where a K-major operand (A) has SBO
//     = 1 KB and no LBO;
//   * the TMA descriptors come from the driver's cuTensorMapEncodeTiled,
//     fetched at run time through the runtime (no -lcuda), and travel as
//     __grid_constant__ parameters; they need 16-byte strides and bases
//     (K % 8 == 0, N % 8 == 0, the wrapper's rule);
//   * shared stages start on 1024-byte boundaries, as 128-byte swizzle
//     wants;
//   * a wrong mbarrier parity hangs the launch rather than failing it.
//
// What still holds it back: no persistent grid, so a block's epilogue does
// not overlap the next tile's loads; one block an SM (197 KB of stages).

#include "hopper_core.cuh"
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

// ---- the wgmma path ---------------------------------------------------------

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;   // the producer's warpgroup first
constexpr int A_BYTES = BM * BK * 2;             // 16 KB: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;               // 8 KB: one 64-column box of B
constexpr int STAGE = A_BYTES + BN / 64 * B_BOX;  // 48 KB
constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;  // + room to align to 1 KB
}  // namespace wg

template <typename T, typename TO>
__global__ void __launch_bounds__(wg::THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    TO* __restrict__ C, int M, int N, int K) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hc::smem_addr(smem_raw) & 1023)) & 1023);
  int bm, bn;
  gc::grouped_tile(M, N, BM, BN, bm, bn);
  const int ktiles = (K + BK - 1) / BK;
  const int wgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hc::mbar_init(&full[s], 1);
      hc::mbar_init(&empty[s], CONSUMERS);
    }
    hc::fence_barrier_init();
  }
  __syncthreads();

  if (wgroup == 0) {  // the producer: one thread issues every load
    hc::regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES, r = kt / STAGES;
        if (r > 0) hc::mbar_wait(&empty[s], (r - 1) & 1);  // its (r - 1)-th release
        uint8_t* a = smem + s * STAGE;
        uint8_t* b = a + A_BYTES;
        hc::mbar_expect_tx(&full[s], STAGE);
        hc::tma_load_2d(a, &ta, &full[s], kt * BK, bm * BM);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hc::tma_load_2d(b + j * B_BOX, &tb, &full[s], bn * BN + j * 64, kt * BK);
      }
    }
    return;
  }

  // a consumer: rows [64 c, 64 c + 64) of the block's tile
  hc::regs_inc<232>();
  const int c = wgroup - 1;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    hc::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + c * 64 * 128;
    const uint8_t* b = smem + s * STAGE + A_BYTES;
#pragma unroll
    for (int i = 0; i < 128; ++i) hc::reg_fence(acc[i]);
    hc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hc::wgmma_m64n256k16<T>(acc, hc::sw128_desc(a + kk * 32, 16, 1024),
                              hc::sw128_desc(b + kk * 16 * 128, B_BOX, 1024));
    hc::wgmma_commit();
    hc::wgmma_wait<1>();  // tile kt - 1's products are done: release its stage
#pragma unroll
    for (int i = 0; i < 128; ++i) hc::reg_fence(acc[i]);
    if (kt > 0 && threadIdx.x % 128 == 0) hc::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hc::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) hc::reg_fence(acc[i]);

  // the epilogue: acc[4 j + 2 h + e] is row m0 + 8 h, column n0 + 8 j + e
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int m0 = bm * BM + c * 64 + warp * 16 + (lane >> 2);
  const int n0 = bn * BN + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j;  // N is even on this path: n < N means n + 1 < N
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * h;
      if (m < M && n < N)
        gc::store2(C + (long)m * N + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <typename T, typename TO>
int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  using namespace wg;
  CUtensorMap ta, tb;
  if (!hc::tensor_map_2d<T>(&ta, a, M, K, K, BM) || !hc::tensor_map_2d<T>(&tb, b, K, N, N, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = matmul_wgmma_kernel<T, TO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, SMEM, stream>>>(ta, tb, (TO*)c, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
struct PlainB {  // B's element (k, n) of a row-major (K, N) matrix
  const T* b;
  int n;
  __device__ float operator()(int k, int j) const { return gc::to_float(b[(long)k * n + j]); }
};

template <typename T, typename TO>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int route,
           cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (route == 2) return launch_wgmma<T, TO>(a, b, c, M, N, K, stream);
    if (route == 1) return launch_tc<T, TO, 16, 64, 128, 1, 4, 4>(a, b, c, M, N, K, stream);
  }
  return gc::launch_simt<T, TO>(a, PlainB<T>{(const T*)b, N}, c, M, N, K, stream);
}

template <typename T>
int launch_out(int out_dtype, const void* a, const void* b, void* c, int M, int N, int K,
               int route, cudaStream_t stream) {
  if (out_dtype == 0) return launch<T, float>(a, b, c, M, N, K, route, stream);
  if (out_dtype == 1) return launch<T, __nv_bfloat16>(a, b, c, M, N, K, route, stream);
  if (out_dtype == 2) return launch<T, __half>(a, b, c, M, N, K, route, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype / out_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  route: 0 =
// the CUDA-core GEMM (any operands), 1 = mma.sync 16-row tiles, 2 = wgmma
// (routes 1 and 2 take 16-bit inputs only; the caller checks that K and N
// are multiples of 8 and A and B 16-byte aligned).  M, N, K >= 1.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int matmul_launch(int dtype, int out_dtype, const void* a, const void* b, void* c,
                             int M, int N, int K, int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1 || route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  if (route && (dtype == 0 || K % 8 != 0 || N % 8 != 0)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_out<float>(out_dtype, a, b, c, M, N, K, 0, s);
  if (dtype == 1) return launch_out<__nv_bfloat16>(out_dtype, a, b, c, M, N, K, route, s);
  if (dtype == 2) return launch_out<__half>(out_dtype, a, b, c, M, N, K, route, s);
  return (int)cudaErrorInvalidValue;
}
