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
// no scales ride the fp16 tensor cores: every operand is an integer exact
// in fp16 and every product and partial sum an integer below 2^24, so the
// sum is exact, as an int32 accumulation would be.  Every other case
// (fp32 activations, nf4 or scales with int8 activations, shapes the
// tensor-core kernel does not take) runs the CUDA-core GEMM of mma_core.cuh
// on the weight decoded in fp32 (16-bit activations: rounded as above).
//
// Bound on the H100: bytes at the paper's decode shapes (M = 8: the packed
// weight, read once, is nearly all the traffic: 0.02-0.08 ms at 3.35 TB/s
// for 16384 x 16384), operations at M = 256.
//
// Design: tiles of A and of the packed B stream into shared memory through
// cp.async, STAGES deep (T.Pipelined); each K tile's packed bytes are
// unpacked by the whole block into a shared tile of the compute type
// (rows [n][k], padded for ldmatrix), and mma.sync m16n8k16 multiplies it
// (T.gemm with transpose_B).  Two tile shapes: 16 x 64 x 128 over 4 warps
// for M <= 16, 128 x 64 x 64 over 8 warps otherwise (of the shapes tried
// on the card at M 64-1024, the best at M 64 and 256; none came within 3x
// of cuBLAS's fp16 product on a weight dequantized beforehand).  The decode shapes
// (M <= 8, the paper's) take a third kernel that skips shared memory: the
// weight streams into registers and is decoded there into the tensor
// cores' fragments (dequant_gemv_kernel, below).  A scale group may be
// any divisor of K that the pack factor divides: the unpack reads each
// code's own group's scale, so groups need not match the K tile.

#include "mma_core.cuh"

namespace {

enum Fmt { INT8 = 0, INT4 = 1, INT2 = 2, NF4 = 3 };

template <int FMT>
__host__ __device__ constexpr int pack_of() {
  return FMT == INT8 ? 1 : FMT == INT2 ? 4 : 2;
}
inline int pack_of_fmt(int fmt) { return fmt == INT8 ? 1 : fmt == INT2 ? 4 : 2; }

// bitsandbytes' NF4 codebook (repro/kernels/ref.py:34)
__constant__ float kNf4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

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

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct Tiles {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int S = BK + 8;  // padded row stride of the compute tiles
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
};

// Packed pairs of the 16-bit compute type, and the fast conversion of
// small unsigned fields to them (the paper's fast dtype conversion, [15]):
// OR-ing a field f < 2^7 into the mantissa of MAGIC (1024.0 in each fp16
// half, 128.0 in each bf16 half) gives MAGIC + f exactly, and one packed
// subtraction of MAGIC + bias turns two fields into two signed codes.
template <typename CT>
struct Pair;
template <>
struct Pair<__half> {
  using T2 = __half2;
  static constexpr uint32_t MAGIC = 0x64006400u;
  static constexpr float BASE = 1024.f;
  __device__ static T2 of(uint32_t u) { return *reinterpret_cast<T2*>(&u); }
  __device__ static T2 sub(T2 a, float b) { return __hsub2(a, __float2half2_rn(b)); }
  __device__ static T2 lows(T2 a, T2 b) { return __lows2half2(a, b); }
  __device__ static T2 highs(T2 a, T2 b) { return __highs2half2(a, b); }
  __device__ static T2 pack(__half a, __half b) { return __halves2half2(a, b); }
};
template <>
struct Pair<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr uint32_t MAGIC = 0x43004300u;
  static constexpr float BASE = 128.f;
  __device__ static T2 of(uint32_t u) { return *reinterpret_cast<T2*>(&u); }
  __device__ static T2 sub(T2 a, float b) { return __hsub2(a, __float2bfloat162_rn(b)); }
  __device__ static T2 lows(T2 a, T2 b) { return __lows2bfloat162(a, b); }
  __device__ static T2 highs(T2 a, T2 b) { return __highs2bfloat162(a, b); }
  __device__ static T2 pack(__nv_bfloat16 a, __nv_bfloat16 b) { return __halves2bfloat162(a, b); }
};

template <typename T2>
__device__ __forceinline__ uint32_t bits_of(T2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 4 PACK codes of one packed 32-bit word in CT (16-bit), as 2 PACK
// packed pairs: out[j] holds codes 2j and 2j + 1.  Fields of BITS bits
// sit at bit BITS * j for code j; a field c maps to the signed code
// (c ^ 2^(BITS-1)) - 2^(BITS-1), which is the reference's "v >= 2^(BITS-1)
// -> v - 2^BITS", and shifting the word by BITS * s brings codes s and
// s + 16 / BITS to bits 0 and 16: a packed pair.  nf4 looks its codes up
// in the codebook `cb` (in CT, in shared memory); int8 codes in bf16 (8
// significant bits, too few for MAGIC + f < 2^8) convert through float.
template <int FMT, typename CT>
__device__ __forceinline__ void decode_pairs(uint32_t w4, const CT* cb,
                                             uint32_t (&out)[2 * pack_of<FMT>()]) {
  using P = Pair<CT>;
  using T2 = typename P::T2;
  constexpr int PACK = pack_of<FMT>(), NP = 2 * PACK;
  if constexpr (FMT == NF4) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
      out[j] = bits_of(P::pack(cb[(w4 >> (8 * j)) & 15], cb[(w4 >> (8 * j + 4)) & 15]));
  } else if constexpr (FMT == INT8 && std::is_same<CT, __nv_bfloat16>::value) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
      out[j] = bits_of(__floats2bfloat162_rn((float)(int8_t)(w4 >> (16 * j)),
                                             (float)(int8_t)(w4 >> (16 * j + 8))));
  } else {
    constexpr int BITS = 8 / PACK, HALF = 1 << (BITS - 1);
    constexpr uint32_t FIELD = (1u << BITS) - 1;
    constexpr uint32_t MASK = FIELD | (FIELD << 16);
    constexpr uint32_t FLIP = HALF == 128 ? 0x80808080u : HALF == 8 ? 0x88888888u : 0xAAAAAAAAu;
    constexpr int S = 16 / BITS;  // pairs (s, s + S) a shift gives
    const uint32_t x = w4 ^ FLIP;
    T2 p[S];
#pragma unroll
    for (int sh = 0; sh < S; ++sh)
      p[sh] = P::sub(P::of(((x >> (BITS * sh)) & MASK) | P::MAGIC), P::BASE + HALF);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int c = 2 * j;
      out[j] = bits_of(c < S ? P::lows(p[c], p[c + 1]) : P::highs(p[c - S], p[c - S + 1]));
    }
  }
}

// The same, stored at dst (8-byte aligned, 16-byte for PACK >= 2) with 8-
// or 16-byte stores.
template <int FMT, typename CT>
__device__ __forceinline__ void decode_word(uint32_t w4, CT* dst, const CT* cb) {
  constexpr int NP = 2 * pack_of<FMT>();
  uint32_t out[NP];
  decode_pairs<FMT, CT>(w4, cb, out);
  if constexpr (NP == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
  } else {
#pragma unroll
    for (int j = 0; j < NP; j += 4)
      *reinterpret_cast<uint4*>(dst + 2 * j) = make_uint4(out[j], out[j + 1], out[j + 2], out[j + 3]);
  }
}

// Unpack one K tile: the block's threads decode its packed rows (QB = BK /
// PACK bytes each, 4 bytes = 4 PACK codes at a time) into Bw [n][k] (row
// stride S) in CT.  Without scales, the bytes past K or N were zero-filled
// by the copy and decode to finite codes that meet zero activations or
// land in outputs never stored; with scales, each code takes its own
// group's scale, and codes past K or N are zeros (no scale is read there).
template <int FMT, typename CT, int BN, int BK, int S, int THREADS>
__device__ void unpack_tile(CT* __restrict__ Bw, const int8_t* __restrict__ bs,
                            const CT* __restrict__ scales, const CT* cb, int n0, int k0, int N,
                            int K, int group) {
  constexpr int PACK = pack_of<FMT>(), QB = BK / PACK;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bs);
  if (scales == nullptr) {
    for (int i = threadIdx.x; i < BN * (QB / 4); i += THREADS) {
      const int r = i / (QB / 4), c0 = (i % (QB / 4)) * 4 * PACK;
      decode_word<FMT, CT>(words[i], Bw + r * S + c0, cb);
    }
    return;
  }
  const long groups = K / group;
  for (int i = threadIdx.x; i < BN * (QB / 4); i += THREADS) {
    const int r = i / (QB / 4), c0 = (i % (QB / 4)) * 4 * PACK;
    const uint32_t w4 = words[i];
    CT* dst = Bw + r * S + c0;
    const CT* srow = scales + (long)(n0 + r) * groups;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t byte = (w4 >> (8 * b)) & 0xFF;
#pragma unroll
      for (int q = 0; q < PACK; ++q) {
        const int k = k0 + c0 + b * PACK + q;
        dst[b * PACK + q] = (k < K && n0 + r < N)
                                ? weight<CT>(decode<FMT>(byte, q, kNf4), srow + k / group)
                                : gc::from_float<CT>(0.f);
      }
    }
  }
}

// T: activations in device memory (bf16, fp16, or int8 converted to CT in
// shared memory); CT: the tensor cores' input type; the format `fmt` is a
// runtime switch of the unpack alone.
template <typename T, typename CT, typename TO, int BM, int BN, int BK, int WM, int WN,
          int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
dequant_tc_kernel(const T* __restrict__ A, const int8_t* __restrict__ Bq,
                  const CT* __restrict__ scales, TO* __restrict__ C, int M, int N, int K,
                  int fmt, int pack, int group) {
  using G = Tiles<BM, BN, BK, WM, WN, STAGES>;
  // a K tile's packed row (BK / pack bytes) must be whole 16-byte copies
  // for int2's four codes a byte
  static_assert(BK % 64 == 0, "BK / 4 must be a multiple of 16 bytes");
  constexpr bool A_RAW = sizeof(T) == 1;
  constexpr int AROW = A_RAW ? BK : G::S;  // A stage row stride (elements of T)
  extern __shared__ uint4 smem4[];
  T* Ast = reinterpret_cast<T*>(smem4);                               // STAGES x BM x AROW
  int8_t* Bst = reinterpret_cast<int8_t*>(Ast + STAGES * BM * AROW);  // STAGES x BN x BK bytes
  CT* Bw = reinterpret_cast<CT*>(Bst + STAGES * BN * BK);             // BN x S
  CT* Aw = Bw + BN * G::S;                                            // BM x S (A_RAW only)
  __shared__ CT cb[16];  // the NF4 codebook, rounded to CT as the TPU kernel casts it
  if (threadIdx.x < 16) cb[threadIdx.x] = gc::from_float<CT>(kNf4[threadIdx.x]);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int ktiles = (K + BK - 1) / BK;
  const int qb = BK / pack;  // packed bytes of a row in one K tile
  const long brow = K / pack;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    T* as = Ast + stage * BM * AROW;
    constexpr int AV = 16 / (int)sizeof(T);  // elements a 16-byte chunk
    for (int i = threadIdx.x; i < BM * (BK / AV); i += G::THREADS) {
      const int r = i / (BK / AV), c = (i % (BK / AV)) * AV;
      const bool p = m0 + r < M && k0 + c < K;
      gc::cp_async<16>(as + r * AROW + c, p ? A + (long)(m0 + r) * K + k0 + c : A, p);
    }
    int8_t* bs = Bst + stage * BN * BK;
    const int chunks = qb / 16;
    for (int i = threadIdx.x; i < BN * chunks; i += G::THREADS) {
      const int r = i / chunks, c = (i % chunks) * 16;
      const bool p = n0 + r < N && k0 / pack + c < brow;
      gc::cp_async<16>(bs + r * qb + c, p ? Bq + (n0 + r) * brow + k0 / pack + c : Bq, p);
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
    gc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for all; Bw / Aw of tile kt - 1 consumed
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next);
    gc::cp_async_commit();
    const int st = kt % STAGES, k0 = kt * BK;
    const int8_t* bs = Bst + st * BN * BK;
    switch (fmt) {  // uniform across the grid
      case INT8:
        unpack_tile<INT8, CT, BN, BK, G::S, G::THREADS>(Bw, bs, scales, cb, n0, k0, N, K, group);
        break;
      case INT4:
        unpack_tile<INT4, CT, BN, BK, G::S, G::THREADS>(Bw, bs, scales, cb, n0, k0, N, K, group);
        break;
      case INT2:
        unpack_tile<INT2, CT, BN, BK, G::S, G::THREADS>(Bw, bs, scales, cb, n0, k0, N, K, group);
        break;
      default:
        unpack_tile<NF4, CT, BN, BK, G::S, G::THREADS>(Bw, bs, scales, cb, n0, k0, N, K, group);
    }
    const CT* as;
    if constexpr (A_RAW) {  // int8 activations to fp16, exactly
      const uint32_t* aw = reinterpret_cast<const uint32_t*>(Ast + st * BM * AROW);
      for (int i = threadIdx.x; i < BM * (BK / 4); i += G::THREADS) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        decode_word<INT8, CT>(aw[i], Aw + r * G::S + c, cb);
      }
      as = Aw;
    } else {
      as = reinterpret_cast<const CT*>(Ast + st * BM * AROW);
    }
    __syncthreads();
    acc.template mma_tile<CT, BK, false>(as, G::S, Bw, G::S, wm0, wn0);
  }
  gc::cp_async_wait<0>();
  acc.store(C, N, M, N, m0 + wm0, n0 + wn0);
}

template <typename T, typename CT, typename TO, int BM, int BN, int BK, int WM, int WN,
          int STAGES>
int launch_tc(const void* a, const void* b, const void* scales, void* c, int M, int N, int K,
              int fmt, int pack, int group, cudaStream_t stream) {
  using G = Tiles<BM, BN, BK, WM, WN, STAGES>;
  constexpr bool A_RAW = sizeof(T) == 1;
  const size_t smem = sizeof(T) * STAGES * BM * (A_RAW ? BK : G::S) + (size_t)STAGES * BN * BK +
                      sizeof(CT) * G::S * (BN + (A_RAW ? BM : 0));
  auto kernel = dequant_tc_kernel<T, CT, TO, BM, BN, BK, WM, WN, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, G::THREADS, smem, stream>>>((const T*)a, (const int8_t*)b, (const CT*)scales,
                                             (TO*)c, M, N, K, fmt, pack, group);
  return (int)cudaGetLastError();
}

// ---- the decode-shape kernel, M <= 8 ----------------------------------------
//
// C^T[N, M] = W[N, K] . A[M, K]^T on mma.sync m16n8k16 with the weight as
// the A operand (16 weight rows a warp, rows g and g + 8 a lane) and the
// activations as B (the n8 tile's 8 columns are the M <= 8 activation rows,
// zero past M).  The weight streams from device memory straight into
// registers, 64 contiguous bytes of a row a step, 16 bytes a lane, and is
// decoded there into A fragments: no shared memory, no barrier.  Within a
// step the order of k is permuted: lane t feeds its own 16 PACK consecutive
// codes, four a product, to the mma's k slots of lane t, and reads the
// activations at the same k (a sum over k is the same in any order), so
// no shuffle is needed.  The block's 8 warps take the 16 rows' steps in
// turn and add their partial sums in shared memory in a fixed order.
constexpr int kGemvWarps = 8;

// The activations of lane t for one step: 16 PACK values of row m (zero
// past M) as pairs, in the order the weight codes are fed.
template <typename T, typename CT, int PACK>
__device__ __forceinline__ void gemv_acts(const T* __restrict__ A, long lda, int m, int M,
                                          long k0, uint32_t (&b)[8 * PACK]) {
  if (m >= M) {
#pragma unroll
    for (int i = 0; i < 8 * PACK; ++i) b[i] = 0u;
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(A + m * lda + k0);
  if constexpr (sizeof(T) == 1) {  // int8 activations, 16 a vector, to fp16 exactly
#pragma unroll
    for (int v = 0; v < PACK; ++v) {
      const uint4 x = __ldg(src + v);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t pr[2];
        decode_pairs<INT8, CT>(w[q], nullptr, pr);
        b[v * 8 + 2 * q] = pr[0];
        b[v * 8 + 2 * q + 1] = pr[1];
      }
    }
  } else {  // 16-bit activations, 8 a vector: already pairs
#pragma unroll
    for (int v = 0; v < 2 * PACK; ++v) {
      const uint4 x = __ldg(src + v);
      b[4 * v] = x.x;
      b[4 * v + 1] = x.y;
      b[4 * v + 2] = x.z;
      b[4 * v + 3] = x.w;
    }
  }
}

template <typename T, typename CT, typename TO, int FMT>
__global__ void __launch_bounds__(kGemvWarps * 32)
dequant_gemv_kernel(const T* __restrict__ A, const int8_t* __restrict__ Bq,
                    const CT* __restrict__ scales, TO* __restrict__ C, int M, int N, int K,
                    int group) {
  constexpr int PACK = pack_of<FMT>();
  constexpr int CODES = 16 * PACK;  // a lane's codes of a row a step
  __shared__ CT cb[16];
  __shared__ float red[kGemvWarps][32][4];
  if (FMT == NF4 && threadIdx.x < 16) cb[threadIdx.x] = gc::from_float<CT>(kNf4[threadIdx.x]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 16;
  const long brow = K / PACK;
  const int steps = (int)(brow / 64);
  const bool live0 = n0 + g < N, live1 = n0 + g + 8 < N;
  const uint4* w0 = reinterpret_cast<const uint4*>(Bq + (long)(n0 + g) * brow) + t;
  const uint4* w1 = reinterpret_cast<const uint4*>(Bq + (long)(n0 + g + 8) * brow) + t;
  const long groups = scales ? K / group : 0;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
  int st = warp;
  if (st < steps) {
    if (live0) x0 = __ldg(w0 + st * 4);
    if (live1) x1 = __ldg(w1 + st * 4);
  }
  for (; st < steps; st += kGemvWarps) {
    const uint4 cur0 = x0, cur1 = x1;
    const int nxt = st + kGemvWarps;  // the next step's weights in flight
    if (nxt < steps) {
      if (live0) x0 = __ldg(w0 + nxt * 4);
      if (live1) x1 = __ldg(w1 + nxt * 4);
    }
    const long k0 = (long)st * 64 * PACK + t * CODES;
    uint32_t b[8 * PACK];
    gemv_acts<T, CT, PACK>(A, K, g, M, k0, b);
    const uint32_t a0w[4] = {cur0.x, cur0.y, cur0.z, cur0.w};
    const uint32_t a1w[4] = {cur1.x, cur1.y, cur1.z, cur1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // a word: 4 PACK codes, PACK products
      uint32_t r0[2 * PACK], r1[2 * PACK];
      decode_pairs<FMT, CT>(a0w[q], cb, r0);
      decode_pairs<FMT, CT>(a1w[q], cb, r1);
      if (scales != nullptr) {  // one group a word (group % (4 PACK) == 0)
        const long kw = k0 + q * 4 * PACK;
        const CT s0 = live0 ? scales[(long)(n0 + g) * groups + kw / group] : gc::from_float<CT>(0.f);
        const CT s1 = live1 ? scales[(long)(n0 + g + 8) * groups + kw / group] : gc::from_float<CT>(0.f);
        const typename Pair<CT>::T2 s20 = Pair<CT>::pack(s0, s0), s21 = Pair<CT>::pack(s1, s1);
#pragma unroll
        for (int j = 0; j < 2 * PACK; ++j) {
          r0[j] = bits_of(__hmul2(Pair<CT>::of(r0[j]), s20));
          r1[j] = bits_of(__hmul2(Pair<CT>::of(r1[j]), s21));
        }
      }
#pragma unroll
      for (int j = 0; j < PACK; ++j) {
        const uint32_t a[4] = {r0[2 * j], r1[2 * j], r0[2 * j + 1], r1[2 * j + 1]};
        gc::mma16816<CT>(c, a, b[q * 2 * PACK + 2 * j], b[q * 2 * PACK + 2 * j + 1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][lane][i] = c[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) v += red[w][lane][i];
      const int n = n0 + g + (i >> 1) * 8, m = 2 * t + (i & 1);
      if (n < N && m < M) C[(long)m * N + n] = gc::from_float<TO>(v);
    }
  }
}

template <typename T, typename CT, typename TO>
int launch_gemv(int fmt, const void* a, const void* b, const void* scales, void* c, int M, int N,
                int K, int group, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + 15) / 16);
#define DQ_GEMV(F)                                                                          \
  dequant_gemv_kernel<T, CT, TO, F><<<blocks, kGemvWarps * 32, 0, stream>>>(                \
      (const T*)a, (const int8_t*)b, (const CT*)scales, (TO*)c, M, N, K, group)
  switch (fmt) {
    case INT8: DQ_GEMV(INT8); break;
    case INT4: DQ_GEMV(INT4); break;
    case INT2: DQ_GEMV(INT2); break;
    default: DQ_GEMV(NF4);
  }
#undef DQ_GEMV
  return (int)cudaGetLastError();
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
           int fmt, int pack, int group, int tensor_cores, cudaStream_t stream) {
  if constexpr (sizeof(T) <= 2) {
    using CT = typename std::conditional<sizeof(T) == 1, __half, T>::type;
    if (tensor_cores) {
      const int pack = pack_of_fmt(fmt);
      if (M <= 8 && (K / pack) % 64 == 0 && (scales == nullptr || group % (4 * pack) == 0))
        return launch_gemv<T, CT, TO>(fmt, a, b, scales, c, M, N, K, group, stream);
      if (M <= 16)
        return launch_tc<T, CT, TO, 16, 64, 128, 1, 4, 4>(a, b, scales, c, M, N, K, fmt, pack,
                                                          group, stream);
      return launch_tc<T, CT, TO, 128, 64, 64, 4, 2, 3>(a, b, scales, c, M, N, K, fmt, pack,
                                                        group, stream);
    }
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
// activations and of float32 otherwise.  tensor_cores != 0 asks for the
// tensor-core kernel, which needs 16-bit activations, or int8 ones with
// int8 / int4 / int2 codes and no scales, K a multiple of 16 and K / pack of
// 16, and 16-byte aligned A and B (the caller checks the alignment).  A group
// must divide K and be a multiple of the pack factor.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int dequant_matmul_launch(int dtype, int out_dtype, int fmt, const void* a,
                                     const void* b, const void* scales, void* c, int M, int N,
                                     int K, int group, int tensor_cores, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int pack = fmt == INT8 ? 1 : fmt == INT2 ? 4 : 2;
  if (M < 1 || N < 1 || K < 1 || fmt < 0 || fmt > 3 || K % pack != 0)
    return (int)cudaErrorInvalidValue;
  if (scales != nullptr && (group < 1 || K % group != 0 || group % pack != 0))
    return (int)cudaErrorInvalidValue;
  if (tensor_cores &&
      (dtype == 0 || K % 16 != 0 || (K / pack) % 16 != 0 ||
       (dtype == 3 && (fmt == NF4 || scales != nullptr))))
    return (int)cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != dtype) return (int)cudaErrorInvalidValue;
  const int tc = tensor_cores;
#define DQ_LAUNCH(T, TO) \
  return launch<T, TO>(a, b, scales, c, M, N, K, fmt, pack, group, tc, s)
  if (dtype == 0) return launch<float, float>(a, b, scales, c, M, N, K, fmt, pack, group, 0, s);
  if (dtype == 1 && out_dtype == 0) DQ_LAUNCH(__nv_bfloat16, float);
  if (dtype == 1) DQ_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 2 && out_dtype == 0) DQ_LAUNCH(__half, float);
  if (dtype == 2) DQ_LAUNCH(__half, __half);
  if (dtype == 3) DQ_LAUNCH(int8_t, float);
#undef DQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}
