// The dequantized GEMM's warp-specialised walk on Hopper (dequant_matmul.cu's
// tensor-core route): C^T tile = W tile . A tile^T, the paper's transposed
// form, with the weight decoded in registers as wgmma's A operand (Fig. 17's
// B_dequantize_local fed to T.gemm).
//
// A block owns ROWS = 64 weight rows (one warpgroup product's M) and BM
// activation rows (the product's N: M rounded up to a power of two from 8,
// at most 256, so at M <= 256 every weight tile is decoded once).  Its
// warps:
//   * a producer warpgroup: one thread keeps a ring of STAGES shared-memory
//     stages full by TMA, each stage the activation tile (BM rows x BK,
//     K-major, in 128-byte boxes with 128-byte swizzle) and the packed weight
//     tile (64 rows x WB = BK / pack bytes, WB <= 128, swizzled over its own
//     WB bytes: one TMA box), each stage's full / empty
//     mbarrier pair handing it over (matmul.cu's protocol; the producer waits
//     for the (r - 1)-th release of a stage before its r-th load, a consumer
//     for its r-th arrival);
//   * CONSUMERS warpgroups (4 at BM <= 64, where the decode is the work, 2
//     above) taking every CONSUMERS-th stage (a K split inside the block, so
//     that more warps decode; one block an SM; with two, the producer hands
//     them its registers, setmaxnreg 40 / 232).  Each lane reads its two
//     rows' packed bytes of a stage straight from shared memory in 16-byte
//     loads (8 rows of a warp then hit 8 distinct bank groups: the swizzle),
//     picks out with byte permutes the codes that mma.sync's A layout gives
//     it (lane (g, t): rows g and g + 8, k 2t, 2t+1, 2t+8, 2t+9 of a 16-wide
//     step; in s8, k 4t..4t+3 and 4t+16..4t+19 of a 32-wide step), decodes
//     them with magic-number arithmetic (fp16: one byte permute, one lop3
//     and one hfma2 a pair of integer codes, fp16_pair; bf16 and nf4:
//     decode_pairs), multiplies each by its own group's scale, and issues
//     wgmma.mma_async m64n{BM}k16 (or m64n{BM}k32.s8) with A from those
//     registers and B the activation tile by descriptor.  A stage is CHUNKS
//     groups of CHUNK products; the registers of the next group are decoded
//     while the last group runs (two register buffers; a group's registers
//     are written only before its first product is issued and after the
//     wait that retires the group that last read them), and a stage is
//     released once its last group is retired (at the first wait of the
//     consumer's next stage).  The ring holds a multiple of CONSUMERS
//     stages, 2 CONSUMERS at least, so that each stage serves one consumer.
// int8 activations with int8 / int4 / int2 codes run the s8 product with
// int32 accumulators: the codes are decoded to int8 (an int4 code to its
// byte's top nibble, 16 times its value; an int2 code to the top two bits,
// 64 times), the sum is exact and divided by that factor once.
// The epilogue adds the other consumers' sums to the first's through
// shared memory (fixed order: deterministic), rounds each sum once and
// stores C (M, N), masking the M and N edges; TMA's zero fill masks the
// loads (a zero weight byte decodes to a finite value that meets zero
// activations; scales past K or N are never read).
//
// The tile constants come from dequant_matmul.py as -D macros (build.Kernel
// defines): DQ_ACT_STAGE (activation bytes a stage at most), DQ_RING (the
// ring's bytes), DQ_MAX_STAGES, DQ_MIN_BM / DQ_MAX_BM (the BM ladder),
// DQ_CONSUMERS_SMALL / DQ_CONSUMERS_LARGE (at BM <= 64 and above).  DQ_ABLATE
// (tools/dequant_ablation.py only): 1 keeps the loads alone (each stage
// released where the walk releases it), 2 the decode alone (no loads: it
// reads a stale ring), 3 the products alone (no loads, no decode).

#pragma once

#include "hopper_core.cuh"
#include "mma_core.cuh"

#if !defined(DQ_ACT_STAGE) || !defined(DQ_RING) || !defined(DQ_MAX_STAGES) || \
    !defined(DQ_MIN_BM) || !defined(DQ_MAX_BM) || !defined(DQ_CONSUMERS_SMALL) ||   \
    !defined(DQ_CONSUMERS_LARGE)
#error "the walk's tile constants come from dequant_matmul.py (build.Kernel defines)"
#endif
#ifndef DQ_ABLATE
#define DQ_ABLATE 0
#endif

namespace dq {

enum Fmt { INT8 = 0, INT4 = 1, INT2 = 2, NF4 = 3 };

template <int FMT>
__host__ __device__ constexpr int pack_of() {
  return FMT == INT8 ? 1 : FMT == INT2 ? 4 : 2;
}

// bitsandbytes' NF4 codebook (repro/kernels/ref.py:34)
__constant__ float kNf4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

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

// ---- the walk's plan -----------------------------------------------------------

constexpr int ROWS = 64;  // weight rows a block
constexpr int MAX_SMEM = 232448;
constexpr int LOADS_ONLY = 1, DECODE_ONLY = 2, WGMMA_ONLY = 3;  // DQ_ABLATE

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// A block's tiles for BM activation rows of ASZ bytes and PACK codes a
// weight byte (dequant_matmul.py's tile_plan states the same rule).
template <int BM, int ASZ, int PACK>
struct Plan {
  // consumer warpgroups, each taking every CONSUMERS-th stage: more at small
  // BM, where the decode is the work and one block an SM holds them all
  static constexpr int CONSUMERS = BM <= 64 ? DQ_CONSUMERS_SMALL : DQ_CONSUMERS_LARGE;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;  // the producer's warpgroup first
  // registers: ptxas budgets the block at 65536 / THREADS; with two
  // consumers the producer gives its share to them (setmaxnreg, matmul.cu's
  // 40 / 232), so that their 128 accumulators at BM 256 and two register
  // buffers keep every product in flight
  static constexpr bool SHIFT_REGS = CONSUMERS == 2;
  static constexpr int KSTEP = ASZ == 2 ? 16 : 32;  // k of one product
  static constexpr int KBOX = 128 / ASZ;            // k of one 128-byte activation box
  // k a stage: 128 weight bytes a row at most (a swizzle span: one TMA box),
  // DQ_ACT_STAGE activation bytes at most, one activation box at least
  static constexpr int BK =
      cmax(KBOX, cmin(128 * PACK, pow2_floor(DQ_ACT_STAGE / (BM * ASZ))));
  static constexpr int WB = BK / PACK;  // weight bytes a row a stage
  static constexpr int BOXES = BK / KBOX;
  static constexpr int ACT = BM * BK * ASZ;
  static constexpr int STAGE = ACT + ROWS * WB;
  // a multiple of CONSUMERS, so that a stage always serves the same consumer:
  // it then waits for the stage's rounds in order, and a parity wait never
  // meets a round two behind (another consumer's load of the stage still in
  // flight); 2 CONSUMERS at least, as a stage is released at its consumer's
  // next stage
  static constexpr int STAGES =
      cmax(2 * CONSUMERS, cmin(DQ_MAX_STAGES, DQ_RING / STAGE) / CONSUMERS * CONSUMERS);
  static constexpr int STEPS = BK / KSTEP;                    // products a stage
  static constexpr int CHUNK = STEPS >= 8 ? 4 : STEPS / 2;  // products a group
  static constexpr int CHUNKS = STEPS / CHUNK;                // groups a stage (even)
  static constexpr int CB = CHUNK * KSTEP / PACK;             // weight bytes of a row a group
  static constexpr int SMEM = STAGES * STAGE + 1024;          // + room to align to 1 KB
  static_assert(STAGE % 1024 == 0, "stages on 1 KB boundaries (128-byte swizzle)");
  static_assert(WB >= 16 && WB <= 128 && (WB & (WB - 1)) == 0, "a weight box row");
  static_assert(CHUNKS % 2 == 0 && CB % 8 == 0, "two register buffers a stage");
  static_assert((CONSUMERS - 1) * ROWS * BM * 4 <= STAGES * STAGE,
                "the epilogue's sums fit the ring");
  static_assert(SMEM + 2 * 8 * DQ_MAX_STAGES + 64 <= MAX_SMEM, "shared memory");
  static_assert(THREADS * 96 <= 65536, "96 registers a thread at least");
};

// The swizzle of a lane's rows (g and g + 8 of its warp's 16): the weight
// tile's row r holds its logical 16-byte chunk c at chunk c ^ swz(r), TMA's
// pattern over a WB-byte row (Swizzle<3|2|1, 4, 3>), the same for both rows.
template <int WB>
__device__ __forceinline__ int row_swizzle(int g) {
  return WB == 128 ? (g & 7) : WB == 64 ? ((g >> 1) & 3) : WB == 32 ? ((g >> 2) & 1) : 0;
}

// The byte offset of a row's logical 16-byte chunk from the row's start.
__device__ __forceinline__ int chunk_at(int chunk, int swz) { return (chunk ^ swz) << 4; }

__device__ __forceinline__ uint4 ld16(const uint8_t* row, int chunk, int swz) {
  return *reinterpret_cast<const uint4*>(row + chunk_at(chunk, swz));
}

// The bytes of (x, y) (0-3 x's, 4-7 y's) that `sel` names, a nibble each.
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t sel) {
  return __byte_perm(x, y, sel);
}

// fp16 pair from two BITS-bit fields, the low one at bit 0 and the high one
// at bit 16 + S: one lop3 flips each field's sign bit, masks the fields and
// ORs 1024.0 around them (fields below 2^10, so MAGIC + f is exact), and one
// hfma2 takes 1024 + f_lo and 1024 + 2^S f_hi to the signed codes (f ^
// 2^(BITS-1)) - 2^(BITS-1): exact, as every step is a small integer.
template <int BITS, int S>
__device__ __forceinline__ uint32_t fp16_pair(uint32_t y) {
  constexpr uint32_t FIELD = (1u << BITS) - 1, HALF = 1u << (BITS - 1);
  constexpr uint32_t MASK = FIELD | (FIELD << (16 + S));
  constexpr uint32_t OUT = (HALF | (HALF << (16 + S))) | (0x64006400u & ~MASK);
  uint32_t u;  // MASK's bits: y ^ OUT; the others: OUT
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(u) : "r"(y), "n"(MASK), "n"(OUT));
  const __half2 r =
      __hfma2(Pair<__half>::of(u), __floats2half2_rn(1.f, 1.f / (1 << S)),
              __floats2half2_rn(-(1024.f + HALF), -(1024.f / (1 << S) + HALF)));
  return bits_of(r);
}

// One row's A registers of one group in CT (16-bit products, k16): for step
// j, a[j][h] its k 2t, 2t+1 and a[j][2 + h] its k 2t+8, 2t+9 (h = 0 for row
// g, 1 for row g + 8).  `row` is the row's start in the stage, `byte0` the
// group's first byte in it.
template <int FMT, typename CT, int CHUNK, int WB>
__device__ __forceinline__ void decode_row16(const uint8_t* row, int byte0, int swz, int t,
                                             const CT* cb, uint32_t (&a)[CHUNK][4], int h) {
  constexpr bool F16 = std::is_same<CT, __half>::value;
  if constexpr (F16 && FMT == INT8) {  // bytes 2t, 2t+1 of each half to bits 0 and 16
    const uint32_t sel = (2 * t) | ((2 * t + 1) << 8);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const uint4 v = ld16(row, (byte0 >> 4) + j, swz);
      a[j][h] = fp16_pair<8, 0>(prmt(v.x, v.y, sel));
      a[j][2 + h] = fp16_pair<8, 0>(prmt(v.z, v.w, sel));
    }
  } else if constexpr (F16 && FMT == INT4) {  // byte t of each word to bytes 0 and 2
    const uint32_t sel = t | ((t + 4) << 4) | (t << 8) | ((t + 4) << 12);
#pragma unroll
    for (int j = 0; j < CHUNK; j += 2) {
      const uint4 v = ld16(row, (byte0 >> 4) + j / 2, swz);
      const uint32_t p0 = prmt(v.x, v.y, sel), p1 = prmt(v.z, v.w, sel);  // [B0 B1 B0 B1]
      a[j][h] = fp16_pair<4, 4>(p0);
      a[j][2 + h] = fp16_pair<4, 4>(p0 >> 8);
      a[j + 1][h] = fp16_pair<4, 4>(p1);
      a[j + 1][2 + h] = fp16_pair<4, 4>(p1 >> 8);
    }
  } else if constexpr (F16 && FMT == INT2) {  // nibbles t and t + 4 to bytes 0 and 2
    uint32_t w[CHUNK];
    if constexpr (CHUNK == 4) {
      const uint4 v = ld16(row, byte0 >> 4, swz);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(
          row + chunk_at(byte0 >> 4, swz) + (byte0 & 15));
      w[0] = v.x, w[1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const uint32_t x = w[j] >> (4 * t);
      a[j][h] = fp16_pair<2, 2>(prmt(x, 0u, 0x4040u));
      a[j][2 + h] = fp16_pair<2, 2>(prmt(x, 0u, 0x4242u));
    }
  } else if constexpr (FMT == INT8) {  // 16 bytes a step: bytes 2t, 2t+1 of each half
    const uint32_t sel = (2 * t) | ((2 * t + 1) << 4);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const uint4 v = ld16(row, (byte0 >> 4) + j, swz);
      const uint32_t g4 = prmt(prmt(v.x, v.y, sel), prmt(v.z, v.w, sel), 0x5410);
      uint32_t out[2];
      decode_pairs<INT8, CT>(g4, cb, out);
      a[j][h] = out[0];
      a[j][2 + h] = out[1];
    }
  } else if constexpr (FMT == INT4 || FMT == NF4) {  // 8 bytes a step: byte t of each word
    const uint32_t sel = t | ((t + 4) << 4);
#pragma unroll
    for (int j = 0; j < CHUNK; j += 2) {
      const uint4 v = ld16(row, (byte0 >> 4) + j / 2, swz);
      const uint32_t g4 = prmt(prmt(v.x, v.y, sel), prmt(v.z, v.w, sel), 0x5410);
      uint32_t out[4];
      decode_pairs<FMT, CT>(g4, cb, out);
      a[j][h] = out[0];
      a[j][2 + h] = out[1];
      a[j + 1][h] = out[2];
      a[j + 1][2 + h] = out[3];
    }
  } else {  // int2, 4 bytes a step: nibbles t (k 2t, 2t+1) and t + 4 (k 2t+8, 2t+9)
    uint32_t w[CHUNK];
    if constexpr (CHUNK == 4) {
      const uint4 v = ld16(row, byte0 >> 4, swz);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(
          row + chunk_at(byte0 >> 4, swz) + (byte0 & 15));
      w[0] = v.x, w[1] = v.y;
    }
    uint32_t nib = 0;  // step j's lo nibble at bits 4j, its hi nibble at 16 + 4j
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) nib |= ((w[j] >> (4 * t)) & 0x000F000Fu) << (4 * j);
    uint32_t out[8];
    decode_pairs<INT2, CT>(nib, cb, out);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      a[j][h] = out[j];
      a[j][2 + h] = out[4 + j];
    }
  }
}

// One row's s8 A registers of one group (k32): for step j, a[j][h] its k
// 4t..4t+3 and a[j][2 + h] its k 4t+16..4t+19, each code in a byte scaled
// by CODE_SCALE<FMT> (1, 16 or 64).
template <int FMT>
__host__ __device__ constexpr int code_shift() {
  return FMT == INT8 ? 0 : FMT == INT4 ? 4 : 6;
}

template <int FMT, int CHUNK, int WB>
__device__ __forceinline__ void decode_row8(const uint8_t* row, int byte0, int swz, int t,
                                            uint32_t (&a)[CHUNK][4], int h) {
  if constexpr (FMT == INT8) {  // 32 bytes a step: word t of each half
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int c = (byte0 >> 4) + 2 * j;
      a[j][h] = *reinterpret_cast<const uint32_t*>(row + chunk_at(c, swz) + 4 * t);
      a[j][2 + h] = *reinterpret_cast<const uint32_t*>(row + chunk_at(c + 1, swz) + 4 * t);
    }
  } else if constexpr (FMT == INT4) {  // 16 bytes a step: bytes 2t, 2t+1 of each half
    const uint32_t sel = (2 * t) | ((2 * t) << 4) | ((2 * t + 1) << 8) | ((2 * t + 1) << 12);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const uint4 v = ld16(row, (byte0 >> 4) + j, swz);
      const uint32_t lo = prmt(v.x, v.y, sel), hi = prmt(v.z, v.w, sel);  // [B0 B0 B1 B1]
      a[j][h] = ((lo << 4) & 0x00F000F0u) | (lo & 0xF000F000u);
      a[j][2 + h] = ((hi << 4) & 0x00F000F0u) | (hi & 0xF000F000u);
    }
  } else {  // int2, 8 bytes a step: byte t of each word, crumb i to byte i's top bits
    const uint32_t sel = t | 0x4440u;  // [byte t, 0, 0, 0]
#pragma unroll
    for (int j = 0; j < CHUNK; j += 2) {
      const uint4 v = ld16(row, (byte0 >> 4) + j / 2, swz);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t u = prmt(w[q], 0u, sel) * 4097u;  // B | B << 12
        a[j + q / 2][(q & 1) * 2 + h] = ((u << 6) | (u << 12)) & 0xC0C0C0C0u;
      }
    }
  }
}

// Each register of `a` (pairs of CT at k, k + 1 of row `srow`) times its
// elements' own group scales, in CT (the TPU kernel's rounding).
template <typename CT, int CHUNK>
__device__ __forceinline__ void scale_row(uint32_t (&a)[CHUNK][4], int h, const CT* srow,
                                          int k0, int t, int group, int groups) {
  using P = Pair<CT>;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + 16 * j + 2 * t + 8 * half;
      const CT s0 = srow[min(k / group, groups - 1)], s1 = srow[min((k + 1) / group, groups - 1)];
      uint32_t& r = a[j][2 * half + h];
      r = bits_of(__hmul2(P::of(r), P::pack(s0, s1)));
    }
  }
}

// ---- the kernel -----------------------------------------------------------------

// T: the activations (bf16 or fp16: the 16-bit product in T; int8: the s8
// product); FMT the weight format; BM the product's N.  scales (16-bit
// only): null, or (N, K / group) of T.  out_f32: C is float, else T (int8
// activations: always float).
template <typename T, int FMT, int BM>
__global__ void __launch_bounds__(Plan<BM, sizeof(T), pack_of<FMT>()>::THREADS, 1)
dequant_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                     const T* __restrict__ scales, void* __restrict__ C, int out_f32, int M, int N,
                     int K, int group) {
  constexpr bool S8 = sizeof(T) == 1;
  using P = Plan<BM, sizeof(T), pack_of<FMT>()>;
  constexpr int CONSUMERS = P::CONSUMERS;
  using Acc = typename std::conditional<S8, int32_t, float>::type;
  using CT = typename std::conditional<S8, __half, T>::type;  // the 16-bit decode's type
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[P::STAGES], empty[P::STAGES];
  __shared__ CT cb[16];  // the NF4 codebook, rounded to CT as the TPU kernel casts it
  uint8_t* smem = smem_raw + ((1024 - (hc::smem_addr(smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * ROWS, m0 = blockIdx.y * BM;
  const int ktiles = (K + P::BK - 1) / P::BK;
  const int wgroup = threadIdx.x / 128;
  if (threadIdx.x < 16) cb[threadIdx.x] = gc::from_float<CT>(kNf4[threadIdx.x]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      hc::mbar_init(&full[s], 1);
      hc::mbar_init(&empty[s], 1);
    }
    hc::fence_barrier_init();
  }
  __syncthreads();

  if (wgroup == 0) {  // the producer warpgroup: one thread issues every load
    if constexpr (P::SHIFT_REGS) hc::regs_dec<40>();
    if (DQ_ABLATE == DECODE_ONLY || DQ_ABLATE == WGMMA_ONLY) return;
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % P::STAGES, r = kt / P::STAGES;
        if (r > 0) hc::mbar_wait(&empty[s], (r - 1) & 1);  // its (r - 1)-th release
        uint8_t* st = smem + s * P::STAGE;
        hc::mbar_expect_tx(&full[s], P::STAGE);
#pragma unroll
        for (int b = 0; b < P::BOXES; ++b)
          hc::tma_load_2d(st + b * BM * 128, &ta, &full[s], kt * P::BK + b * P::KBOX, m0);
        hc::tma_load_2d(st + P::ACT, &tw, &full[s], kt * P::WB, n0);
      }
    }
    return;
  }

  // a consumer: stages kt = c, c + CONSUMERS, ...; its lane's rows 16 w + g, + 8
  if constexpr (P::SHIFT_REGS) hc::regs_inc<232>();
  const int c = wgroup - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int swz = row_swizzle<P::WB>(g);
  const int r0 = warp * 16 + g;
  const int groups = scales != nullptr ? K / group : 0;
  const T* srow0 = scales != nullptr ? scales + (long)min(n0 + r0, N - 1) * groups : nullptr;
  const T* srow1 = scales != nullptr ? scales + (long)min(n0 + r0 + 8, N - 1) * groups : nullptr;
  Acc acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  uint32_t fa[2][P::CHUNK][4];  // the two register buffers
  if constexpr (DQ_ABLATE == WGMMA_ONLY) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < P::CHUNK; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) fa[b][j][i] = 0x3C003C00u ^ (uint32_t)(lane + i);
  }
  uint32_t sink = 0;  // DECODE_ONLY: keeps the decode live
  int prev = -1;      // the stage of this consumer's last tile, released late
  for (int kt = c; kt < ktiles; kt += CONSUMERS) {
    const int s = kt % P::STAGES;
    if constexpr (DQ_ABLATE != DECODE_ONLY && DQ_ABLATE != WGMMA_ONLY)
      hc::mbar_wait(&full[s], (kt / P::STAGES) & 1);
    if constexpr (DQ_ABLATE == LOADS_ONLY) {  // released when the walk would release it
      hc::bar_sync(3 + c, 128);  // every thread of the consumer saw the stage land
      if (prev >= 0 && tid == 0) hc::mbar_arrive(&empty[prev]);
      prev = s;
      continue;
    }
    const uint8_t* at = smem + s * P::STAGE;
    const uint8_t* wt = at + P::ACT + r0 * P::WB;  // row g; row g + 8 is 8 WB further
#pragma unroll
    for (int ch = 0; ch < P::CHUNKS; ++ch) {
      uint32_t(&a)[P::CHUNK][4] = fa[ch & 1];
      if constexpr (DQ_ABLATE != WGMMA_ONLY) {
        const int byte0 = ch * P::CB;
        if constexpr (S8) {
          decode_row8<FMT, P::CHUNK, P::WB>(wt, byte0, swz, t, a, 0);
          decode_row8<FMT, P::CHUNK, P::WB>(wt + 8 * P::WB, byte0, swz, t, a, 1);
        } else {
          decode_row16<FMT, CT, P::CHUNK, P::WB>(wt, byte0, swz, t, cb, a, 0);
          decode_row16<FMT, CT, P::CHUNK, P::WB>(wt + 8 * P::WB, byte0, swz, t, cb, a, 1);
          if (scales != nullptr) {
            const int k0 = kt * P::BK + ch * P::CHUNK * P::KSTEP;
            scale_row<CT, P::CHUNK>(a, 0, srow0, k0, t, group, groups);
            scale_row<CT, P::CHUNK>(a, 1, srow1, k0, t, group, groups);
          }
        }
      }
      if constexpr (DQ_ABLATE == DECODE_ONLY) {
#pragma unroll
        for (int j = 0; j < P::CHUNK; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sink ^= a[j][i];
        continue;
      }
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) hc::reg_fence(acc[i]);
      hc::wgmma_fence();
#pragma unroll
      for (int j = 0; j < P::CHUNK; ++j) {
        const int q = ch * P::CHUNK + j;  // the product's step in the stage: 32 bytes of a box row
        const uint64_t db = hc::sw128_desc(at + (q / 4) * BM * 128 + (q % 4) * 32, 16, 1024);
        if constexpr (S8)
          hc::wgmma_m64nNk32_s8_rs<BM>(acc, a[j], db, 1);
        else
          hc::wgmma_m64nNk16_rs<T, BM>(acc, a[j], db, 1);
      }
      hc::wgmma_commit();
      hc::wgmma_wait<1>();  // the group before this one is retired
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) hc::reg_fence(acc[i]);
      if (ch == 0 && prev >= 0 && tid == 0) hc::mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  hc::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) hc::reg_fence(acc[i]);
  if constexpr (DQ_ABLATE == DECODE_ONLY) acc[0] += (Acc)(sink & 1);

  // the other consumers' sums onto the first's, in their order, through the
  // (idle) ring
  hc::bar_sync(1, CONSUMERS * 128);  // every product of every consumer is retired
  Acc* red = reinterpret_cast<Acc*>(smem);
  if (c > 0) {
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) red[((c - 1) * (BM / 2) + i) * 128 + tid] = acc[i];
  }
  hc::bar_sync(2, CONSUMERS * 128);
  if (c > 0) return;
#pragma unroll 1
  for (int o = 0; o < CONSUMERS - 1; ++o) {
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] += red[(o * (BM / 2) + i) * 128 + tid];
  }

  // acc[4 j + 2 h + e]: weight row n0 + r0 + 8 h, activation row m0 + 8 j + 2 t + e
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + r0 + 8 * h;
        if (m >= M || n >= N) continue;
        const Acc v = acc[4 * j + 2 * h + e];
        const long o = (long)m * N + n;
        if constexpr (S8) {
          static_cast<float*>(C)[o] = (float)(v >> code_shift<FMT>());
        } else if (out_f32) {
          static_cast<float*>(C)[o] = v;
        } else {
          static_cast<T*>(C)[o] = gc::from_float<T>(v);
        }
      }
    }
  }
}

// The smallest BM of the ladder (powers of two, DQ_MIN_BM to DQ_MAX_BM)
// that holds M rows, DQ_MAX_BM above it.
inline int block_rows(int M) {
  int bm = DQ_MIN_BM;
  while (bm < M && bm < DQ_MAX_BM) bm *= 2;
  return bm;
}

template <typename T, int FMT, int BM>
int launch_bm(const void* a, const void* b, const void* scales, void* c, int out_f32, int M,
              int N, int K, int group, cudaStream_t stream) {
  using P = Plan<BM, sizeof(T), pack_of<FMT>()>;
  CUtensorMap ta, tw;
  bool ok;
  if constexpr (sizeof(T) == 2)
    ok = hc::tensor_map_2d<T>(&ta, a, M, K, K, BM);
  else
    ok = hc::byte_map_2d(&ta, a, M, K, K, 128, BM);
  const int kb = K / pack_of<FMT>();
  ok = ok && hc::byte_map_2d(&tw, b, N, kb, kb, P::WB, ROWS);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = dequant_wgmma_kernel<T, FMT, BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + ROWS - 1) / ROWS, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(ta, tw, (const T*)scales, c, out_f32, M, N, K,
                                                group);
  return (int)cudaGetLastError();
}

template <typename T, int FMT>
int launch_fmt(const void* a, const void* b, const void* scales, void* c, int out_f32, int M,
               int N, int K, int group, cudaStream_t stream) {
  static_assert(DQ_MIN_BM == 8 && DQ_MAX_BM == 256, "the instantiated ladder");
  switch (block_rows(M)) {
    case 8: return launch_bm<T, FMT, 8>(a, b, scales, c, out_f32, M, N, K, group, stream);
    case 16: return launch_bm<T, FMT, 16>(a, b, scales, c, out_f32, M, N, K, group, stream);
    case 32: return launch_bm<T, FMT, 32>(a, b, scales, c, out_f32, M, N, K, group, stream);
    case 64: return launch_bm<T, FMT, 64>(a, b, scales, c, out_f32, M, N, K, group, stream);
    case 128: return launch_bm<T, FMT, 128>(a, b, scales, c, out_f32, M, N, K, group, stream);
    default: return launch_bm<T, FMT, 256>(a, b, scales, c, out_f32, M, N, K, group, stream);
  }
}

// The walk for activations T in format fmt (int8 activations: int8, int4 or
// int2 codes; the caller checks the rest).
template <typename T>
int launch(int fmt, const void* a, const void* b, const void* scales, void* c, int out_f32,
           int M, int N, int K, int group, cudaStream_t stream) {
  switch (fmt) {
    case INT8: return launch_fmt<T, INT8>(a, b, scales, c, out_f32, M, N, K, group, stream);
    case INT4: return launch_fmt<T, INT4>(a, b, scales, c, out_f32, M, N, K, group, stream);
    case INT2: return launch_fmt<T, INT2>(a, b, scales, c, out_f32, M, N, K, group, stream);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_fmt<T, NF4>(a, b, scales, c, out_f32, M, N, K, group, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dq
