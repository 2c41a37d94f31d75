// The dequantization rule of the quantized KV tiles on the tensor-core
// paths, shared by the MLA chunked prefill (mla_prefill.cu), the MLA
// decode (mla_paged.cu) and the GQA chunked prefill (prefill_attention.cu):
// packed int8 / int4 bytes staged in shared memory become the bf16 tile the
// tensor cores read.
//
// Each value is rounded once to bf16 from code * scale in fp32, bit for bit
// the plain version's dequantize_rows(...).to(bfloat16) (ref.py): a code
// has at most 8 significant bits and a bf16 scale 8, so their fp32 product
// is exact and both round the same exact value once.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace kvq {

using bf16 = __nv_bfloat16;

// One 16-byte vector of codes (16 int8 or 32 int4, low nibble first)
// dequantized to bf16 at o (16-byte aligned).  A code becomes a float
// without the conversion unit: code + 128 (+ 8 for int4), an unsigned byte,
// goes into the low mantissa bits of 2^23, and a subtraction leaves the
// code exactly; one instruction rounds two values.
template <int PACK>
__device__ __forceinline__ void dequant(bf16* o, const uint4& x, float s) {
  constexpr uint32_t TWO23 = 0x4B000000u;  // 2^23 as a float's bits
  constexpr float BIAS = 8388608.f + (PACK == 1 ? 128.f : 8.f);
  auto code = [&](uint32_t u, int k) {  // byte k of u, biased, as code * s
    return (__uint_as_float(__byte_perm(u, TWO23, 0x7650 + k)) - BIAS) * s;
  };
  auto pair = [](float a, float b) {  // a at the lower address
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  };
  uint4* dst = reinterpret_cast<uint4*>(o);
  if constexpr (PACK == 1) {  // byte k of word i: value 4 i + k
    const uint32_t w[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u, x.z ^ 0x80808080u,
                           x.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      dst[i / 2] = make_uint4(pair(code(w[i], 0), code(w[i], 1)), pair(code(w[i], 2), code(w[i], 3)),
                              pair(code(w[i + 1], 0), code(w[i + 1], 1)),
                              pair(code(w[i + 1], 2), code(w[i + 1], 3)));
  } else {  // byte k of word i: values 2 (4 i + k) (low nibble) and the next
#pragma unroll 1  // 32 values a vector: unrolled, their temporaries would spill
    for (int i = 0; i < 4; ++i) {
      const uint32_t wi = i < 2 ? (i == 0 ? x.x : x.y) : (i == 2 ? x.z : x.w);
      const uint32_t lo = (wi & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi = ((wi >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      dst[i] = make_uint4(pair(code(lo, 0), code(hi, 0)), pair(code(lo, 1), code(hi, 1)),
                          pair(code(lo, 2), code(hi, 2)), pair(code(lo, 3), code(hi, 3)));
    }
  }
}

// A 16-bit load (a scale, held in a register until its tile is staged)
// issued where it stands (volatile: not sunk towards its use).
__device__ __forceinline__ uint32_t ldg_u16(const void* p) {
  uint32_t x;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=r"(x) : "l"(p));
  return x;
}

// The bf16 whose bits are the low half of u (a staged scale), as a float.
__device__ __forceinline__ float bf16_bits(uint32_t u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)u));
}

}  // namespace kvq
