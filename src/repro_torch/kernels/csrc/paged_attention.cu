// Paged-attention decode: one query token per slot against a paged KV pool.
//
// Two entry points, one kernel body templated on the K/V page format
// (attention_core.cuh):
//   * paged_attention_launch replaces the TPU kernel
//     repro/kernels/paged_attention.py:32 (paged_attention_program):
//     q (B, Hq, D), k_pages / v_pages (Hkv, P, page_size, D), tables
//     (B, max_pages) int32, lens (B,) int32  ->  out (B, Hq, D);
//   * paged_attention_quant_launch replaces
//     repro/kernels/paged_attention.py:93 (paged_attention_quant_program):
//     the same over packed int8 / int4 pools (Hkv, P, page_size, D / pack)
//     plus scales (Hkv, P, page_size, 1) of q's dtype, each page
//     dequantized on its way into shared memory (QuantKV, the DequantStage).
//
// Bound on the H100: bytes.  A decode step reads every live K and V row of
// every slot once (2 * Hkv * sum(lens) * D * itemsize bytes; D / pack bytes
// plus one scale per row when quantized) and does only 4 * Hq * D FLOPs per
// KV row, far below the card's 295 FLOP/byte ridge.
//
// What the design does about it:
//   * one block per (kv_head, slot), as the TPU grid: the block keeps its
//     whole GQA group (Hq / Hkv query rows) resident and reads each K/V page
//     exactly once for all of them;
//   * it walks only the live pages [max(0, len - window) / ps, ceil(len / ps))
//     and reads each page id from the block table itself (no scalar
//     prefetch on this card).  The TPU kernel walked all max_pages and
//     masked, which relies on padding entries holding finite values; this
//     one never touches padding pages, so garbage there (even NaN) cannot
//     leak in as 0 * NaN;
//   * each page is read with 16-byte vector loads into registers one page
//     ahead of the compute, so its device-memory latency overlaps the
//     scoring of the page before (attention_core.cuh: attend_tiles);
//   * fp32 accumulation for bf16 inputs, online softmax from
//     attention_core.cuh (exp2, NEG_CLAMP, safe_div: len == 0 emits zeros).
//
// Known first bottleneck: the grid has only 2 * slots blocks for qwen2-1.5B
// (Hkv = 2), far fewer than the 132 SMs, so most of the card idles.  Split-KV
// (several blocks per slot over page ranges, merged by a second pass) is the
// first thing a later change should do here.  Tensor-core scoring (wgmma) and
// TMA page loads come after that.

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 128;

struct DecodeMask {
  int base, len, lo;
  __device__ bool operator()(int /*r*/, int j) const {
    const int pos = base + j;
    return pos < len && pos >= lo;
  }
};

// The slot's live pages, read through its block-table row.
template <typename F>
struct DecodeTiles {
  using KV = F;
  F head;          // the kv head's pool, at page 0
  const int* row;  // the slot's block-table row
  int p_lo, ps, num_pages, len, lo, d;

  __device__ bool tile(int t, F& kv) const {
    const int page = row[p_lo + t];
    // an out-of-range page id (the dispatch guard rules it out) contributes
    // nothing rather than reading outside the pool
    if (page < 0 || page >= num_pages) return false;
    kv = head.rows((long)page * ps, d);
    return true;
  }
  __device__ DecodeMask mask(int t) const { return {(p_lo + t) * ps, len, lo}; }
};

template <typename F>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const typename F::Elem* __restrict__ q, F pools,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       typename F::Elem* __restrict__ out, int heads,
                       int kv_heads, int d, int ps, int max_pages,
                       int num_pages, int window, float qscale) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int group = heads / kv_heads;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), group, ps, d);

  const int len = lens[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_lo = lo / ps;
  const int p_hi = min((len + ps - 1) / ps, max_pages);

  const long q_off = ((long)b * heads + (long)h * group) * d;
  ac::load_rows(sm.qs, sm.stride, q + q_off, d, group, d, qscale);
  ac::init_state(sm, group, d);

  DecodeTiles<F> src{pools.rows((long)h * num_pages * ps, d),
                     tables + (long)b * max_pages, p_lo, ps, num_pages, len,
                     lo, d};
  ac::attend_tiles(sm, group, ps, d, max(0, p_hi - p_lo), src);
  __syncthreads();
  ac::store_rows(out + q_off, d, sm, group, d);
}

template <typename F>
int launch(const void* q, F pools, const void* tables, const void* lens,
           void* out, int slots, int heads, int kv_heads, int d, int ps,
           int max_pages, int num_pages, int window, float sm_scale,
           cudaStream_t stream) {
  using T = typename F::Elem;
  if (!F::shapes_ok(ps, d, kThreads)) return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  const size_t smem = ac::Smem::bytes(group, ps, d);
  auto kernel = paged_attention_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, pools, (const int*)tables, (const int*)lens, (T*)out, heads,
      kv_heads, d, ps, max_pages, num_pages, window, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int PACK>
ac::QuantKV<T, PACK> quant_pools(void* k, void* v, void* ks, void* vs) {
  return {(int8_t*)k, (int8_t*)v, (T*)ks, (T*)vs};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// Needs page_size a power of two <= 32 and head_dim a multiple of 8, with
// 16-byte aligned pools.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int paged_attention_launch(int dtype, const void* q, void* k_pages,
                                      void* v_pages, const void* tables,
                                      const void* lens, void* out, int slots,
                                      int heads, int kv_heads, int d, int ps,
                                      int max_pages, int num_pages, int window,
                                      float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(q, ac::FpKV<float>{(float*)k_pages, (float*)v_pages}, tables,
                  lens, out, slots, heads, kv_heads, d, ps, max_pages,
                  num_pages, window, sm_scale, s);
  if (dtype == 1)
    return launch(q,
                  ac::FpKV<__nv_bfloat16>{(__nv_bfloat16*)k_pages,
                                          (__nv_bfloat16*)v_pages},
                  tables, lens, out, slots, heads, kv_heads, d, ps, max_pages,
                  num_pages, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// The quantized twin: pack 1 = int8, 2 = int4; the scale pools are of q's
// dtype.  Needs head_dim / pack a multiple of 16 bytes, with 16-byte
// aligned packed pools.
extern "C" int paged_attention_quant_launch(
    int dtype, int pack, const void* q, void* k_pages, void* v_pages,
    void* k_scales, void* v_scales, const void* tables, const void* lens,
    void* out, int slots, int heads, int kv_heads, int d, int ps,
    int max_pages, int num_pages, int window, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PA_QUANT(T, P)                                                       \
  return launch(q, quant_pools<T, P>(k_pages, v_pages, k_scales, v_scales), \
                tables, lens, out, slots, heads, kv_heads, d, ps, max_pages, \
                num_pages, window, sm_scale, s)
  if (dtype == 0 && pack == 1) PA_QUANT(float, 1);
  if (dtype == 0 && pack == 2) PA_QUANT(float, 2);
  if (dtype == 1 && pack == 1) PA_QUANT(__nv_bfloat16, 1);
  if (dtype == 1 && pack == 2) PA_QUANT(__nv_bfloat16, 2);
#undef PA_QUANT
  return (int)cudaErrorInvalidValue;
}
