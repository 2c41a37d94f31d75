// Paged multi-head latent attention (MLA) decode: one query token per slot,
// every head attending the slot's shared latent and rope pages.
//
// Two entry points, one kernel body templated on the latent page format
// (attention_core.cuh):
//   * mla_paged_launch replaces the TPU kernel repro/kernels/mla.py:110
//     (mla_paged_program): q_lat (B, H, R) absorbed latent queries, q_pe
//     (B, H, Dpe) rotary queries, ckv_pages (P, page_size, R) and kpe_pages
//     (P, page_size, Dpe) with no head axis, tables (B, max_pages) int32,
//     lens (B,) int32  ->  out (B, H, R), the latent output;
//   * mla_paged_quant_launch replaces repro/kernels/mla.py:301
//     (mla_paged_quant_program): the same over packed int8 / int4 pools
//     (P, page_size, R / pack) and (P, page_size, Dpe / pack) with a scale
//     pool (P, page_size, 1) of q's dtype each, the latent columns
//     dequantized with the latent scale and the rope columns with the rope
//     scale (QuantLatent).
//
// The score of head h against key j is q_lat[h].ckv[j] + q_pe[h].kpe[j]
// times the caller's sm_scale (the model passes 1 / sqrt(nope + rope), not
// 1 / sqrt(R + Dpe)), and V is the latent ckv[j] itself: the page lands once
// in shared memory as rows [ckv | kpe] of R + Dpe floats, scored over all of
// them and read again over the first R for P.V.
//
// Bound on the H100: bytes.  A decode step reads each live latent and rope
// row once for all H heads ((R + Dpe) * itemsize bytes a token, plus two
// scales when quantized) and does 2 * H * (2R + Dpe) FLOPs on it, about 30
// FLOPs a byte at full width in bf16, under the card's 295 FLOP/byte ridge.
//
// Design:
//   * one block per (head block, slot), as the TPU grid; at full width the
//     head block is all 16 heads, so each page is read exactly once;
//   * only the live pages [max(0, len - window) / ps, ceil(len / ps)) are
//     walked, each page id read from the block table by the block itself;
//   * pages are read with 16-byte vector loads into registers one page ahead
//     of the compute (attend_tiles), 256 threads holding the 1152 (bf16) or
//     2304 (fp32) vectors of a full-width page;
//   * the online softmax of attention_core.cuh (exp2 on log2e-prescaled
//     scores, NEG_CLAMP, safe_div: len 0 emits zeros), fp32 throughout.
//
// Known first bottleneck: the grid is H / 16 x slots blocks, 8 at the
// serving batch, on a card of 132 SMs.  Split-KV (several blocks per slot
// over page ranges, merged by a second pass) is the first thing to change.

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;

struct DecodeMask {
  int base, len, lo;
  __device__ bool operator()(int /*r*/, int j) const {
    const int pos = base + j;
    return pos < len && pos >= lo;
  }
};

// The slot's live pages, read through its block-table row.
template <typename F>
struct LatentPages {
  using KV = F;
  F pool;          // the pools, at page 0
  const int* row;  // the slot's block-table row
  int p_lo, ps, num_pages, len, lo;

  __device__ bool tile(int t, F& kv) const {
    const int page = row[p_lo + t];
    // an out-of-range page id (the dispatch guard rules it out) contributes
    // nothing rather than reading outside the pool
    if (page < 0 || page >= num_pages) return false;
    kv = pool.rows((long)page * ps);
    return true;
  }
  __device__ DecodeMask mask(int t) const { return {(p_lo + t) * ps, len, lo}; }
};

struct HeadRows {  // block row r is head h0 + r of the slot: row g0 + r
  long g0;
  __device__ long operator()(int r) const { return g0 + r; }
};

template <typename F>
__global__ void __launch_bounds__(kThreads)
mla_paged_kernel(const typename F::Elem* __restrict__ q,
                 const typename F::Elem* __restrict__ q_pe, F pools,
                 const int* __restrict__ tables, const int* __restrict__ lens,
                 typename F::Elem* __restrict__ out, int heads, int bh, int ps,
                 int max_pages, int num_pages, int window, float qscale) {
  const int hb = blockIdx.x;  // head block
  const int b = blockIdx.y;   // slot
  const int r = pools.r, dk = pools.r + pools.pe;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), bh, ps, dk, r);

  const int len = lens[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_lo = lo / ps;
  const int p_hi = min((len + ps - 1) / ps, max_pages);

  const HeadRows rows{(long)b * heads + (long)hb * bh};
  ac::load_latent_rows(sm, q, q_pe, bh, r, pools.pe, qscale, rows);
  ac::init_state(sm, bh, r);

  LatentPages<F> src{pools, tables + (long)b * max_pages, p_lo, ps, num_pages,
                     len, lo};
  ac::attend_tiles(sm, bh, ps, dk, r, max(0, p_hi - p_lo), src);
  __syncthreads();
  ac::store_rows(out + rows.g0 * r, r, sm, bh, r);
}

template <typename F>
int launch(const void* q, const void* q_pe, F pools, const void* tables,
           const void* lens, void* out, int slots, int heads, int bh, int ps,
           int max_pages, int num_pages, int window, float sm_scale,
           cudaStream_t stream) {
  using T = typename F::Elem;
  if (bh < 1 || heads % bh != 0 || !F::shapes_ok(ps, pools.r, pools.pe, kThreads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ac::Smem::latent_bytes(bh, ps, pools.r + pools.pe, pools.r);
  auto kernel = mla_paged_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads / bh, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)q_pe, pools, (const int*)tables, (const int*)lens,
      (T*)out, heads, bh, ps, max_pages, num_pages, window,
      sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int PACK>
ac::QuantLatent<T, PACK> quant_pools(void* ckv, void* kpe, void* cs, void* rs,
                                     int r, int pe) {
  return {(int8_t*)ckv, (int8_t*)kpe, (T*)cs, (T*)rs, r, pe};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// bh query heads share a block (it must divide heads).  Needs page_size a
// power of two <= 32, R and Dpe multiples of 16 bytes' worth of elements,
// and 16-byte aligned pools.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int mla_paged_launch(int dtype, const void* q, const void* q_pe,
                                void* ckv_pages, void* kpe_pages,
                                const void* tables, const void* lens, void* out,
                                int slots, int heads, int bh, int r, int pe,
                                int ps, int max_pages, int num_pages,
                                int window, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(q, q_pe, ac::FpLatent<float>{(float*)ckv_pages, (float*)kpe_pages, r, pe},
                  tables, lens, out, slots, heads, bh, ps, max_pages,
                  num_pages, window, sm_scale, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch(q, q_pe, ac::FpLatent<B>{(B*)ckv_pages, (B*)kpe_pages, r, pe},
                  tables, lens, out, slots, heads, bh, ps, max_pages,
                  num_pages, window, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The quantized twin: pack 1 = int8, 2 = int4; the scale pools are of q's
// dtype.  Needs R / pack and Dpe / pack multiples of 16 bytes.
extern "C" int mla_paged_quant_launch(
    int dtype, int pack, const void* q, const void* q_pe, void* ckv_pages,
    void* kpe_pages, void* ckv_scales, void* kpe_scales, const void* tables,
    const void* lens, void* out, int slots, int heads, int bh, int r, int pe,
    int ps, int max_pages, int num_pages, int window, float sm_scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MLA_QUANT(T, P)                                                        \
  return launch(q, q_pe,                                                       \
                quant_pools<T, P>(ckv_pages, kpe_pages, ckv_scales, kpe_scales, \
                                  r, pe),                                      \
                tables, lens, out, slots, heads, bh, ps, max_pages, num_pages, \
                window, sm_scale, s)
  if (dtype == 0 && pack == 1) MLA_QUANT(float, 1);
  if (dtype == 0 && pack == 2) MLA_QUANT(float, 2);
  if (dtype == 1 && pack == 1) MLA_QUANT(__nv_bfloat16, 1);
  if (dtype == 1 && pack == 2) MLA_QUANT(__nv_bfloat16, 2);
#undef MLA_QUANT
  return (int)cudaErrorInvalidValue;
}
