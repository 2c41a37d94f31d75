// Multi-head latent attention (MLA) chunked prefill over the latent page
// pools, with the chunk's latent and rope page writes done inside the kernel.
//
// Two entry points, one kernel body templated on the latent format
// (attention_core.cuh):
//   * mla_prefill_launch replaces the TPU kernel repro/kernels/mla.py:180
//     (mla_prefill_program): q_lat (B, H, C, R) absorbed chunk queries, q_pe
//     (B, H, C, Dpe), ckv / kpe (B, C, R) / (B, C, Dpe) the chunk's own
//     latents, ckv_pages / kpe_pages (P, ps, R) / (P, ps, Dpe) updated in
//     place, tables (B, max_pages), starts (B,) prior tokens (page-aligned
//     for a live slot), lens (B,) live tokens in the chunk  ->  out (B, H, C,
//     R), the latent output;
//   * mla_prefill_quant_launch replaces repro/kernels/mla.py:374
//     (mla_prefill_quant_program): the chunk arrives quantized (ckv / kpe
//     packed int8 / int4 (B, C, R / pack) / (B, C, Dpe / pack) plus a (B, C,
//     1) scale each, of q's dtype), the prior pages are dequantized page by
//     page, the chunk attends its own dequantized round trip (what later
//     decode steps read back), and the packed bytes and both scales of each
//     chunk page are written into the four pools together.
//
// Scores are q_lat.ckv + q_pe.kpe times the caller's sm_scale; V is the
// latent, the first R columns of the shared [ckv | kpe] tile.
//
// Bound on the H100: at serving chunk sizes the kernel's FLOPs (2 * (2R +
// Dpe) a query-key pair, 16 heads a position) outweigh its bytes (the chunk's
// queries and outputs, the latent rows read once); this simple kernel scores
// with CUDA cores, not tensor cores, so its arithmetic bounds it in practice.
//
// Design:
//   * the TPU cell holds a whole chunk page of query rows (page_size * H =
//     256 at full width, chunk-major: row i * H + h).  Here a block holds rb
//     of those rows (32 at full width: two positions x 16 heads; fp32 Q,
//     one key tile and the accumulator take 179 KB of shared memory, opted
//     in with cudaFuncSetAttribute), so the grid is (page_size * H / rb,
//     chunk pages, slots): 256 blocks at 8 slots and chunk 64;
//   * prior context: pages [lo, ceil(starts / ps)) through the table, ragged
//     on starts plus the banded window.  All blocks of a launch run at once,
//     so the loop stops at ceil(starts / ps) and never reads a page another
//     block of the launch writes (those sit at table index >= starts / ps);
//   * the chunk itself: keys streamed from the ckv / kpe inputs in tiles of
//     page_size rows, causal and ragged on lens, never read back through the
//     pages being written;
//   * the first row block of each chunk page writes that page into the pools
//     (exactly one writer a page).  A page with no live token goes to the
//     reserved sink page 0, the table index is clamped to max_pages - 1
//     (mla.py:286-297); several blocks may write page 0 at once, which is
//     harmless because page 0 is never read for a live position.  Whole
//     pages are written, dead rows of a partly live page included, where the
//     plain path sends dead positions to page 0;
//   * every tile is read with 16-byte vector loads into registers one tile
//     ahead of the compute (attend_tiles).

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;

// Block row r is query row r0 + r of its chunk page: position r0 + r / heads
// past the page's first, head (r0 + r) % heads.

struct PriorMask {  // prior positions [0, start), banded window when set
  int base, start, q_first, r0, heads, window;
  __device__ bool operator()(int r, int j) const {
    const int k_pos = base + j;
    const int q_pos = q_first + (r0 + r) / heads;
    return k_pos < start && (window <= 0 || q_pos - k_pos < window);
  }
};

struct ChunkMask {  // in-chunk keys: causal, ragged on lens, banded window
  int base, i_first, r0, heads, len, window;
  __device__ bool operator()(int r, int j) const {
    const int kj = base + j;
    const int qi = i_first + (r0 + r) / heads;
    return kj <= qi && kj < len && (window <= 0 || qi - kj < window);
  }
};

// Prior context: the slot's pages [p_lo, p_lo + n), through its table row.
template <typename F>
struct PriorPages {
  using KV = F;
  F pool;
  const int* row;
  int p_lo, ps, num_pages, start, q_first, r0, heads, window;

  __device__ bool tile(int t, F& kv) const {
    const int page = row[p_lo + t];
    if (page < 0 || page >= num_pages) return false;  // ruled out by the guard
    kv = pool.rows((long)page * ps);
    return true;
  }
  __device__ PriorMask mask(int t) const {
    return {(p_lo + t) * ps, start, q_first, r0, heads, window};
  }
};

// The chunk itself: page-sized slices [t_lo, t_lo + n) of the ckv / kpe inputs.
template <typename F>
struct ChunkSlices {
  using KV = F;
  F chunk;  // the slot's chunk rows
  int t_lo, ps, i_first, r0, heads, len, window;

  __device__ bool tile(int t, F& kv) const {
    kv = chunk.rows((long)(t_lo + t) * ps);
    return true;
  }
  __device__ ChunkMask mask(int t) const {
    return {(t_lo + t) * ps, i_first, r0, heads, len, window};
  }
};

// Where block row r lives in the (B, H, C, ·) queries and outputs.
struct QueryRows {
  long bh0;  // slot * heads
  int chunk, i_first, r0, heads;
  __device__ long operator()(int r) const {
    const int g = r0 + r, hd = g % heads;
    return (bh0 + hd) * chunk + i_first + g / heads;
  }
};

template <typename F>
__global__ void __launch_bounds__(kThreads)
mla_prefill_kernel(const typename F::Elem* __restrict__ q,
                   const typename F::Elem* __restrict__ q_pe, F chunk_kv,
                   F pools, const int* __restrict__ tables,
                   const int* __restrict__ starts,
                   const int* __restrict__ lens,
                   typename F::Elem* __restrict__ out, int heads, int chunk,
                   int ps, int rb, int max_pages, int num_pages, int window,
                   float qscale) {
  const int sub = blockIdx.x;  // row block within the chunk page
  const int bq = blockIdx.y;   // chunk page
  const int b = blockIdx.z;    // slot
  const int r = pools.r, dk = pools.r + pools.pe;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), rb, ps, dk, r);

  const int start = starts[b];
  const int len = lens[b];
  const int i_first = bq * ps;  // first in-chunk position of the chunk page
  const int r0 = sub * rb;
  const QueryRows rows{(long)b * heads, chunk, i_first, r0, heads};
  ac::load_latent_rows(sm, q, q_pe, rb, r, pools.pe, qscale, rows);
  ac::init_state(sm, rb, r);

  // ---- prior context, gathered through the block table ------------------
  const int q_first = start + i_first;
  const int i_lo = i_first + r0 / heads;  // this block's first position
  const int p_hi = min((start + ps - 1) / ps, max_pages);
  const int p_lo = window > 0 ? max(0, start + i_lo - window + 1) / ps : 0;
  const int* row = tables + (long)b * max_pages;
  PriorPages<F> prior{pools, row, p_lo, ps, num_pages, start, q_first, r0,
                      heads, window};
  ac::attend_tiles(sm, rb, ps, dk, r, max(0, p_hi - p_lo), prior);

  // ---- the chunk itself, from the ckv / kpe inputs ----------------------
  const F own = chunk_kv.rows((long)b * chunk);
  const int t_lo = window > 0 ? max(0, i_lo - window + 1) / ps : 0;
  const int t_hi = min(bq + 1, (len + ps - 1) / ps);
  ChunkSlices<F> mine{own, t_lo, ps, i_first, r0, heads, len, window};
  ac::attend_tiles(sm, rb, ps, dk, r, max(0, t_hi - t_lo), mine);
  __syncthreads();
  ac::store_rows_at(out, sm, rb, r, rows);

  // ---- the paged write: the chunk page, by its first row block -----------
  if (sub != 0) return;
  const bool live_page = i_first < len;
  const int tidx = min(start / ps + bq, max_pages - 1);
  const int dst = live_page ? row[tidx] : 0;
  if (dst < 0 || dst >= num_pages) return;  // dropped, like XLA's scatter
  own.rows(i_first).copy_rows(pools.rows((long)dst * ps), ps);
}

template <typename F>
int launch(const void* q, const void* q_pe, F chunk_kv, F pools,
           const void* tables, const void* starts, const void* lens, void* out,
           int slots, int heads, int chunk, int ps, int rb, int max_pages,
           int num_pages, int window, float sm_scale, cudaStream_t stream) {
  using T = typename F::Elem;
  if (chunk % ps != 0 || rb < 1 || (ps * heads) % rb != 0 ||
      !F::shapes_ok(ps, pools.r, pools.pe, kThreads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ac::Smem::latent_bytes(rb, ps, pools.r + pools.pe, pools.r);
  auto kernel = mla_prefill_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ps * heads / rb, chunk / ps, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)q_pe, chunk_kv, pools, (const int*)tables,
      (const int*)starts, (const int*)lens, (T*)out, heads, chunk, ps, rb,
      max_pages, num_pages, window, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int PACK>
ac::QuantLatent<T, PACK> quant_latent(void* ckv, void* kpe, void* cs, void* rs,
                                      int r, int pe) {
  return {(int8_t*)ckv, (int8_t*)kpe, (T*)cs, (T*)rs, r, pe};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// rb query rows a block, dividing page_size * heads.  Needs chunk % page_size
// == 0, page_size a power of two <= 32, R and Dpe multiples of 16 bytes'
// worth of elements, and 16-byte aligned tensors.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int mla_prefill_launch(
    int dtype, const void* q, const void* q_pe, void* ckv, void* kpe,
    void* ckv_pages, void* kpe_pages, const void* tables, const void* starts,
    const void* lens, void* out, int slots, int heads, int chunk, int r,
    int pe, int ps, int rb, int max_pages, int num_pages, int window,
    float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    using F = ac::FpLatent<float>;
    return launch(q, q_pe, F{(float*)ckv, (float*)kpe, r, pe},
                  F{(float*)ckv_pages, (float*)kpe_pages, r, pe}, tables,
                  starts, lens, out, slots, heads, chunk, ps, rb, max_pages,
                  num_pages, window, sm_scale, s);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    using F = ac::FpLatent<B>;
    return launch(q, q_pe, F{(B*)ckv, (B*)kpe, r, pe},
                  F{(B*)ckv_pages, (B*)kpe_pages, r, pe}, tables, starts, lens,
                  out, slots, heads, chunk, ps, rb, max_pages, num_pages,
                  window, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The quantized twin: pack 1 = int8, 2 = int4; the chunk's scales and the
// scale pools are of q's dtype.  Needs R / pack and Dpe / pack multiples of
// 16 bytes.
extern "C" int mla_prefill_quant_launch(
    int dtype, int pack, const void* q, const void* q_pe, void* ckv, void* kpe,
    void* ckv_scale, void* kpe_scale, void* ckv_pages, void* kpe_pages,
    void* ckv_scales, void* kpe_scales, const void* tables, const void* starts,
    const void* lens, void* out, int slots, int heads, int chunk, int r,
    int pe, int ps, int rb, int max_pages, int num_pages, int window,
    float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MLA_PF_QUANT(T, P)                                                     \
  return launch(q, q_pe, quant_latent<T, P>(ckv, kpe, ckv_scale, kpe_scale, r, pe), \
                quant_latent<T, P>(ckv_pages, kpe_pages, ckv_scales, kpe_scales, \
                                   r, pe),                                     \
                tables, starts, lens, out, slots, heads, chunk, ps, rb,        \
                max_pages, num_pages, window, sm_scale, s)
  if (dtype == 0 && pack == 1) MLA_PF_QUANT(float, 1);
  if (dtype == 0 && pack == 2) MLA_PF_QUANT(float, 2);
  if (dtype == 1 && pack == 1) MLA_PF_QUANT(__nv_bfloat16, 1);
  if (dtype == 1 && pack == 2) MLA_PF_QUANT(__nv_bfloat16, 2);
#undef MLA_PF_QUANT
  return (int)cudaErrorInvalidValue;
}
