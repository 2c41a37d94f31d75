// Chunked-prefill attention over a paged KV pool, with the chunk's K/V page
// writes done inside the kernel.
//
// Two entry points, one kernel body templated on the K/V format
// (attention_core.cuh):
//   * prefill_attention_launch replaces the TPU kernel
//     repro/kernels/prefill_attention.py:44 (prefill_attention_program):
//     q (B, Hkv, C * G, D) packed chunk-major with its GQA group
//     (row = i * G + g), k / v (B, Hkv, C, D) the chunk's own keys and
//     values, k_pages / v_pages (Hkv, P, ps, D) updated in place, tables
//     (B, max_pages), starts (B,) prior tokens (page-aligned for a live
//     slot), lens (B,) live tokens in the chunk  ->  out (B, Hkv, C * G, D);
//   * prefill_attention_quant_launch replaces
//     repro/kernels/prefill_attention.py:157
//     (prefill_attention_quant_program): the chunk arrives quantized
//     (k / v (B, Hkv, C, D / pack) int8 plus scales (B, Hkv, C, 1) of q's
//     dtype), prior pages are dequantized page by page, the chunk attends
//     its own dequantized round trip (what later decode steps read back),
//     and the packed bytes and scales of each chunk page are written into
//     the four pools, bytes and scales of the same rows together.
//
// Bound on the H100: bytes at serving batch sizes.  Each block reads its
// slot's prior pages (2 * Hkv * starts * D * itemsize bytes per slot, read
// once per chunk page), the chunk's Q/K/V, and writes the output plus the
// chunk's K/V pages.  Its FLOPs (4 * D per query-key pair) outweigh those
// bytes only for long prior contexts; this simple kernel uses CUDA cores,
// not tensor cores, so in practice its arithmetic bounds it.
//
// Design:
//   * grid (kv_head, chunk_page, slot), as the TPU grid.  A block holds
//     page_size * G query rows (96 for qwen2-1.5B), i.e. one chunk page of
//     positions for the whole GQA group, so every K/V tile it loads serves
//     all G heads;
//   * prior context: pages [lo, ceil(starts / ps)) read through the table,
//     ragged on starts plus the banded window when set.  The TPU grid ran in
//     order; here all blocks of a launch run concurrently, so the loop stops
//     at ceil(starts / ps) and never reads a page that another block of the
//     same launch is writing (those sit at table index >= starts / ps);
//   * the chunk itself: keys streamed from the k / v inputs in tiles of
//     page_size, causal and ragged on lens, never read back through the
//     pages being written.  Tiling the chunk keeps shared memory at one K/V
//     tile whatever the chunk width;
//   * the block then writes its own chunk page into the pools.  A page with
//     no live token (an idle lens == 0 slot, the dead tail of a partial final
//     chunk) goes to the reserved sink page 0, and the table index is
//     clamped to max_pages - 1 (prefill_attention.py:142-152).  Several
//     blocks may write page 0 at once, which is harmless because page 0 is
//     never read for a live position; the pools must start zeroed so that it
//     holds finite values.  The kernel writes whole pages, dead rows of a
//     partly live page included, where the plain path sends dead positions
//     to page 0: pool bytes past lens differ between the two paths;
//   * every K/V tile (page or chunk slice) is read with 16-byte vector loads
//     into registers one tile ahead of the compute (attend_tiles), so its
//     device-memory latency overlaps the scoring of the tile before;
//   * the resident Q block plus the fp32 accumulator take about 120 KB of
//     shared memory at D = 128 (above the 48 KB static limit), so the
//     launcher opts in with cudaFuncSetAttribute(MaxDynamicSharedMemorySize).

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;

struct PriorMask {  // prior positions [0, start), banded window when set
  int base, start, q_lo, group, window;
  __device__ bool operator()(int r, int j) const {
    const int k_pos = base + j;
    const int q_pos = q_lo + r / group;
    return k_pos < start && (window <= 0 || q_pos - k_pos < window);
  }
};

struct ChunkMask {  // in-chunk keys: causal, ragged on lens, banded window
  int base, i_lo, group, len, window;
  __device__ bool operator()(int r, int j) const {
    const int kj = base + j;
    const int qi = i_lo + r / group;
    return kj <= qi && kj < len && (window <= 0 || qi - kj < window);
  }
};

// Prior context: the slot's pages [p_lo, p_lo + n), through its table row.
template <typename F>
struct PriorTiles {
  using KV = F;
  F head;  // the kv head's pool, at page 0
  const int* row;
  int p_lo, ps, num_pages, start, q_lo, group, window, d;

  __device__ bool tile(int t, F& kv) const {
    const int page = row[p_lo + t];
    if (page < 0 || page >= num_pages) return false;  // ruled out by the guard
    kv = head.rows((long)page * ps, d);
    return true;
  }
  __device__ PriorMask mask(int t) const {
    return {(p_lo + t) * ps, start, q_lo, group, window};
  }
};

// The chunk itself: page-sized slices [t_lo, t_lo + n) of the k / v inputs.
template <typename F>
struct ChunkTiles {
  using KV = F;
  F chunk;  // the (slot, kv head)'s chunk rows
  int t_lo, ps, i_lo, group, len, window, d;

  __device__ bool tile(int t, F& kv) const {
    kv = chunk.rows((long)(t_lo + t) * ps, d);
    return true;
  }
  __device__ ChunkMask mask(int t) const {
    return {(t_lo + t) * ps, i_lo, group, len, window};
  }
};

template <typename F>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const typename F::Elem* __restrict__ q, F chunk_kv,
                         F pools, const int* __restrict__ tables,
                         const int* __restrict__ starts,
                         const int* __restrict__ lens,
                         typename F::Elem* __restrict__ out, int kv_heads,
                         int group, int chunk, int d, int ps, int max_pages,
                         int num_pages, int window, float qscale) {
  const int h = blockIdx.x;   // kv head
  const int bq = blockIdx.y;  // chunk page
  const int b = blockIdx.z;   // slot
  const int rows = ps * group;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), rows, ps, d);

  const int start = starts[b];
  const int len = lens[b];
  const long bh = (long)b * kv_heads + h;
  const long q_off = (bh * chunk * group + (long)bq * rows) * d;
  ac::load_rows(sm.qs, sm.stride, q + q_off, d, rows, d, qscale);
  ac::init_state(sm, rows, d);

  // ---- prior context, gathered through the block table ------------------
  const int i_lo = bq * ps;         // first in-chunk position of this block
  const int q_lo = start + i_lo;    // its absolute position
  const int p_hi = min((start + ps - 1) / ps, max_pages);
  const int p_lo = window > 0 ? max(0, q_lo - window + 1) / ps : 0;
  const int* row = tables + (long)b * max_pages;
  const F head = pools.rows((long)h * num_pages * ps, d);
  PriorTiles<F> prior{head, row, p_lo, ps, num_pages, start, q_lo, group,
                      window, d};
  ac::attend_tiles(sm, rows, ps, d, max(0, p_hi - p_lo), prior);

  // ---- the chunk itself, from the k / v inputs --------------------------
  const F own_rows = chunk_kv.rows(bh * chunk, d);
  const int t_lo = window > 0 ? max(0, i_lo - window + 1) / ps : 0;
  const int t_hi = min(bq + 1, (len + ps - 1) / ps);
  ChunkTiles<F> own{own_rows, t_lo, ps, i_lo, group, len, window, d};
  ac::attend_tiles(sm, rows, ps, d, max(0, t_hi - t_lo), own);
  __syncthreads();
  ac::store_rows(out + q_off, d, sm, rows, d);

  // ---- the paged write: this block's chunk page, through the table ------
  const bool live_page = i_lo < len;
  const int tidx = min(start / ps + bq, max_pages - 1);
  const int dst = live_page ? row[tidx] : 0;
  if (dst < 0 || dst >= num_pages) return;  // dropped, like XLA's scatter
  own_rows.rows(i_lo, d).copy_rows(head.rows((long)dst * ps, d), ps, d);
}

template <typename F>
int launch(const void* q, F chunk_kv, F pools, const void* tables,
           const void* starts, const void* lens, void* out, int slots,
           int kv_heads, int group, int chunk, int d, int ps, int max_pages,
           int num_pages, int window, float sm_scale, cudaStream_t stream) {
  using T = typename F::Elem;
  if (chunk % ps != 0 || !F::shapes_ok(ps, d, kThreads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ac::Smem::bytes(ps * group, ps, d);
  auto kernel = prefill_attention_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, chunk / ps, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, chunk_kv, pools, (const int*)tables, (const int*)starts,
      (const int*)lens, (T*)out, kv_heads, group, chunk, d, ps, max_pages,
      num_pages, window, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int PACK>
ac::QuantKV<T, PACK> quant_kv(void* k, void* v, void* ks, void* vs) {
  return {(int8_t*)k, (int8_t*)v, (T*)ks, (T*)vs};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// Needs chunk % page_size == 0, page_size a power of two <= 32 and head_dim
// a multiple of 8, with 16-byte aligned tensors.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int prefill_attention_launch(
    int dtype, const void* q, void* k, void* v, void* k_pages, void* v_pages,
    const void* tables, const void* starts, const void* lens, void* out,
    int slots, int kv_heads, int group, int chunk, int d, int ps,
    int max_pages, int num_pages, int window, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(q, ac::FpKV<float>{(float*)k, (float*)v},
                  ac::FpKV<float>{(float*)k_pages, (float*)v_pages}, tables,
                  starts, lens, out, slots, kv_heads, group, chunk, d, ps,
                  max_pages, num_pages, window, sm_scale, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch(q, ac::FpKV<B>{(B*)k, (B*)v},
                  ac::FpKV<B>{(B*)k_pages, (B*)v_pages}, tables, starts, lens,
                  out, slots, kv_heads, group, chunk, d, ps, max_pages,
                  num_pages, window, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The quantized twin: pack 1 = int8, 2 = int4; the chunk's scales and the
// scale pools are of q's dtype.  Needs head_dim / pack a multiple of 16
// bytes, with 16-byte aligned packed tensors.
extern "C" int prefill_attention_quant_launch(
    int dtype, int pack, const void* q, void* k, void* v, void* k_scale,
    void* v_scale, void* k_pages, void* v_pages, void* k_scales,
    void* v_scales, const void* tables, const void* starts, const void* lens,
    void* out, int slots, int kv_heads, int group, int chunk, int d, int ps,
    int max_pages, int num_pages, int window, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PF_QUANT(T, P)                                                       \
  return launch(q, quant_kv<T, P>(k, v, k_scale, v_scale),                   \
                quant_kv<T, P>(k_pages, v_pages, k_scales, v_scales), tables, \
                starts, lens, out, slots, kv_heads, group, chunk, d, ps,     \
                max_pages, num_pages, window, sm_scale, s)
  if (dtype == 0 && pack == 1) PF_QUANT(float, 1);
  if (dtype == 0 && pack == 2) PF_QUANT(float, 2);
  if (dtype == 1 && pack == 1) PF_QUANT(__nv_bfloat16, 1);
  if (dtype == 1 && pack == 2) PF_QUANT(__nv_bfloat16, 2);
#undef PF_QUANT
  return (int)cudaErrorInvalidValue;
}
