// Chunked-prefill attention over a paged KV pool, with the chunk's K/V page
// writes done inside the kernel.
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py:44
// (prefill_attention_program), same arguments and result:
//   q (B, Hkv, C * G, D) packed chunk-major with its GQA group
//   (row = i * G + g), k / v (B, Hkv, C, D) the chunk's own keys and values,
//   k_pages / v_pages (Hkv, P, ps, D) updated in place, tables (B, max_pages),
//   starts (B,) prior tokens (page-aligned for a live slot), lens (B,) live
//   tokens in the chunk  ->  out (B, Hkv, C * G, D).
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
template <typename T>
struct PriorTiles {
  const T *k_head, *v_head;
  const int* row;
  int p_lo, ps, num_pages, start, q_lo, group, window;
  long page_elems;

  __device__ bool tile(int t, const T*& k, const T*& v) const {
    const int page = row[p_lo + t];
    if (page < 0 || page >= num_pages) return false;  // ruled out by the guard
    k = k_head + page * page_elems;
    v = v_head + page * page_elems;
    return true;
  }
  __device__ PriorMask mask(int t) const {
    return {(p_lo + t) * ps, start, q_lo, group, window};
  }
};

// The chunk itself: page-sized slices [t_lo, t_lo + n) of the k / v inputs.
template <typename T>
struct ChunkTiles {
  const T *k_chunk, *v_chunk;
  int t_lo, ps, i_lo, group, len, window;
  long page_elems;

  __device__ bool tile(int t, const T*& k, const T*& v) const {
    k = k_chunk + (t_lo + t) * page_elems;
    v = v_chunk + (t_lo + t) * page_elems;
    return true;
  }
  __device__ ChunkMask mask(int t) const {
    return {(t_lo + t) * ps, i_lo, group, len, window};
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ k_pages,
                         T* __restrict__ v_pages,
                         const int* __restrict__ tables,
                         const int* __restrict__ starts,
                         const int* __restrict__ lens, T* __restrict__ out,
                         int kv_heads, int group, int chunk, int d, int ps,
                         int max_pages, int num_pages, int window,
                         float qscale) {
  const int h = blockIdx.x;   // kv head
  const int bq = blockIdx.y;  // chunk page
  const int b = blockIdx.z;   // slot
  const int rows = ps * group;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), rows, ps, d);

  const int start = starts[b];
  const int len = lens[b];
  const long bh = (long)b * kv_heads + h;
  const T* q_blk = q + (bh * chunk * group + (long)bq * rows) * d;
  ac::load_rows(sm.qs, sm.stride, q_blk, d, rows, d, qscale);
  ac::init_state(sm, rows, d);

  // ---- prior context, gathered through the block table ------------------
  const int i_lo = bq * ps;         // first in-chunk position of this block
  const int q_lo = start + i_lo;    // its absolute position
  const int p_hi = min((start + ps - 1) / ps, max_pages);
  const int p_lo = window > 0 ? max(0, q_lo - window + 1) / ps : 0;
  const long page_elems = (long)ps * d;
  const int* row = tables + (long)b * max_pages;
  PriorTiles<T> prior{k_pages + (long)h * num_pages * page_elems,
                      v_pages + (long)h * num_pages * page_elems, row, p_lo,
                      ps, num_pages, start, q_lo, group, window, page_elems};
  ac::attend_tiles<T>(sm, rows, ps, d, max(0, p_hi - p_lo), prior);

  // ---- the chunk itself, from the k / v inputs --------------------------
  const T* k_chunk = k + bh * chunk * d;
  const T* v_chunk = v + bh * chunk * d;
  const int t_lo = window > 0 ? max(0, i_lo - window + 1) / ps : 0;
  const int t_hi = min(bq + 1, (len + ps - 1) / ps);
  ChunkTiles<T> own{k_chunk, v_chunk, t_lo, ps, i_lo, group, len, window,
                    page_elems};
  ac::attend_tiles<T>(sm, rows, ps, d, max(0, t_hi - t_lo), own);
  __syncthreads();
  ac::store_rows(out + (bh * chunk * group + (long)bq * rows) * d, d, sm,
                 rows, d);

  // ---- the paged write: this block's chunk page, through the table ------
  const bool live_page = i_lo < len;
  const int tidx = min(start / ps + bq, max_pages - 1);
  const int dst = live_page ? row[tidx] : 0;
  if (dst < 0 || dst >= num_pages) return;  // dropped, like XLA's scatter
  uint4* k_dst = reinterpret_cast<uint4*>(k_pages + ((long)h * num_pages + dst) * page_elems);
  uint4* v_dst = reinterpret_cast<uint4*>(v_pages + ((long)h * num_pages + dst) * page_elems);
  const uint4* k_src = reinterpret_cast<const uint4*>(k_chunk + (long)bq * page_elems);
  const uint4* v_src = reinterpret_cast<const uint4*>(v_chunk + (long)bq * page_elems);
  const int nvec = (int)(page_elems / ac::vec_elems<T>());
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    k_dst[i] = k_src[i];
    v_dst[i] = v_src[i];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* k_pages,
           void* v_pages, const void* tables, const void* starts,
           const void* lens, void* out, int slots, int kv_heads, int group,
           int chunk, int d, int ps, int max_pages, int num_pages, int window,
           float sm_scale, cudaStream_t stream) {
  if (chunk % ps != 0 || !ac::shapes_ok<T>(ps, d, kThreads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ac::Smem::bytes(ps * group, ps, d);
  auto kernel = prefill_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, chunk / ps, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)k_pages, (T*)v_pages,
      (const int*)tables, (const int*)starts, (const int*)lens, (T*)out,
      kv_heads, group, chunk, d, ps, max_pages, num_pages, window,
      sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// Needs chunk % page_size == 0, page_size a power of two <= 32 and head_dim
// a multiple of 8, with 16-byte aligned tensors.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int prefill_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* k_pages,
    void* v_pages, const void* tables, const void* starts, const void* lens,
    void* out, int slots, int kv_heads, int group, int chunk, int d, int ps,
    int max_pages, int num_pages, int window, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, k_pages, v_pages, tables, starts, lens, out,
                         slots, kv_heads, group, chunk, d, ps, max_pages,
                         num_pages, window, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, k_pages, v_pages, tables, starts,
                                 lens, out, slots, kv_heads, group, chunk, d,
                                 ps, max_pages, num_pages, window, sm_scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
