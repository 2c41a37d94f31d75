// Paged-attention decode: one query token per slot against a paged KV pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:32
// (paged_attention_program), same arguments and result:
//   q (B, Hq, D), k_pages / v_pages (Hkv, P, page_size, D), tables
//   (B, max_pages) int32, lens (B,) int32  ->  out (B, Hq, D).
//
// Bound on the H100: bytes.  A decode step reads every live K and V row of
// every slot once (2 * Hkv * sum(lens) * D * itemsize bytes) and does only
// 4 * Hq * D FLOPs per KV row, far below the card's 295 FLOP/byte ridge.
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
template <typename T>
struct DecodeTiles {
  const T *k_head, *v_head;
  const int* row;  // the slot's block-table row
  int p_lo, ps, num_pages, len, lo;
  long page_elems;

  __device__ bool tile(int t, const T*& k, const T*& v) const {
    const int page = row[p_lo + t];
    // an out-of-range page id (the dispatch guard rules it out) contributes
    // nothing rather than reading outside the pool
    if (page < 0 || page >= num_pages) return false;
    k = k_head + page * page_elems;
    v = v_head + page * page_elems;
    return true;
  }
  __device__ DecodeMask mask(int t) const { return {(p_lo + t) * ps, len, lo}; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int heads, int kv_heads, int d, int ps, int max_pages,
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

  const T* q_rows = q + ((long)b * heads + (long)h * group) * d;
  ac::load_rows(sm.qs, sm.stride, q_rows, d, group, d, qscale);
  ac::init_state(sm, group, d);

  const long page_elems = (long)ps * d;
  DecodeTiles<T> src{k_pages + (long)h * num_pages * page_elems,
                     v_pages + (long)h * num_pages * page_elems,
                     tables + (long)b * max_pages, p_lo, ps, num_pages, len,
                     lo, page_elems};
  ac::attend_tiles<T>(sm, group, ps, d, max(0, p_hi - p_lo), src);
  __syncthreads();
  ac::store_rows(out + ((long)b * heads + (long)h * group) * d, d, sm, group, d);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lens, void* out, int slots,
           int heads, int kv_heads, int d, int ps, int max_pages,
           int num_pages, int window, float sm_scale, cudaStream_t stream) {
  if (!ac::shapes_ok<T>(ps, d, kThreads)) return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  const size_t smem = ac::Smem::bytes(group, ps, d);
  auto kernel = paged_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, (const int*)tables,
      (const int*)lens, (T*)out, heads, kv_heads, d, ps, max_pages, num_pages,
      window, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// Needs page_size a power of two <= 32 and head_dim a multiple of 8, with
// 16-byte aligned pools.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pages, const void* v_pages,
                                      const void* tables, const void* lens,
                                      void* out, int slots, int heads,
                                      int kv_heads, int d, int ps,
                                      int max_pages, int num_pages, int window,
                                      float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, lens, out, slots, heads,
                         kv_heads, d, ps, max_pages, num_pages, window,
                         sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lens, out, slots,
                                 heads, kv_heads, d, ps, max_pages, num_pages,
                                 window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
