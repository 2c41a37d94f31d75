// Paged-attention decode: one query token per slot against a paged KV pool.
//
// Two entry points:
//   * paged_attention_launch replaces the TPU kernel
//     repro/kernels/paged_attention.py:32 (paged_attention_program):
//     q (B, Hq, D), k_pages / v_pages (Hkv, P, page_size, D), tables
//     (B, max_pages) int32, lens (B,) int32  ->  out (B, Hq, D);
//   * paged_attention_quant_launch replaces
//     repro/kernels/paged_attention.py:93 (paged_attention_quant_program):
//     the same over packed int8 / int4 pools (Hkv, P, page_size, D / pack)
//     plus scales (Hkv, P, page_size, 1) of q's dtype, each value
//     dequantized to q's dtype on its way into shared memory, on the same
//     split grid and merge as the fp kernel.
//
// Bound on the H100: bytes.  A decode step reads every live K and V row of
// every slot once (2 * Hkv * sum(lens) * D * itemsize bytes; D / pack bytes
// plus one scale per row when quantized) and does only 4 * Hq * D FLOPs per
// KV row, far below the card's 295 FLOP/byte ridge.  At qwen2-1.5B's
// serving shape (slots 8, Hkv 2, D 128, lengths up to 1024) that is ~4 MB:
// ~1.2 us at 3.35 TB/s, so what holds a launch back is latency, not bytes.
//
// The fp kernel: split-KV over a static grid.
//   * The TPU grid (kv_head, slot) gives 2 x slots = 16 blocks at qwen's
//     shape, and each walked its slot's pages one after another: 0.16 ms
//     on 16 of an H100's 132 SMs (80GB HBM3, 700 W).  Here the grid is
//     (kv_head, slot, split): split s of a slot scores its keys
//     [s * split_keys, (s + 1) * split_keys) that are live (inside
//     [max(0, len - window), len)) and leaves the partial softmax state of
//     its GQA group's rows in fp32 scratch: O unnormalised, the running max
//     m (log2 domain, clamped at NEG_CLAMP) and the row sum l.  A second,
//     small kernel (split_merge.cuh's merge_kernel, shared with the MLA
//     decode) rescales the splits to their common max, sums them, applies
//     safe_div and rounds once to the output type: the arithmetic of
//     WarpAttention::absorb (attention_mma.cuh) across blocks.
//   * splits and split_keys come from static shapes and the card's SM count
//     only (paged_attention.py, decode_splits), never from the lengths: the
//     host never reads a length (the multi-step window runs with host syncs
//     forbidden) and the grid stays fixed for graph capture.  A split whose
//     keys all lie past len, or before the window, reads nothing and leaves
//     m = NEG_CLAMP, l = 0, which the merge weighs 0 (its O is not read); a
//     slot with len 0 emits zeros.  At qwen's shape: 16 splits of one
//     64-key tile, 256 blocks.
//   * bf16 at D 64 or 128 (the tensor-core path): each split block runs
//     attention_mma.cuh's WarpAttention over 64-key tiles copied through its
//     cp.async ring, the keys' absolute positions written beside each tile.
//     The GQA group's rows (6 for qwen) sit in one warp's 16-row m-tile,
//     every row at query position len - 1 (PosMask with q0 = len - 1 and
//     causal: key < len, and len - key <= window); warps whose rows are all
//     dead only copy.  Key rows outside the live range are zero-filled and
//     never read (padding pages may hold NaN: 0 * NaN is NaN).  P.V is the
//     bf16 pair hi + lo (1.00 bf16 ulp; P rounded once to bf16 reads 23-30
//     ulps on decode).  Splits hold whole 64-key tiles and pages (a power
//     of two <= 32) nest in them, so no split starts inside a tile.
//   * fp32, and bf16 at other head dims: attention_core.cuh's CUDA-core
//     body over the split's pages (16-byte vector loads one page ahead of
//     the compute), on the same split grid and the same merge.
//
// What still holds it back (H100 80GB HBM3 at 700 W, qwen's shape: 16.6 us
// a call): two launches a decode step, the split kernel 7.7 us and the
// merge 3.7 us of device time (chip_smoke.py's decode-cost reading); one
// warp of four does the arithmetic of a split; the table entry a key row
// reads is a dependent device-memory load ahead of its copy.
//
// The quantized twin takes the same grid, merge and paths.  Its bf16
// launches at D 64 or 128 run the same WarpAttention walk with a staged
// source (QuantSplitKeys below): each 64-key tile's packed K and V rows and
// their scales go by cp.async into a staging area and are dequantized into
// the ring's bf16 tile, code * scale in fp32 rounded once (kv_dequant.cuh,
// bit for bit the plain version's dequantize-then-round), as the quantized
// prefill's loader does; a dead row is zero-filled, its scale too, and
// dequantizes to zeros.  fp32 and other head dims take the CUDA-core body
// (attention_core.cuh's QuantKV, the DequantStage).  At qwen's shape in
// int8 (H100 80GB HBM3 at 700 W): 16.9 us a call, the split kernel 7.85 us
// (the fp kernel's 7.71 plus the staging's wait and conversion) and the
// merge 3.78.

#include "attention_core.cuh"
#include "attention_mma.cuh"
#include "kv_dequant.cuh"
#include "split_merge.cuh"

namespace {

constexpr int kThreads = 128;

using sk::Partials;

// ---- the CUDA-core body (fp32, other head dims, the quantized twin) -------

struct DecodeMask {
  int base, len, lo;
  __device__ bool operator()(int /*r*/, int j) const {
    const int pos = base + j;
    return pos < len && pos >= lo;
  }
};

// The split's live pages, read through the slot's block-table row.
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

// Block (kv head, slot, split): the split's pages [s * split_pages, (s + 1)
// * split_pages) that hold live keys.
template <typename F>
__global__ void __launch_bounds__(2 * kThreads)
paged_attention_kernel(const typename F::Elem* __restrict__ q, F pools,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, Partials part, int heads,
                       int kv_heads, int d, int ps, int max_pages, int num_pages,
                       int window, int split_pages, float qscale) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int s = blockIdx.z;  // split
  const int group = heads / kv_heads;
  const int len = lens[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_lo = max(lo / ps, s * split_pages);
  const int p_hi = min(min((len + ps - 1) / ps, max_pages), (s + 1) * split_pages);
  const int n = max(0, p_hi - p_lo);
  if (n == 0) {
    part.empty(b, h * group, group, s);
    return;
  }
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), group, ps, d);

  const long q_off = ((long)b * heads + (long)h * group) * d;
  ac::load_rows(sm.qs, sm.stride, q + q_off, d, group, d, qscale);
  ac::init_state(sm, group, d);

  DecodeTiles<F> src{pools.rows((long)h * num_pages * ps, d),
                     tables + (long)b * max_pages, p_lo, ps, num_pages, len,
                     lo, d};
  ac::attend_tiles(sm, group, ps, d, n, src);
  __syncthreads();
  part.store(sm, b, h * group, group, s, d);
}

template <typename F>
int launch(const void* q, F pools, const void* tables, const void* lens,
           Partials part, int slots, int heads, int kv_heads, int d,
           int ps, int max_pages, int num_pages, int window, int split_pages,
           float sm_scale, cudaStream_t stream) {
  using T = typename F::Elem;
  // twice the threads where a tile is more vectors than kThreads hold (fp32
  // at D 128 with pages of 32)
  const int threads = F::shapes_ok(ps, d, kThreads) ? kThreads : 2 * kThreads;
  if (!F::shapes_ok(ps, d, threads)) return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  const size_t smem = ac::Smem::bytes(group, ps, d);
  auto kernel = paged_attention_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, slots, part.splits);
  kernel<<<grid, threads, smem, stream>>>(
      (const T*)q, pools, (const int*)tables, (const int*)lens, part,
      heads, kv_heads, d, ps, max_pages, num_pages, window, split_pages,
      sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// ---- the tensor-core body (bf16, D 64 or 128) -----------------------------

constexpr int kTcStages = 2;  // a staged source converts into two stages

using am::bf16;

// The split's keys in 64-key tiles at absolute positions: key j = KEYS (t0 +
// t) + r of tile t lies on table entry j / ps at page row j % ps, and is
// read when it is live (lo <= j < len) and its page lies in the pool.
struct SplitRule {
  const int* table;  // the slot's block-table row
  int ps_log2, t0, lo, len, num_pages, group;

  // Key row r of tile t: its row in the kv head's pools and its position.
  __device__ bool key(int t, int r, long& at, int& pos) const {
    const int j = (t0 + t) * am::KEYS + r;
    if (j < lo || j >= len) return false;
    const int page = table[j >> ps_log2];
    if (page < 0 || page >= num_pages) return false;  // contributes nothing
    at = ((long)page << ps_log2) + (j & ((1 << ps_log2) - 1));
    pos = j;
    return true;
  }
  // a warp of block rows [r0, r1): only the group's rows are live
  __device__ int kind(int /*t*/, int r0, int /*r1*/) const {
    return r0 < group ? am::MASKED : am::SKIP;
  }
};

// bf16 keys, copied by cp.async straight into the ring.
template <int D>
struct SplitKeys : SplitRule {
  const bf16 *kpool, *vpool;  // the kv head's pools, at page 0

  __device__ bool row(int t, int r, const bf16*& kp, const bf16*& vp, int& pos) const {
    long at = 0;
    if (!key(t, r, at, pos)) return false;
    kp = kpool + at * D;
    vp = vpool + at * D;
    return true;
  }
};

// Quantized keys, a staged source of am::attend: a tile's packed K and V
// rows go by cp.async into a staging area of their own, each row's scale
// beside them (the aligned 4 bytes that hold it, and which half it is), and
// are dequantized into the ring's bf16 tile (kv_dequant.cuh).  One thread a
// job, a (key row, K or V) of the tile: it copies the row and its scale and
// notes the key's position, then converts the row and, for K, writes the
// position beside the tile.  A dead row is zero-filled, its scale too, so
// it dequantizes to zeros.  Staging rows are padded by 16 bytes, so the
// rows of a warp's copies and loads fall on distinct banks.
template <int D, int PACK>
struct QuantSplitKeys : SplitRule {
  static constexpr bool STAGED = true;
  static constexpr int BYTES = D / PACK;  // packed bytes a row
  static constexpr int ROW = BYTES + 16;  // staging bytes between rows
  static constexpr int JOBS = 2 * am::KEYS;
  // the rows, then a job's scale word, key position and scale half
  __host__ __device__ static constexpr size_t bytes() { return (size_t)JOBS * (ROW + 4 + 4 + 1); }
  const int8_t *kpool, *vpool;  // the kv head's packed pools, at page 0
  const bf16 *kspool, *vspool;  // their scales
  int8_t* stage;                // JOBS rows of ROW bytes, then JOBS each of the rest

  __device__ uint32_t* words() const { return reinterpret_cast<uint32_t*>(stage + JOBS * ROW); }
  __device__ int* positions() const { return reinterpret_cast<int*>(words() + JOBS); }
  __device__ uint8_t* halves() const { return reinterpret_cast<uint8_t*>(positions() + JOBS); }

  // Start tile u's copies: job j = key row j / 2, K for even j and V for odd.
  __device__ void copy(int u, const void* any) const {
    for (int j = threadIdx.x; j < JOBS; j += blockDim.x) {
      const int kv = j & 1, r = j >> 1;
      long at = 0;
      int pos = -1;
      const bool live = key(u, r, at, pos);
      const int8_t* src = (kv ? vpool : kpool) + at * BYTES;
      int8_t* dst = stage + j * ROW;
#pragma unroll
      for (int c = 0; c < BYTES; c += 16) gc::cp_async<16>(dst + c, live ? src + c : any, live);
      const size_t addr = reinterpret_cast<size_t>((kv ? vspool : kspool) + at);
      gc::cp_async<4>(words() + j, live ? reinterpret_cast<const void*>(addr & ~(size_t)3) : any,
                      live);
      // this thread's own slots: read by its convert only
      positions()[j] = live ? pos : -1;
      halves()[j] = (addr >> 1) & 1;
    }
  }

  // Dequantize tile u's staged rows into stage u % 2, each thread its own
  // jobs' bytes (landed: the caller waited for its copies).
  __device__ void convert(const am::Ring<D, D, kTcStages, 1>& ring, int u) const {
    for (int j = threadIdx.x; j < JOBS; j += blockDim.x) {
      const int kv = j & 1, r = j >> 1, slot = u & 1;
      const uint32_t word = words()[j];
      const float scale = kvq::bf16_bits(halves()[j] ? word >> 16 : word);
      const int8_t* src = stage + j * ROW;
      using R = am::Ring<D, D, kTcStages, 1>;
      bf16* dst = (kv ? ring.v(slot) : ring.k(slot)) + r * R::KSTRIDE;  // K and V rows alike
#pragma unroll 1  // a row's vectors one at a time: the softmax state holds the registers
      for (int c = 0; c < BYTES; c += 16)
        kvq::dequant<PACK>(dst + c * PACK, *reinterpret_cast<const uint4*>(src + c), scale);
      if (kv == 0) ring.kpos(slot)[r] = positions()[j];
    }
  }
};

template <typename F>
struct Pack {  // packed values a byte: 0 for bf16 rows
  static constexpr int value = 0;
};
template <int P>
struct Pack<ac::QuantKV<bf16, P>> {
  static constexpr int value = P;
};

// Shared memory of a tensor-core block: the ring, then the quantized
// loader's staging area.
template <int D, int PACK>
constexpr size_t tc_smem() {
  return am::Ring<D, D, kTcStages, 1>::bytes() +
         (PACK ? QuantSplitKeys<D, PACK ? PACK : 1>::bytes() : 0);
}

// Block (kv head, slot, split): block row r < group is query head h * group
// + r, all at position len - 1; the split's tiles [s * split_tiles, (s + 1)
// * split_tiles) that hold live keys.  F is the keys' format: bf16 rows
// (FpKV) copied straight into the ring, or packed rows with scales (QuantKV)
// staged and dequantized by QuantSplitKeys.
template <int D, typename F>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel_tc(const bf16* __restrict__ q, F pools, const int* __restrict__ tables,
                          const int* __restrict__ lens, Partials part, int kv_heads, int ps,
                          int max_pages, int num_pages, int window, int split_tiles,
                          float qscale) {
  constexpr int PACK = Pack<F>::value;
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int s = blockIdx.z;  // split
  const int group = part.heads / kv_heads;
  const int len = lens[b];
  const int keys = min(len, max_pages * ps);  // a length past the table reads no more
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int t_lo = max(lo / am::KEYS, s * split_tiles);
  const int t_hi = min((keys + am::KEYS - 1) / am::KEYS, (s + 1) * split_tiles);
  if (t_hi <= t_lo) {
    part.empty(b, h * group, group, s);
    return;
  }
  extern __shared__ float4 smem4[];
  const am::Ring<D, D, kTcStages, 1> ring(smem4);
  const F head = pools.rows((long)h * num_pages * ps, D);
  const SplitRule rule{tables + (long)b * max_pages, __ffs(ps) - 1, t_lo, lo, keys, num_pages,
                       group};
  const am::PosMask mask{nullptr, len - 1, group, window, true};
  const bf16* qg = q + ((long)b * part.heads + (long)h * group) * D;
  auto qrow = [&](int r) { return r < group ? qg + (long)r * D : nullptr; };
  am::WarpAttention<D, D> wa;
  if constexpr (PACK == 0) {
    SplitKeys<D> src{rule, head.k, head.v};
    am::attend(wa, ring, qrow, t_hi - t_lo, src, mask, qscale, q);
  } else {
    QuantSplitKeys<D, PACK> src{rule, head.k, head.v, head.ks, head.vs,
                                reinterpret_cast<int8_t*>(ring.kpos(ring.SLOTS))};
    am::attend(wa, ring, qrow, t_hi - t_lo, src, mask, qscale, q);
  }
  wa.store_state(part.o, part.m, part.l, [&](int r) {
    return r < group ? part.row(b, h * group + r, s) : -1L;
  });
}

template <int D, typename F>
int launch_tc(const void* q, F pools, const void* tables, const void* lens, Partials part,
              int slots, int kv_heads, int ps, int max_pages, int num_pages, int window,
              int split_tiles, float sm_scale, cudaStream_t stream) {
  const int group = part.heads / kv_heads;
  if (group > kThreads / 32 * 16 || am::KEYS % ps != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem<D, Pack<F>::value>();
  auto kernel = paged_attention_kernel_tc<D, F>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, slots, part.splits);
  kernel<<<grid, kThreads, smem, stream>>>((const bf16*)q, pools, (const int*)tables,
                                           (const int*)lens, part, kv_heads, ps, max_pages,
                                           num_pages, window, split_tiles,
                                           sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// The tensor-core launch of format F at head dim 64 or 128.
template <typename F>
int launch_tc_any(int d, const void* q, F pools, const void* tables, const void* lens,
                  Partials part, int slots, int kv_heads, int ps, int max_pages, int num_pages,
                  int window, int split_keys, float sm_scale, cudaStream_t stream) {
  const int tiles = split_keys / am::KEYS;
  if (d == 128)
    return launch_tc<128>(q, pools, tables, lens, part, slots, kv_heads, ps, max_pages,
                          num_pages, window, tiles, sm_scale, stream);
  if (d == 64)
    return launch_tc<64>(q, pools, tables, lens, part, slots, kv_heads, ps, max_pages,
                         num_pages, window, tiles, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int PACK>
ac::QuantKV<T, PACK> quant_pools(void* k, void* v, void* ks, void* vs) {
  return {(int8_t*)k, (int8_t*)v, (T*)ks, (T*)vs};
}

// The grid's rules (both entry points): split_keys a multiple of the
// 64-key tile, splits * split_keys covering the table, pages a power of two
// that nests in a tile.
bool grid_ok(int slots, int splits, int split_keys, int ps, int max_pages) {
  return splits >= 1 && splits <= 65535 && slots >= 1 && slots <= 65535 &&
         split_keys >= am::KEYS && split_keys % am::KEYS == 0 &&
         (long)splits * split_keys >= (long)max_pages * ps && ps >= 1 && ps <= am::KEYS &&
         (ps & (ps - 1)) == 0;
}

Partials partials(void* o_part, void* ml_part, int slots, int heads, int splits) {
  const long rows = (long)slots * heads * splits;
  return {(float*)o_part, (float*)ml_part, (float*)ml_part + rows, heads, splits};
}

// The merge after a split launch that returned rc.
int merged(int rc, int dtype, const Partials& part, int slots, int d, void* out,
           cudaStream_t st) {
  if (rc != 0) return rc;
  return dtype == 0 ? sk::merge<float>(part, slots, d, out, st)
                    : sk::merge<__nv_bfloat16>(part, slots, d, out, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// tc 1 takes the tensor-core body (bfloat16, head_dim 64 or 128, at most 64
// query heads a kv head).  The grid is (kv_heads, slots, splits), split s
// covering keys [s * split_keys, (s + 1) * split_keys): split_keys a
// multiple of 64 and splits * split_keys >= max_pages * page_size.
// o_part (slots, heads, splits, head_dim) and ml_part (2, slots, heads,
// splits) are fp32 scratch: the partial states, then merged into out.
// Needs page_size a power of two <= 32 and head_dim a multiple of 8, with
// 16-byte aligned pools.  Returns the first cudaGetLastError() after the
// two launches (0 = launched), or cudaErrorInvalidValue for shapes it does
// not take.
extern "C" int paged_attention_launch(int dtype, int tc, const void* q, void* k_pages,
                                      void* v_pages, const void* tables, const void* lens,
                                      void* out, void* o_part, void* ml_part, int slots,
                                      int heads, int kv_heads, int d, int ps, int max_pages,
                                      int num_pages, int window, int splits, int split_keys,
                                      float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!grid_ok(slots, splits, split_keys, ps, max_pages)) return (int)cudaErrorInvalidValue;
  const Partials part = partials(o_part, ml_part, slots, heads, splits);
  using B = __nv_bfloat16;
  int rc = (int)cudaErrorInvalidValue;
  if (tc && dtype == 1)
    rc = launch_tc_any(d, q, ac::FpKV<B>{(B*)k_pages, (B*)v_pages}, tables, lens, part, slots,
                       kv_heads, ps, max_pages, num_pages, window, split_keys, sm_scale, st);
  else if (!tc && dtype == 0)
    rc = launch(q, ac::FpKV<float>{(float*)k_pages, (float*)v_pages}, tables, lens, part,
                slots, heads, kv_heads, d, ps, max_pages, num_pages, window, split_keys / ps,
                sm_scale, st);
  else if (!tc && dtype == 1)
    rc = launch(q, ac::FpKV<B>{(B*)k_pages, (B*)v_pages}, tables, lens, part, slots, heads,
                kv_heads, d, ps, max_pages, num_pages, window, split_keys / ps, sm_scale, st);
  return merged(rc, dtype, part, slots, d, out, st);
}

// The quantized twin: pack 1 = int8, 2 = int4; the scale pools are of q's
// dtype; tc, the grid and the scratch as above (the tensor-core body takes
// the same shapes, with bfloat16 scales).  Needs head_dim / pack a multiple
// of 16 bytes, with 16-byte aligned packed pools.
extern "C" int paged_attention_quant_launch(
    int dtype, int tc, int pack, const void* q, void* k_pages, void* v_pages, void* k_scales,
    void* v_scales, const void* tables, const void* lens, void* out, void* o_part,
    void* ml_part, int slots, int heads, int kv_heads, int d, int ps, int max_pages,
    int num_pages, int window, int splits, int split_keys, float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!grid_ok(slots, splits, split_keys, ps, max_pages)) return (int)cudaErrorInvalidValue;
  const Partials part = partials(o_part, ml_part, slots, heads, splits);
  int rc = (int)cudaErrorInvalidValue;
#define PA_QUANT_TC(P)                                                                         \
  rc = launch_tc_any(d, q, quant_pools<__nv_bfloat16, P>(k_pages, v_pages, k_scales, v_scales), \
                     tables, lens, part, slots, kv_heads, ps, max_pages, num_pages, window,    \
                     split_keys, sm_scale, st)
#define PA_QUANT(T, P)                                                                      \
  rc = launch(q, quant_pools<T, P>(k_pages, v_pages, k_scales, v_scales), tables, lens, part, \
              slots, heads, kv_heads, d, ps, max_pages, num_pages, window, split_keys / ps,  \
              sm_scale, st)
  if (tc && dtype == 1 && pack == 1) PA_QUANT_TC(1);
  else if (tc && dtype == 1 && pack == 2) PA_QUANT_TC(2);
  else if (!tc && dtype == 0 && pack == 1) PA_QUANT(float, 1);
  else if (!tc && dtype == 0 && pack == 2) PA_QUANT(float, 2);
  else if (!tc && dtype == 1 && pack == 1) PA_QUANT(__nv_bfloat16, 1);
  else if (!tc && dtype == 1 && pack == 2) PA_QUANT(__nv_bfloat16, 2);
#undef PA_QUANT_TC
#undef PA_QUANT
  return merged(rc, dtype, part, slots, d, out, st);
}
