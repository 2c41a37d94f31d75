// Paged multi-head latent attention (MLA) decode: one query token per slot,
// every head attending the slot's shared latent and rope pages.
//
// Two entry points, one design, templated on the latent page format:
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
//     scale, each value rounded once to q's dtype.
//
// The score of head h against key j is q_lat[h].ckv[j] + q_pe[h].kpe[j]
// times the caller's sm_scale (the model passes 1 / sqrt(nope + rope), not
// 1 / sqrt(R + Dpe)), and V is the latent ckv[j] itself: a key row lands
// once in shared memory as [ckv | kpe], scored over all of it and read
// again over its first R columns for P.V.
//
// Bound on the H100: bytes.  A decode step reads each live latent and rope
// row once for all H heads ((R + Dpe) * itemsize bytes a token, plus two
// scales when quantized) and does 2 * H * (2R + Dpe) FLOPs on it, about 30
// FLOPs a byte at full width in bf16, under the card's 295 FLOP/byte ridge.
// At deepseek-v2-lite-16B's serving shape (slots 8, 16 heads, R 512, Dpe
// 64, lengths up to 1024) that is at most 9.4 MB, ~2.8 us at 3.35 TB/s:
// what holds a launch back is latency, not bytes.
//
// Design: split-KV over a static grid, then a merge (split_merge.cuh, the
// GQA decode's).
//   * The TPU grid (head block, slot) would give 8 blocks at the serving
//     shape on the H100's 132 SMs, each walking its slot's pages one after
//     another.  Here the grid is (head block, slot, split): split s of a
//     slot scores its keys [s * split_keys, (s + 1) * split_keys) that are
//     live (inside [max(0, len - window), len)) for all of the head block's
//     heads, so each latent row is still read once a slot, and leaves the
//     rows' partial softmax states in fp32 scratch (O unnormalised, m, l); a
//     second launch merges them.
//     splits and split_keys come from static shapes and the SM count only
//     (paged_attention.py, decode_splits), never from the lengths: 16 splits
//     of 64 keys at the serving shape, 128 blocks.  A split with no live key
//     reads nothing and is weighed 0; a slot of length 0 emits zeros.
//   * bf16 at R 512 with R + Dpe a multiple of 64 (the tensor-core path):
//     each split block runs mla_mma.cuh's step, FlashMLA's, with the head
//     block as its 16 query rows: 4 warps, one a column quarter, over 32-key
//     tiles double-buffered by cp.async; scores on mma.sync, the fp32 online
//     softmax, P.V as the bf16 pair hi + lo, V read by ldmatrix.trans.  Four
//     threads copy a key row: each finds the row's page through the slot's
//     table once a tile and writes whether the row is live beside the tile;
//     a dead row is zero-filled and masked (padding pages may hold NaN).
//     The quantized twin copies a tile's packed bytes into a staging tile
//     (each scale into a register) and dequantizes it into the bf16 tile in
//     the step before its own (kv_dequant.cuh, mla_prefill.cu's rule); each
//     thread then starts the next tile's copies into the staging bytes it
//     has just read.  Shared memory: 103 KB a block (121 KB in int8).
//   * fp32, and bf16 at other widths: attention_core.cuh's CUDA-core online
//     softmax in fp32 shared memory over the split's pages (16-byte vector
//     loads one page ahead of the compute), up to 16 heads a block, on the
//     same split grid and the same merge.
//
// What still holds it back (H100 80GB HBM3 at 700 W, the serving shape: 18.5
// us a bf16 call, 19.8 in int8, against ~1.6 us of bytes): two launches a
// decode step, the split kernel 9.7 us (10.7 in int8) and the merge 4.0 us
// of device time (chip_smoke.py's MLA decode-cost reading).  A split block
// walks two tiles, so its time is latency: the table entry, then the first
// tile's copies, then two dependent steps of three barriers each on 4
// warps, then 32 KB of partial state out.

#include "attention_core.cuh"
#include "kv_dequant.cuh"
#include "mla_mma.cuh"
#include "split_merge.cuh"

namespace {

using sk::Partials;
using bf16 = __nv_bfloat16;

// ---- the CUDA-core body (fp32, other widths) ------------------------------

constexpr int kThreads = 256;

struct DecodeMask {
  int base, len, lo;
  __device__ bool operator()(int /*r*/, int j) const {
    const int pos = base + j;
    return pos < len && pos >= lo;
  }
};

// The split's live pages, read through the slot's block-table row.
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

// Block (head block, slot, split): the split's pages [s * split_pages, (s +
// 1) * split_pages) that hold live keys.
template <typename F>
__global__ void __launch_bounds__(kThreads)
mla_paged_kernel(const typename F::Elem* __restrict__ q,
                 const typename F::Elem* __restrict__ q_pe, F pools,
                 const int* __restrict__ tables, const int* __restrict__ lens,
                 Partials part, int bh, int ps, int max_pages, int num_pages,
                 int window, int split_pages, float qscale) {
  const int hb = blockIdx.x;  // head block
  const int b = blockIdx.y;   // slot
  const int s = blockIdx.z;   // split
  const int r = pools.r, dk = pools.r + pools.pe;
  const int len = lens[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_lo = max(lo / ps, s * split_pages);
  const int p_hi = min(min((len + ps - 1) / ps, max_pages), (s + 1) * split_pages);
  if (p_hi <= p_lo) {
    part.empty(b, hb * bh, bh, s);
    return;
  }
  extern __shared__ float4 smem4[];  // one declaration for both kernels of the file
  ac::Smem sm(reinterpret_cast<float*>(smem4), bh, ps, dk, r);

  const HeadRows rows{(long)b * part.heads + (long)hb * bh};
  ac::load_latent_rows(sm, q, q_pe, bh, r, pools.pe, qscale, rows);
  ac::init_state(sm, bh, r);

  LatentPages<F> src{pools, tables + (long)b * max_pages, p_lo, ps, num_pages,
                     len, lo};
  ac::attend_tiles(sm, bh, ps, dk, r, p_hi - p_lo, src);
  __syncthreads();
  part.store(sm, b, hb * bh, bh, s, r);
}

template <typename F>
int launch(const void* q, const void* q_pe, F pools, const void* tables,
           const void* lens, Partials part, int slots, int bh, int ps,
           int max_pages, int num_pages, int window, int split_keys,
           float sm_scale, cudaStream_t stream) {
  using T = typename F::Elem;
  if (bh < 1 || part.heads % bh != 0 || !F::shapes_ok(ps, pools.r, pools.pe, kThreads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ac::Smem::latent_bytes(bh, ps, pools.r + pools.pe, pools.r);
  auto kernel = mla_paged_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(part.heads / bh, slots, part.splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)q_pe, pools, (const int*)tables, (const int*)lens,
      part, bh, ps, max_pages, num_pages, window, split_keys / ps,
      sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// ---- the tensor-core body (bf16, R 512) -----------------------------------

constexpr int kRows = 16;  // a head block's rows: one m-tile
constexpr int kTcThreads = mm::threads(kRows);
constexpr int kPerRow = kTcThreads / mm::KEYS;  // threads copying a key row
static_assert(kPerRow >= 2, "the first two threads of a key row load its scales");

// The split's keys in 32-key tiles: key j = (t0 + t) KEYS + r of tile t lies
// on table entry j / ps at page row j % ps, and is read when it is live (lo
// <= j < keys) and its page lies in the pool.
struct SplitKeys {
  const int* table;  // the slot's block-table row
  int ps_log2, t0, lo, keys, num_pages;

  __device__ bool row(int t, int r, long& at) const {
    const int j = (t0 + t) * mm::KEYS + r;
    if (j < lo || j >= keys) return false;
    const int page = table[j >> ps_log2];
    if (page < 0 || page >= num_pages) return false;  // contributes nothing
    at = ((long)page << ps_log2) + (j & ((1 << ps_log2) - 1));
    return true;
  }
};

// Loads tile u of the split into stage `stage`: rows of [latent | rope],
// bf16 copied straight into the tile (PACK 0; Lat = FpLatent) at the top of
// the step before tile u's, or packed int8 (PACK 1) / int4 (PACK 2) bytes
// copied into a staging tile, each row's two scales held in registers (Lat
// = QuantLatent), and dequantized into the bf16 tile after the step
// before's P.V; each thread then starts the next tile's copies into the
// staging bytes it has just read (mla_prefill.cu's WalkLoad, over one
// pool).  Each row's liveness goes beside its stage for the mask.
template <int PACK, typename Lat>
struct SplitLoad {
  const mm::Smem<bf16, kRows>& sm;
  Lat pool;
  SplitKeys keys;
  int* live;   // two slots of KEYS flags
  float* scl;  // the staged tile's scales: latent, then rope
  int8_t* pk;  // the staged packed tile
  int ks, n;
  uint32_t s_bits = 0;  // the first two threads of a row: a scale of the tile in flight

  __device__ int latent_bytes() const { return PACK ? mm::D / PACK : mm::D * 2; }
  __device__ int rope_bytes() const { return PACK ? pool.pe / PACK : pool.pe * 2; }

  __device__ void issue(int u, int stage) {
    if (PACK == 0 || u == 0) copy(u, stage);  // quantized: convert() starts the rest
  }

  __device__ void copy(int u, int stage) {
    const int r = threadIdx.x / kPerRow, part = threadIdx.x % kPerRow;
    const int cb = latent_bytes(), pb = rope_bytes();
    long at = 0;
    const bool ok = keys.row(u, r, at);
    const char* lat = reinterpret_cast<const char*>(pool.ckv) + at * cb;
    const char* rope = reinterpret_cast<const char*>(pool.kpe) + at * pb;
    const char* any = reinterpret_cast<const char*>(pool.ckv);
    char* dst = PACK ? reinterpret_cast<char*>(pk) + r * (cb + pb)
                     : reinterpret_cast<char*>(sm.kt(stage) + r * ks);
    for (int v = part * 16; v < cb + pb; v += 16 * kPerRow)
      gc::cp_async<16>(dst + v, ok ? (v < cb ? lat + v : rope + (v - cb)) : any, ok);
    if (part == 0) live[stage * mm::KEYS + r] = ok;
    if constexpr (PACK > 0) {
      const bf16* scales = part ? pool.rs : pool.cs;
      if (part < 2) s_bits = ok ? kvq::ldg_u16(scales + at) : 0u;
    }
  }

  __device__ void landed(bool more) {
    if constexpr (PACK > 0) {
      if (!more) return;
      gc::cp_async_wait<0>();
      const int r = threadIdx.x / kPerRow, part = threadIdx.x % kPerRow;
      if (part < 2) scl[part * mm::KEYS + r] = kvq::bf16_bits(s_bits);
    }
  }

  // The staged tile u into stage u % 2, then tile u + 1's copies into the
  // same staging bytes (each thread's own: no barrier between).
  __device__ void convert(int u) {
    if constexpr (PACK > 0) {
      const int r = threadIdx.x / kPerRow, part = threadIdx.x % kPerRow;
      const int cb = latent_bytes(), pb = rope_bytes();
      const float s_lat = scl[r], s_rope = scl[mm::KEYS + r];
      const int8_t* src = pk + r * (cb + pb);
      bf16* dst = sm.kt(u & 1) + r * ks;
      for (int v = part * 16; v < cb + pb; v += 16 * kPerRow) {
        const uint4 x = *reinterpret_cast<const uint4*>(src + v);
        if (v < cb)
          kvq::dequant<PACK>(dst + v * PACK, x, s_lat);
        else
          kvq::dequant<PACK>(dst + mm::D + (v - cb) * PACK, x, s_rope);
      }
      if (u + 1 < n) copy(u + 1, (u + 1) & 1);
    }
  }

  __device__ void first() {
    if constexpr (PACK > 0) {
      landed(true);
      __syncthreads();
      convert(0);
    }
  }
};

// Block (head block, slot, split): block row r < bh is head hb * bh + r of
// the slot; the split's tiles [s * split_tiles, (s + 1) * split_tiles) that
// hold live keys.
template <int PACK, typename Lat>
__global__ void __launch_bounds__(kTcThreads)
mla_paged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q_pe, Lat pools,
                    const int* __restrict__ tables, const int* __restrict__ lens,
                    Partials part, int bh, int ps, int max_pages, int num_pages, int window,
                    int split_tiles, float qscale) {
  const int hb = blockIdx.x;  // head block
  const int b = blockIdx.y;   // slot
  const int s = blockIdx.z;   // split
  const int len = lens[b];
  const int keys = min(len, max_pages * ps);  // a length past the table reads no more
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int t_lo = max(lo / mm::KEYS, s * split_tiles);
  const int t_hi = min((keys + mm::KEYS - 1) / mm::KEYS, (s + 1) * split_tiles);
  if (t_hi <= t_lo) {
    part.empty(b, hb * bh, bh, s);
    return;
  }
  const int dk = mm::D + pools.pe, ks = dk + 8;
  extern __shared__ float4 smem4[];
  const mm::Smem<bf16, kRows> sm(smem4, ks);
  int* live = reinterpret_cast<int*>(sm.end());
  float* scl = reinterpret_cast<float*>(live + 2 * mm::KEYS);
  int8_t* pk = reinterpret_cast<int8_t*>(scl + 2 * mm::KEYS);

  const long h0 = (long)hb * bh;
  auto row_at = [&](int r) { return r < bh ? (long)b * part.heads + h0 + r : -1L; };
  mm::load_q(sm, ks, q, q_pe, pools.pe, row_at);  // committed with tile 0
  SplitLoad<PACK, Lat> ld{sm,
                          pools,
                          {tables + (long)b * max_pages, __ffs(ps) - 1, t_lo, lo, keys,
                           num_pages},
                          live,
                          scl,
                          pk,
                          ks,
                          t_hi - t_lo};
  mm::Acc o;
  mm::attend(sm, o, t_hi - t_lo, dk, ks, ld,
             [&](int t, int, int j) { return live[(t & 1) * mm::KEYS + j] != 0; }, qscale);
  // the partial state: O unnormalised, m clamped, l (final since the last
  // tile's softmax barrier)
  mm::store<kRows>(o, part.o, [&](int r) { return r < bh ? part.row(b, h0 + r, s) : -1L; });
  for (int r = threadIdx.x; r < bh; r += kTcThreads) {
    part.m[part.row(b, h0 + r, s)] = fmaxf(sm.m[r], ac::NEG_CLAMP);
    part.l[part.row(b, h0 + r, s)] = sm.l[r];
  }
}

// Whether the tensor-core kernel takes these shapes (mla_paged.py's
// tensor_core_path; a head block fits its 16 rows).
inline bool tc_shapes_ok(int r, int pe, int bh, int ps) {
  return r == mm::D && pe > 0 && (r + pe) % 64 == 0 && bh >= 1 && bh <= kRows && ps >= 1 &&
         ps <= mm::KEYS;
}

template <int PACK, typename Lat>
int launch_tc(const void* q, const void* q_pe, Lat pools, const void* tables, const void* lens,
              Partials part, int slots, int bh, int ps, int max_pages, int num_pages,
              int window, int split_keys, float sm_scale, cudaStream_t stream) {
  if (!tc_shapes_ok(pools.r, pools.pe, bh, ps) || part.heads % bh != 0)
    return (int)cudaErrorInvalidValue;
  const int ks = mm::D + pools.pe + 8;
  // the step's, then the live flags, the scales and the staging tile
  const size_t smem = mm::Smem<bf16, kRows>::bytes(ks) + sizeof(int) * 4 * mm::KEYS +
                      (PACK ? (size_t)mm::KEYS * (mm::D + pools.pe) / PACK : 0);
  auto kernel = mla_paged_tc_kernel<PACK, Lat>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(part.heads / bh, slots, part.splits);
  kernel<<<grid, kTcThreads, smem, stream>>>((const bf16*)q, (const bf16*)q_pe, pools,
                                             (const int*)tables, (const int*)lens, part, bh,
                                             ps, max_pages, num_pages, window,
                                             split_keys / mm::KEYS, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int PACK>
ac::QuantLatent<T, PACK> quant_pools(void* ckv, void* kpe, void* cs, void* rs,
                                     int r, int pe) {
  return {(int8_t*)ckv, (int8_t*)kpe, (T*)cs, (T*)rs, r, pe};
}

// The grid's rules (both entry points): split_keys a multiple of the 32-key
// tile and of the page, splits * split_keys covering the table.
inline bool grid_ok(int slots, int splits, int split_keys, int ps, int max_pages) {
  return slots >= 1 && slots <= 65535 && splits >= 1 && splits <= 65535 && ps >= 1 &&
         ps <= mm::KEYS && (ps & (ps - 1)) == 0 && split_keys >= mm::KEYS &&
         split_keys % mm::KEYS == 0 && (long)splits * split_keys >= (long)max_pages * ps;
}

Partials partials(void* o_part, void* ml_part, int slots, int heads, int splits) {
  const long rows = (long)slots * heads * splits;
  return {(float*)o_part, (float*)ml_part, (float*)ml_part + rows, heads, splits};
}

template <typename T>
int merged(int rc, const Partials& part, int slots, int r, void* out, cudaStream_t s) {
  return rc != 0 ? rc : sk::merge<T>(part, slots, r, out, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// tc 1 takes the tensor-core body (bfloat16, R 512 with R + Dpe a multiple
// of 64, bh <= 16), tc 0 the CUDA-core body.  bh query heads share a block
// (it must divide heads).  The grid is (heads / bh, slots, splits), split s
// covering keys [s * split_keys, (s + 1) * split_keys): split_keys a
// multiple of 32 and of page_size, splits * split_keys >= max_pages *
// page_size.  o_part (slots, heads, splits, R) and ml_part (2, slots,
// heads, splits) are fp32 scratch: the partial states, then merged into
// out.  Needs page_size a power of two <= 32, R and Dpe multiples of 16
// bytes' worth of elements, and 16-byte aligned pools.  Returns the first
// cudaGetLastError() after the two launches (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int mla_paged_launch(int dtype, int tc, const void* q, const void* q_pe,
                                void* ckv_pages, void* kpe_pages, const void* tables,
                                const void* lens, void* out, void* o_part, void* ml_part,
                                int slots, int heads, int bh, int r, int pe, int ps,
                                int max_pages, int num_pages, int window, int splits,
                                int split_keys, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!grid_ok(slots, splits, split_keys, ps, max_pages)) return (int)cudaErrorInvalidValue;
  const Partials part = partials(o_part, ml_part, slots, heads, splits);
  if (tc && dtype == 1) {
    const ac::FpLatent<bf16> pools{(bf16*)ckv_pages, (bf16*)kpe_pages, r, pe};
    return merged<bf16>(launch_tc<0>(q, q_pe, pools, tables, lens, part, slots, bh, ps,
                                     max_pages, num_pages, window, split_keys, sm_scale, s),
                        part, slots, r, out, s);
  }
  if (!tc && dtype == 0)
    return merged<float>(launch(q, q_pe, ac::FpLatent<float>{(float*)ckv_pages,
                                                             (float*)kpe_pages, r, pe},
                                tables, lens, part, slots, bh, ps, max_pages, num_pages,
                                window, split_keys, sm_scale, s),
                         part, slots, r, out, s);
  if (!tc && dtype == 1)
    return merged<bf16>(launch(q, q_pe, ac::FpLatent<bf16>{(bf16*)ckv_pages,
                                                           (bf16*)kpe_pages, r, pe},
                               tables, lens, part, slots, bh, ps, max_pages, num_pages,
                               window, split_keys, sm_scale, s),
                        part, slots, r, out, s);
  return (int)cudaErrorInvalidValue;
}

// The quantized twin: pack 1 = int8, 2 = int4; the scale pools are of q's
// dtype; tc, the grid and the scratch as above.  Needs R / pack and Dpe /
// pack multiples of 16 bytes.
extern "C" int mla_paged_quant_launch(
    int dtype, int tc, int pack, const void* q, const void* q_pe, void* ckv_pages,
    void* kpe_pages, void* ckv_scales, void* kpe_scales, const void* tables, const void* lens,
    void* out, void* o_part, void* ml_part, int slots, int heads, int bh, int r, int pe, int ps,
    int max_pages, int num_pages, int window, int splits, int split_keys, float sm_scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!grid_ok(slots, splits, split_keys, ps, max_pages)) return (int)cudaErrorInvalidValue;
  const Partials part = partials(o_part, ml_part, slots, heads, splits);
#define MLA_QUANT_TC(P)                                                                      \
  return merged<bf16>(                                                                       \
      launch_tc<P>(q, q_pe, quant_pools<bf16, P>(ckv_pages, kpe_pages, ckv_scales, kpe_scales, \
                                                 r, pe),                                     \
                   tables, lens, part, slots, bh, ps, max_pages, num_pages, window,          \
                   split_keys, sm_scale, s),                                                 \
      part, slots, r, out, s)
  if (tc && dtype == 1 && pack == 1) MLA_QUANT_TC(1);
  if (tc && dtype == 1 && pack == 2) MLA_QUANT_TC(2);
#undef MLA_QUANT_TC
  if (tc) return (int)cudaErrorInvalidValue;
#define MLA_QUANT(T, P)                                                                     \
  return merged<T>(launch(q, q_pe,                                                          \
                          quant_pools<T, P>(ckv_pages, kpe_pages, ckv_scales, kpe_scales, r, \
                                            pe),                                            \
                          tables, lens, part, slots, bh, ps, max_pages, num_pages, window,  \
                          split_keys, sm_scale, s),                                         \
                   part, slots, r, out, s)
  if (dtype == 0 && pack == 1) MLA_QUANT(float, 1);
  if (dtype == 0 && pack == 2) MLA_QUANT(float, 2);
  if (dtype == 1 && pack == 1) MLA_QUANT(bf16, 1);
  if (dtype == 1 && pack == 2) MLA_QUANT(bf16, 2);
#undef MLA_QUANT
  return (int)cudaErrorInvalidValue;
}
