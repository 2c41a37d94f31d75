// Multi-head latent attention (MLA) chunked prefill over the latent page
// pools, with the chunk's latent and rope page writes done inside the kernel.
//
// Two entry points, one kernel body a path, templated on the latent format:
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
//     1) scale each, of q's dtype), the prior pages are dequantized on their
//     way in, the chunk attends its own dequantized round trip (what later
//     decode steps read back), and the packed bytes and both scales of each
//     chunk page are written into the four pools together.
//
// Scores are q_lat.ckv + q_pe.kpe times the caller's sm_scale; V is the
// latent, the first R columns of the shared [ckv | kpe] tile.
//
// Bound on the H100: operations.  At serving chunk sizes the FLOPs (2 (2R +
// Dpe) a query-key pair, 16 heads a position) outweigh the bytes (the
// chunk's queries and outputs, each latent row read once): at deepseek-v2-
// lite-16B's serving shape (slots 8, chunk 64, 16 heads, R 512, Dpe 64,
// prior contexts up to 960) about 5.5 us of bf16 tensor-core work.
//
// Both paths keep the TPU kernel's rules:
//   * the TPU cell holds a whole chunk page of query rows (page_size * H =
//     256 at full width), chunk-major: row i * H + h, position i past the
//     page's first, head h.  The grid is (row blocks of a chunk page, chunk
//     pages, slots);
//   * prior context: pages [p_lo, ceil(starts / ps)) through the table,
//     ragged on starts plus the banded window.  All blocks of a launch run
//     at once, so the walk stops at ceil(starts / ps) and never reads a page
//     another block of the launch writes (those sit at table index >=
//     starts / ps);
//   * the chunk itself: keys from the ckv / kpe inputs, causal and ragged on
//     lens, never read back through the pages being written;
//   * the first row block of each chunk page writes that page into the pools
//     (exactly one writer a page).  A page with no live token goes to the
//     reserved sink page 0, the table index is clamped to max_pages - 1
//     (mla.py:286-297); several blocks may write page 0 at once, which is
//     harmless because page 0 is never read for a live position.  Whole
//     pages are written, dead rows of a partly live page included, where the
//     plain path sends dead positions to page 0.
//
// Two paths, chosen by the wrapper from dtype and shape alone
// (mla_prefill.py, tensor_core_path):
//   * tensor cores, bf16 at R 512 with R + Dpe a multiple of 64 and pages of
//     1-32 positions (a power of two): mla_mma.cuh's step, the one FlashMLA
//     (mla.cu) runs.  A block holds 64 chunk-major rows (4 positions x 16
//     heads at full width) and 16 warps, so the grid is (4, 4, 8) = 128
//     blocks, one wave on 132 SMs, and each 32-key tile (two pages of 16) is
//     read from device memory once a block, by all 16 heads; scores on
//     mma.sync in four column quarters, the fp32 online softmax, P.V as the
//     pair hi + lo (1.00 bf16 ulp where P rounded once reads tens).  Tiles
//     come through a ring of two stages of cp.async copies, one tile ahead:
//     each key row finds its own page in the slot's table entries (copied
//     into shared memory one tile ahead too, so no copy's address waits on a
//     device-memory read) and writes its absolute position beside the tile,
//     -1 for a dead row, which is zero-filled (0 * NaN never happens); one
//     positional mask (causal, the window) then serves prior and chunk keys.
//     Sixteen threads copy a key row, so each finds the row's page once a
//     tile.  The quantized twin copies a tile's packed bytes into a staging
//     tile (each scale into a register) and dequantizes it into the bf16
//     tile in the step before its own, each value rounded once from code *
//     scale in fp32, bit for bit the plain version's dequantize-then-round
//     (kv_dequant.cuh, the rule the GQA prefill's loader shares);
//     each thread then starts the next tile's copies into the staging bytes
//     it has just read, so they have a whole step to land.  198 KB of
//     shared memory a block (217 KB quantized int8);
//   * CUDA cores, fp32 and every other shape: attention_core.cuh's online
//     softmax in fp32 shared memory.  A block holds rb of a chunk page's
//     rows (32 at full width: fp32 Q, one key tile and the accumulator take
//     179 KB of shared memory), and key tiles of page_size rows are read with
//     16-byte vector loads into registers one tile ahead of the compute.

#include "attention_core.cuh"
#include "kv_dequant.cuh"
#include "mla_mma.cuh"

namespace {

// ---- the CUDA-core path ---------------------------------------------------

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

// ---- the tensor-core path ------------------------------------------------

using bf16 = __nv_bfloat16;

// The block's keys, in tiles of mm::KEYS: the prior positions [p_lo ps,
// min(start, p_hi ps)) through the slot's table, then the chunk's own rows
// [c_lo, c_hi).  Lives in shared memory: the loader reads it once a tile,
// and the registers it would hold go to the accumulator.
struct Walk {
  const int* row;  // the slot's table row
  long chunk0;     // the slot's first row of the chunk inputs
  int ps_log2, p_lo, p_hi, start, len, num_pages, n_prior, c_lo, c_hi;
  int q0, r0, heads, window;  // block row r sits at position q0 + (r0 + r) / heads

  __device__ int tiles() const {
    return n_prior + (c_hi > c_lo ? (c_hi - c_lo + mm::KEYS - 1) / mm::KEYS : 0);
  }
  // Key row r of tile u: its row of the pools (prior) or of the chunk
  // inputs, and its absolute position; false for a dead row.  `tab` holds
  // tile u's table entries.
  __device__ bool key(const int* tab, int u, int r, long& at, bool& prior, int& pos) const {
    if (u < n_prior) {
      const int k = (p_lo << ps_log2) + u * mm::KEYS + r;
      if (k >= start || (k >> ps_log2) >= p_hi) return false;
      const int page = tab[r >> ps_log2];
      if (page < 0 || page >= num_pages) return false;
      at = ((long)page << ps_log2) + (k & ((1 << ps_log2) - 1));
      prior = true;
      pos = k;
      return true;
    }
    const int kj = c_lo + (u - n_prior) * mm::KEYS + r;
    if (kj >= c_hi) return false;
    at = chunk0 + kj;
    prior = false;
    pos = start + kj;
    return true;
  }
};

// Loads tile u of the walk into stage `stage`: rows of [latent | rope], bf16
// copied straight into the tile (PACK 0; Lat = FpLatent) at the top of the
// step before tile u's, or packed int8 (PACK 1) / int4 (PACK 2) bytes
// copied into a staging tile, each row's two scales held in registers
// (Lat = QuantLatent).  The staged tile is dequantized into the bf16 tile
// at the end of the step before its own, after that step's P.V (so one
// warp's conversion overlaps another's products), and each thread then
// starts the next tile's copies into the staging bytes it has just read:
// they have a whole step to land.  Rows of pool and chunk differ only in
// their base.  Sixteen threads a key row: each finds its row's source once
// a tile and copies (and converts) every sixteenth 16-byte vector of it.
template <int PACK, typename Lat>
struct WalkLoad {
  static_assert(mm::KEYS * 16 == mm::THREADS, "sixteen threads a key row");
  const Walk& w;
  const mm::Smem<bf16>& sm;
  Lat pool, fresh;  // the pools and the chunk inputs
  int* tab;         // two slots of mm::KEYS table entries
  int* kpos;        // two slots of mm::KEYS key positions
  float* scl;       // the staged tile's scales: latent, then rope
  int8_t* pk;       // the staged packed tile
  int ks;
  uint32_t s_bits = 0;  // the first two threads of a row: a scale of the tile in flight

  __device__ int latent_bytes() const { return PACK ? mm::D / PACK : mm::D * 2; }
  __device__ int rope_bytes() const { return PACK ? pool.pe / PACK : pool.pe * 2; }

  // Tile u's table entries into slot u % 2 (one copy a page).
  __device__ void entries(int u) const {
    if (u >= w.n_prior) return;
    const int ppt = mm::KEYS >> w.ps_log2, idx = w.p_lo + u * ppt + threadIdx.x;
    if ((int)threadIdx.x < ppt)
      gc::cp_async<4>(tab + (u & 1) * mm::KEYS + threadIdx.x, w.row + (idx < w.p_hi ? idx : 0),
                      idx < w.p_hi);
  }

  __device__ void issue(int u, int stage) {
    if (PACK == 0 || u == 0) copy(u, stage);  // quantized: convert() starts the rest
  }

  __device__ void copy(int u, int stage) {
    entries(u + 1);
    const int r = threadIdx.x >> 4, part = threadIdx.x & 15;
    const int cb = latent_bytes(), pb = rope_bytes();
    long at = 0;
    bool prior = false;
    int pos = -1;
    const bool live = w.key(tab + (u & 1) * mm::KEYS, u, r, at, prior, pos);
    // selects of the two bases (a reference to either struct would put both
    // in local memory)
    const char* lat = reinterpret_cast<const char*>(prior ? pool.ckv : fresh.ckv) + at * cb;
    const char* rope = reinterpret_cast<const char*>(prior ? pool.kpe : fresh.kpe) + at * pb;
    const char* any = reinterpret_cast<const char*>(pool.ckv);
    char* dst = PACK ? reinterpret_cast<char*>(pk) + r * (cb + pb)
                     : reinterpret_cast<char*>(sm.kt(stage) + r * ks);
    for (int v = part * 16; v < cb + pb; v += 256)
      gc::cp_async<16>(dst + v, live ? (v < cb ? lat + v : rope + (v - cb)) : any, live);
    if (part == 0) kpos[stage * mm::KEYS + r] = live ? pos : -1;
    if constexpr (PACK > 0) {
      const bf16* scales = part ? (prior ? pool.rs : fresh.rs) : (prior ? pool.cs : fresh.cs);
      if (part < 2) s_bits = live ? kvq::ldg_u16(scales + at) : 0u;
    }
  }

  __device__ void landed(bool more) {
    if constexpr (PACK > 0) {
      if (!more) return;
      gc::cp_async_wait<0>();
      const int r = threadIdx.x >> 4, part = threadIdx.x & 15;
      if (part < 2)
        scl[part * mm::KEYS + r] = kvq::bf16_bits(s_bits);
    }
  }

  // The staged tile u into stage u % 2, then tile u + 1's copies into the
  // same staging bytes (each thread's own: no barrier between).
  __device__ void convert(int u) {
    if constexpr (PACK > 0) {
      const int r = threadIdx.x >> 4, part = threadIdx.x & 15;
      const int cb = latent_bytes(), pb = rope_bytes();
      const float s_lat = scl[r], s_rope = scl[mm::KEYS + r];
      const int8_t* src = pk + r * (cb + pb);
      bf16* dst = sm.kt(u & 1) + r * ks;
      for (int v = part * 16; v < cb + pb; v += 256) {
        const uint4 x = *reinterpret_cast<const uint4*>(src + v);
        if (v < cb)
          kvq::dequant<PACK>(dst + v * PACK, x, s_lat);
        else
          kvq::dequant<PACK>(dst + mm::D + (v - cb) * PACK, x, s_rope);
      }
      if (u + 1 < w.tiles()) copy(u + 1, (u + 1) & 1);
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

template <int PACK, typename Lat>
__global__ void __launch_bounds__(mm::THREADS, 1)
mla_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q_pe, Lat chunk_kv,
                      Lat pools, const int* __restrict__ tables, const int* __restrict__ starts,
                      const int* __restrict__ lens, bf16* __restrict__ out, int heads, int chunk,
                      int ps, int max_pages, int num_pages, int window, float qscale) {
  const int sub = blockIdx.x;  // row block within the chunk page
  const int bq = blockIdx.y;   // chunk page
  const int b = blockIdx.z;    // slot
  const int dk = mm::D + pools.pe, ks = dk + 8;
  extern __shared__ float4 smem4[];
  const mm::Smem<bf16> sm(smem4, ks);
  int* tab = reinterpret_cast<int*>(sm.end());
  int* kpos = tab + 2 * mm::KEYS;
  float* scl = reinterpret_cast<float*>(kpos + 2 * mm::KEYS);
  int8_t* pk = reinterpret_cast<int8_t*>(scl + 2 * mm::KEYS);
  __shared__ Walk w;

  const int r0 = sub * mm::ROWS, rows = min(mm::ROWS, ps * heads - r0);
  const int i_first = bq * ps;  // first in-chunk position of the chunk page
  if (threadIdx.x == 0) {
    const int start = starts[b], len = lens[b];
    const int i_lo = i_first + r0 / heads, i_hi = i_first + (r0 + rows - 1) / heads;
    const int p_hi = min((start + ps - 1) / ps, max_pages);
    const int p_lo = window > 0 ? max(0, start + i_lo - window + 1) / ps : 0;
    const int n_prior = p_hi > p_lo ? ((p_hi - p_lo) * ps + mm::KEYS - 1) / mm::KEYS : 0;
    w = {tables + (long)b * max_pages, (long)b * chunk, __ffs(ps) - 1, p_lo, p_hi, start, len,
         num_pages, n_prior, window > 0 ? max(0, i_lo - window + 1) : 0, min(i_hi + 1, len),
         start + i_first, r0, heads, window};
  }
  __syncthreads();

  WalkLoad<PACK, Lat> ld{w, sm, pools, chunk_kv, tab, kpos, scl, pk, ks};
  ld.entries(0);
  gc::cp_async_commit();
  // block row r: chunk-major row r0 + r of the chunk page, head (r0 + r) %
  // heads at position i_first + (r0 + r) / heads, in the (B, H, C, .) rows
  auto row_at = [&](int r) {
    const int g = r0 + r;
    return r < rows ? ((long)b * heads + g % heads) * chunk + i_first + g / heads : -1L;
  };
  mm::load_q(sm, ks, q, q_pe, pools.pe, row_at);  // committed with tile 0
  gc::cp_async_wait<0>();  // the entries (Q's copies are not committed yet)
  __syncthreads();
  auto live = [&](int t, int r, int j) {  // causal, and the window, by position
    const int kp = kpos[(t & 1) * mm::KEYS + j], qp = w.q0 + (w.r0 + r) / w.heads;
    return kp >= 0 && kp <= qp && (w.window <= 0 || qp - kp < w.window);
  };
  mm::Acc o;
  mm::attend(sm, o, w.tiles(), dk, ks, ld, live, qscale);
  mm::finish(sm, o);
  mm::store(o, out, row_at);

  // ---- the paged write: the chunk page, by its first row block -----------
  if (sub != 0) return;
  const int tidx = min(w.start / ps + bq, max_pages - 1);
  const int dst = i_first < w.len ? w.row[tidx] : 0;
  if (dst < 0 || dst >= num_pages) return;  // dropped, like XLA's scatter
  chunk_kv.rows(w.chunk0 + i_first).copy_rows(pools.rows((long)dst * ps), ps);
}

// Whether the tensor-core kernel takes these shapes (mla_prefill.py's
// tensor_core_path, plus the grid's limits).
inline bool tc_shapes_ok(int slots, int heads, int chunk, int r, int pe, int ps) {
  return r == mm::D && pe > 0 && (r + pe) % 64 == 0 && ps >= 1 && ps <= mm::KEYS &&
         (ps & (ps - 1)) == 0 && chunk % ps == 0 && heads >= 1 && slots >= 1 &&
         slots <= 65535 && chunk / ps <= 65535;
}

template <int PACK, typename Lat>
int launch_tc(const void* q, const void* q_pe, Lat chunk_kv, Lat pools, const void* tables,
              const void* starts, const void* lens, void* out, int slots, int heads, int chunk,
              int ps, int max_pages, int num_pages, int window, float sm_scale,
              cudaStream_t stream) {
  if (!tc_shapes_ok(slots, heads, chunk, pools.r, pools.pe, ps))
    return (int)cudaErrorInvalidValue;
  const int ks = mm::D + pools.pe + 8;
  // the step's, then table entries, key positions, scales and the staging tile
  const size_t smem = mm::Smem<bf16>::bytes(ks) + sizeof(int) * 6 * mm::KEYS +
                      (PACK ? (size_t)mm::KEYS * (mm::D + pools.pe) / PACK : 0);
  auto kernel = mla_prefill_tc_kernel<PACK, Lat>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((ps * heads + mm::ROWS - 1) / mm::ROWS, chunk / ps, slots);
  kernel<<<grid, mm::THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)q_pe, chunk_kv, pools, (const int*)tables, (const int*)starts,
      (const int*)lens, (bf16*)out, heads, chunk, ps, max_pages, num_pages, window,
      sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// tc 1 takes the tensor-core kernel (bfloat16, R 512 with R + Dpe a
// multiple of 64; rb unused), tc 0 the CUDA-core kernel with rb query rows
// a block, dividing page_size * heads.  Needs chunk % page_size == 0,
// page_size a power of two <= 32, R and Dpe multiples of 16 bytes' worth of
// elements, and 16-byte aligned tensors.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int mla_prefill_launch(
    int dtype, int tc, const void* q, const void* q_pe, void* ckv, void* kpe,
    void* ckv_pages, void* kpe_pages, const void* tables, const void* starts,
    const void* lens, void* out, int slots, int heads, int chunk, int r,
    int pe, int ps, int rb, int max_pages, int num_pages, int window,
    float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    using B = __nv_bfloat16;
    using F = ac::FpLatent<B>;
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_tc<0>(q, q_pe, F{(B*)ckv, (B*)kpe, r, pe},
                        F{(B*)ckv_pages, (B*)kpe_pages, r, pe}, tables, starts, lens, out,
                        slots, heads, chunk, ps, max_pages, num_pages, window, sm_scale, s);
  }
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
// scale pools are of q's dtype; tc as above.  Needs R / pack and Dpe / pack
// multiples of 16 bytes.
extern "C" int mla_prefill_quant_launch(
    int dtype, int tc, int pack, const void* q, const void* q_pe, void* ckv, void* kpe,
    void* ckv_scale, void* kpe_scale, void* ckv_pages, void* kpe_pages,
    void* ckv_scales, void* kpe_scales, const void* tables, const void* starts,
    const void* lens, void* out, int slots, int heads, int chunk, int r,
    int pe, int ps, int rb, int max_pages, int num_pages, int window,
    float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MLA_PF_QUANT_TC(P)                                                                   \
  return launch_tc<P>(q, q_pe, quant_latent<__nv_bfloat16, P>(ckv, kpe, ckv_scale, kpe_scale, \
                                                              r, pe),                        \
                      quant_latent<__nv_bfloat16, P>(ckv_pages, kpe_pages, ckv_scales,       \
                                                     kpe_scales, r, pe),                     \
                      tables, starts, lens, out, slots, heads, chunk, ps, max_pages,         \
                      num_pages, window, sm_scale, s)
  if (tc && dtype == 1 && pack == 1) MLA_PF_QUANT_TC(1);
  if (tc && dtype == 1 && pack == 2) MLA_PF_QUANT_TC(2);
#undef MLA_PF_QUANT_TC
  if (tc) return (int)cudaErrorInvalidValue;
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
