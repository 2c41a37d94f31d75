// Chunked-prefill attention over a paged KV pool, with the chunk's K/V page
// writes done inside the kernel.
//
// Two entry points:
//   * prefill_attention_launch replaces the TPU kernel
//     repro/kernels/prefill_attention.py:44 (prefill_attention_program):
//     q (B, Hq, C, D) and out (B, Hq, C, D) on the tensor-core path, read
//     and written through their strides (the prefill layer's transposed
//     views cost no copy), or packed chunk-major with their GQA group on
//     the CUDA-core path ((B, Hkv, C * G, D), row = i * G + g); k / v (B,
//     Hkv, C, D) the chunk's own keys and values, k_pages / v_pages (Hkv,
//     P, ps, D) updated in place, tables (B, max_pages), starts (B,) prior
//     tokens (page-aligned for a live slot), lens (B,) live tokens in the
//     chunk;
//   * prefill_attention_quant_launch replaces
//     repro/kernels/prefill_attention.py:157
//     (prefill_attention_quant_program): the chunk arrives quantized
//     (k / v (B, Hkv, C, D / pack) int8 plus scales (B, Hkv, C, 1) of q's
//     dtype), prior pages are dequantized page by page, the chunk attends
//     its own dequantized round trip (what later decode steps read back),
//     and the packed bytes and scales of each chunk page are written into
//     the four pools, bytes and scales of the same rows together.  Its
//     bf16 launches at the fp kernel's tensor-core shapes take the same
//     tensor-core walk with another loader (below); the rest keep the
//     CUDA-core body.
//
// Bound on the H100: bytes at serving batch sizes.  Each block reads its
// slot's prior pages (2 * Hkv * starts * D * itemsize bytes per slot, read
// once per chunk page), the chunk's Q/K/V, and writes the output plus the
// chunk's K/V pages; its FLOPs (4 * D per query-key pair) outweigh those
// bytes only for long prior contexts.
//
// Grid (kv_head * hs, chunk_page, slot), as the TPU grid where hs is 1.  A
// block holds page_size * G / hs query rows (96 for qwen2-1.5B), one chunk
// page of positions for its part of the GQA group, so every K/V tile it
// loads serves G / hs heads.  hs (the wrapper's head_split) is the fewest
// parts, dividing G, whose rows fit a block: 128 rows on the tensor cores,
// 227 KB of shared memory on the CUDA cores.  A group of 16 at page 16
// (chatglm3-6b) is 256 rows: two blocks of 8 heads, of which the first
// alone writes the chunk's pages.
//
// The fp kernel has two paths, chosen by the wrapper from dtype and shape
// alone (prefill_attention.py, tensor_core_path):
//   * tensor cores, bf16 at D 64 or 128 with 64 % ps == 0 (ps * G / hs <= 128):
//     the online softmax of attention_mma.cuh, P.V as the bf16 pair hi + lo
//     (1.00 bf16 ulp on the card; P rounded once would read 122).  The
//     block's rows sit in warps of 16 (ps * G not a multiple of 16 pads its
//     last warp with dead rows: block row r is query head h * G + r % G at
//     chunk position bq * ps + r / G).  Keys come in tiles of 64: first the
//     prior pages (64 / ps of them a tile), gathered by cp.async from each
//     page's contiguous rows through the slot's table entries, which the
//     block first copies into shared memory (a copy's address then waits on
//     no device-memory read); then the chunk's own keys.  Two stages.  At
//     qwen2-1.5B's serving shapes the grid is 64 blocks on 132 SMs and each
//     block walks its slot's prior tiles one after another, so the longest
//     slot's walk, not the grid, sets the time: the block splits that walk
//     between two key groups of 6 warps (384 threads, every other tile
//     each), merged through shared memory at the end.  Shared memory 137
//     KB a block plus 4 bytes a table entry, one block an SM; two key
//     groups leave 168 registers a thread, and the D 128 instance spills a few words (the
//     walk's own fields already live in shared memory).  Split-KV across
//     blocks, which would use the idle SMs, comes with the decode kernel's.
//     The quantized twin's tensor-core path (same rule, int8 and int4)
//     walks the same tiles, but its loader copies each tile's packed bytes
//     by cp.async into a staging area (one thread a K or V row of the
//     step's tiles, its scale copied beside) and
//     dequantizes them into the ring's bf16 tile, code * scale in fp32
//     rounded once (kv_dequant.cuh, the MLA prefill's rule: bit for bit the
//     plain version's dequantize-then-round); the chunk's own keys go
//     through the same staging, since the chunk attends its own
//     dequantized round trip.  Each thread converts the next step's rows
//     after its share of the current step and then starts the step after's
//     copies into the bytes it has just read, so they have a whole step to
//     land.  Staging is 256 rows of D / pack + 16 bytes, with a scale
//     word and a key position each, at two key groups (38 KB at int8, D
//     128: 176 KB a block with the ring and qwen2-1.5B's table row).
//   * CUDA cores, fp32 and any other shape: the body shared with the
//     quantized twin, attention_core.cuh's online softmax in fp32 shared
//     memory over page-sized tiles, each read with 16-byte vector loads one
//     tile ahead of the compute; the resident Q block plus the fp32
//     accumulator take about 120 KB of shared memory at D = 128.
//
// Both follow the same rules:
//   * prior context: pages [lo, ceil(starts / ps)) read through the table,
//     ragged on starts plus the banded window when set; a page index out of
//     range contributes nothing.  The TPU grid ran in order; here all
//     blocks of a launch run concurrently, so the walk stops at ceil(starts
//     / ps) and never reads a page that another block of the same launch is
//     writing (those sit at table index >= starts / ps);
//   * the chunk itself: keys from the k / v inputs, causal and ragged on
//     lens, never read back through the pages being written;
//   * the block then writes its own chunk page into the pools.  A page with
//     no live token (an idle lens == 0 slot, the dead tail of a partial final
//     chunk) goes to the reserved sink page 0, and the table index is
//     clamped to max_pages - 1 (prefill_attention.py:142-152).  Several
//     blocks may write page 0 at once, which is harmless because page 0 is
//     never read for a live position; the pools must start zeroed so that it
//     holds finite values.  The kernel writes whole pages, dead rows of a
//     partly live page included, where the plain path sends dead positions
//     to page 0: pool bytes past lens differ between the two paths.

#include "attention_core.cuh"
#include "attention_mma.cuh"
#include "kv_dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on the H100

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
                         int group, int hs, int chunk, int d, int ps, int max_pages,
                         int num_pages, int window, float qscale) {
  const int h = blockIdx.x / hs;     // kv head
  const int part = blockIdx.x % hs;  // which part of its GQA group
  const int bq = blockIdx.y;         // chunk page
  const int b = blockIdx.z;          // slot
  const int rows = ps * group;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), rows, ps, d);

  const int start = starts[b];
  const int len = lens[b];
  const long bh = (long)b * kv_heads + h;
  const long q_off = (((long)b * kv_heads * hs + blockIdx.x) * chunk * group + (long)bq * rows) * d;
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
  // (by the group's first part alone: every part holds the same K/V rows)
  const bool live_page = i_lo < len;
  const int tidx = min(start / ps + bq, max_pages - 1);
  const int dst = live_page ? row[tidx] : 0;
  if (part != 0 || dst < 0 || dst >= num_pages) return;  // dropped, like XLA's scatter
  own_rows.rows(i_lo, d).copy_rows(head.rows((long)dst * ps, d), ps, d);
}

template <typename F>
int launch(const void* q, F chunk_kv, F pools, const void* tables,
           const void* starts, const void* lens, void* out, int slots,
           int kv_heads, int group, int hs, int chunk, int d, int ps, int max_pages,
           int num_pages, int window, float sm_scale, cudaStream_t stream) {
  using T = typename F::Elem;
  const size_t smem = ac::Smem::bytes(ps * group, ps, d);
  if (chunk % ps != 0 || !F::shapes_ok(ps, d, kThreads) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = prefill_attention_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads * hs, chunk / ps, slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, chunk_kv, pools, (const int*)tables, (const int*)starts,
      (const int*)lens, (T*)out, kv_heads, group, hs, chunk, d, ps, max_pages,
      num_pages, window, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// ---- the tensor-core path (bf16) ------------------------------------------

using am::bf16;

// The block's keys in tiles of am::KEYS, whatever their format: first the
// slot's prior pages [p_lo, p_hi) through its table entries (am::KEYS / ps
// pages a tile, copied into shared memory first, so that a copy's address
// waits on no device-memory read), then the chunk's own keys [c_lo, c_hi)
// from the chunk inputs.  Lives in shared memory: the loader reads it once a
// tile, and the registers its fields would hold go to the softmax state.
struct PrefillWalk {
  const int* pages;  // table entries p_lo.., -1 where out of range
  int ps_log2, p_lo, p_hi, start, c_lo, c_hi, n_prior, live_rows;

  // Key row r of tile t: its row in the kv head's pools (prior) or in the
  // chunk's rows, and its absolute position; false for a dead row.
  // PrefillKeys::row walks the same rule with its row pointers set in each
  // branch: taking them from these out-parameters cost the bf16 instance
  // at D 128 spilled bytes and ~5% of its time on the card.
  __device__ bool key(int t, int r, bool& prior, long& at, int& pos) const {
    if (t < n_prior) {
      const int j = t * am::KEYS + r;
      const int slot = p_lo + (j >> ps_log2), off = j & ((1 << ps_log2) - 1);
      if (slot >= p_hi) return false;  // never read a page this launch writes
      const int page = pages[slot - p_lo];
      if (page < 0) return false;  // contributes nothing
      prior = true;
      at = (long)(page << ps_log2) + off;
      pos = (slot << ps_log2) + off;
      return pos < start;
    }
    const int kj = c_lo + (t - n_prior) * am::KEYS + r;
    if (kj >= c_hi) return false;
    prior = false;
    at = kj;
    pos = start + kj;
    return true;
  }
  __device__ int kind(int /*t*/, int r0, int /*r1*/) const {  // a warp of rows [r0, r1)
    return r0 < live_rows ? am::MASKED : am::SKIP;
  }
};

// bf16 keys, copied by cp.async straight into the ring.
struct PrefillKeys : PrefillWalk {
  const bf16 *kpool, *vpool;  // the kv head's pools, at page 0
  const bf16 *kc, *vc;        // the (slot, kv head)'s chunk rows
  int d;

  __device__ bool row(int t, int r, const bf16*& kp, const bf16*& vp, int& pos) const {
    if (t < n_prior) {
      const int j = t * am::KEYS + r;
      const int slot = p_lo + (j >> ps_log2), off = j & ((1 << ps_log2) - 1);
      if (slot >= p_hi) return false;  // never read a page this launch writes
      const int page = pages[slot - p_lo];
      if (page < 0) return false;  // contributes nothing
      const long at = ((long)(page << ps_log2) + off) * d;
      kp = kpool + at;
      vp = vpool + at;
      pos = (slot << ps_log2) + off;
      return pos < start;
    }
    const int kj = c_lo + (t - n_prior) * am::KEYS + r;
    if (kj >= c_hi) return false;
    kp = kc + (long)kj * d;
    vp = vc + (long)kj * d;
    pos = start + kj;
    return true;
  }
};

// Quantized keys: rows of D / PACK packed bytes and a bf16 scale each, and
// the loader's staging area (its fields too live in shared memory, not in
// registers beside the softmax state).
template <int D, int PACK>
struct QuantKeys : PrefillWalk {
  const int8_t *kpool, *vpool, *kc, *vc;  // packed rows: pools at page 0, chunk
  const bf16 *kspool, *vspool, *ksc, *vsc;  // their scales
  int8_t* stage;  // QuantLoad's staging area
  int n;          // tiles of the walk
};

// The quantized keys' loader, a staged source of am::attend: a step's KG
// tiles of packed K and V rows go by cp.async into a staging area of their
// own, each row's scale beside them (the aligned 4 bytes that hold it, and
// which half it is), and are dequantized into the ring's bf16 tiles
// (kv_dequant.cuh: code * scale in fp32, rounded once, bit for bit the
// plain version's).  One thread a job, a (tile of the step, key row, K or
// V): it copies the row and its scale and notes the key's position, then
// converts the row and, for K, writes the position beside the tile.
// Nothing of a job stays in registers between its copy and its conversion
// (the tile's softmax state holds them all).  Staging rows are padded by 16 bytes, so the rows of a warp's
// copies and loads fall on distinct banks.
template <int D, int PACK, int KG>
struct QuantLoad {
  static constexpr bool STAGED = true;
  static constexpr int BYTES = D / PACK;  // packed bytes a row
  static constexpr int ROW = BYTES + 16;  // staging bytes between rows
  static constexpr int JOBS = KG * am::KEYS * 2;
  // the rows, then a job's scale word, key position and scale half
  __host__ __device__ static constexpr size_t bytes() { return (size_t)JOBS * (ROW + 4 + 4 + 1); }
  const QuantKeys<D, PACK>& w;  // w.stage: JOBS rows of ROW bytes, then JOBS each of the rest

  __device__ uint32_t* words() const { return reinterpret_cast<uint32_t*>(w.stage + JOBS * ROW); }
  __device__ int* positions() const { return reinterpret_cast<int*>(words() + JOBS); }
  __device__ uint8_t* halves() const { return reinterpret_cast<uint8_t*>(positions() + JOBS); }
  __device__ int kind(int t, int r0, int r1) const { return w.kind(t, r0, r1); }

  // Start step u's copies: job j = tile j / (2 KEYS) of the step, key row
  // (j / 2) % KEYS, K for even j and V for odd.  A dead row is zero-filled,
  // its scale too.
  __device__ void copy(int u, const void* any) const {
    for (int j = threadIdx.x; j < JOBS; j += blockDim.x) {
      const int t = u * KG + j / (2 * am::KEYS);
      if (t >= w.n) continue;
      const int kv = j & 1, r = (j >> 1) % am::KEYS;
      bool prior = false;
      long at = 0;
      int pos = -1;
      const bool live = w.key(t, r, prior, at, pos);
      const int8_t* src = (kv ? (prior ? w.vpool : w.vc) : (prior ? w.kpool : w.kc)) + at * BYTES;
      int8_t* dst = w.stage + j * ROW;
#pragma unroll
      for (int c = 0; c < BYTES; c += 16) gc::cp_async<16>(dst + c, live ? src + c : any, live);
      const bf16* scale = (kv ? (prior ? w.vspool : w.vsc) : (prior ? w.kspool : w.ksc)) + at;
      const size_t addr = reinterpret_cast<size_t>(scale);
      gc::cp_async<4>(words() + j, live ? reinterpret_cast<const void*>(addr & ~(size_t)3) : any,
                      live);
      // this thread's own slots: read by its convert only
      positions()[j] = live ? pos : -1;
      halves()[j] = (addr >> 1) & 1;
    }
  }

  // Dequantize step u's staged rows into stage u % 2, each thread its own
  // jobs' bytes (landed: the caller waited for its copies).
  __device__ void convert(const am::Ring<D, D, 2, KG>& ring, int u) const {
    for (int j = threadIdx.x; j < JOBS; j += blockDim.x) {
      const int g = j / (2 * am::KEYS), t = u * KG + g;
      if (t >= w.n) continue;
      const int kv = j & 1, r = (j >> 1) % am::KEYS, slot = (u & 1) * KG + g;
      const uint32_t word = words()[j];
      const float scale = kvq::bf16_bits(halves()[j] ? word >> 16 : word);
      const int8_t* src = w.stage + j * ROW;
      using R = am::Ring<D, D, 2, KG>;
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

// One block: chunk page bq of slot b for part `part` of kv head h's GQA
// group (`group` here counts the part's heads), block row r = query head
// (h * hs + part) * group + r % group at chunk position bq * ps + r / group;
// q and out are (B, Hq, C, D) given by their strides.  KG key groups of
// warps split the walk (attention_mma.cuh).  F is the keys' format: bf16
// rows (FpKV) copied straight into the ring, or packed rows with scales
// (QuantKV) staged and dequantized by QuantLoad.
constexpr int kTcStages = 2;
constexpr int kKgThreads = 384;  // two key groups while their warps fit this

template <int D, int KG, typename F>
__global__ void __launch_bounds__(KG == 1 ? am::MAX_ROWS * 2 : kKgThreads)
prefill_attention_kernel_tc(const bf16* __restrict__ q, am::Strides qs, F chunk_kv, F pools,
                            const int* __restrict__ tables, const int* __restrict__ starts,
                            const int* __restrict__ lens, bf16* __restrict__ out,
                            am::Strides os, int kv_heads, int group, int hs, int chunk,
                            int ps, int max_pages, int num_pages, int window, float qscale) {
  constexpr int PACK = Pack<F>::value;
  const int h = blockIdx.x / hs;     // kv head
  const int part = blockIdx.x % hs;  // which part of its GQA group
  const int bq = blockIdx.y;         // chunk page
  const int b = blockIdx.z;          // slot
  const int rows = ps * group;
  extern __shared__ float4 smem4[];
  const am::Ring<D, D, kTcStages, KG> ring(smem4);

  const int start = starts[b];
  const int len = lens[b];
  const long bh = (long)b * kv_heads + h;
  const int i_lo = bq * ps;       // first in-chunk position of this block
  const int q_lo = start + i_lo;  // its absolute position
  const int p_hi = min((start + ps - 1) / ps, max_pages);
  const int p_lo = window > 0 ? max(0, q_lo - window + 1) / ps : 0;
  const int n_prior = (max(0, p_hi - p_lo) * ps + am::KEYS - 1) / am::KEYS;
  const int k_lo = window > 0 ? max(0, i_lo - window + 1) : 0;  // first chunk key seen
  const int c_lo = k_lo / am::KEYS * am::KEYS;
  const int c_hi = min(i_lo + ps, len);  // causal, ragged on lens
  const int n_chunk = c_hi > c_lo ? (c_hi - c_lo + am::KEYS - 1) / am::KEYS : 0;
  const int* row = tables + (long)b * max_pages;
  const F head = pools.rows((long)h * num_pages * ps, D);
  const F own = chunk_kv.rows(bh * chunk, D);
  // past the ring: the quantized loader's staging area, then the slot's
  // table entries
  int8_t* stage = reinterpret_cast<int8_t*>(ring.kpos(ring.SLOTS));
  int* pages = reinterpret_cast<int*>(stage + (PACK ? QuantLoad<D, PACK ? PACK : 1, KG>::bytes() : 0));
  static_assert(QuantLoad<D, PACK ? PACK : 1, KG>::bytes() % 16 == 0, "table entries 16-byte aligned");
  const PrefillWalk walk{pages, __ffs(ps) - 1, p_lo, p_hi, start, c_lo, c_hi, n_prior, rows};
  using Keys = std::conditional_t<PACK == 0, PrefillKeys, QuantKeys<D, PACK ? PACK : 1>>;
  __shared__ Keys src;
  if (threadIdx.x == 0) {
    if constexpr (PACK == 0)
      src = {walk, head.k, head.v, own.k, own.v, D};
    else
      src = {walk, head.k, head.v, own.k, own.v, head.ks, head.vs, own.ks, own.vs, stage,
             n_prior + n_chunk};
  }
  for (int i = threadIdx.x; i < p_hi - p_lo; i += blockDim.x) {
    const int page = row[p_lo + i];
    pages[i] = page >= 0 && page < num_pages ? page : -1;
  }
  __syncthreads();

  auto at = [&](const am::Strides& st, int r) {  // block row r's offset in q or out
    return b * st.b + ((h * hs + part) * group + r % group) * st.h + (i_lo + r / group) * st.s;
  };
  const am::PosMask mask{nullptr, q_lo, group, window, true};
  am::WarpAttention<D, D> wa;
  auto qrow = [&](int r) { return r < rows ? q + at(qs, r) : nullptr; };
  if constexpr (PACK == 0) {
    am::attend(wa, ring, qrow, n_prior + n_chunk, src, mask, qscale, q);
  } else {
    QuantLoad<D, PACK, KG> ld{src};
    am::attend(wa, ring, qrow, n_prior + n_chunk, ld, mask, qscale, q);
  }
  if ((int)threadIdx.x < (int)blockDim.x / KG)  // key group 0 holds the merged rows
    wa.store([&](int r) { return r < rows ? out + at(os, r) : nullptr; });

  // ---- the paged write: this block's chunk page, through the table ------
  // (quantized: packed bytes and scales of the same rows together; by the
  // group's first part alone)
  const bool live_page = i_lo < len;
  const int tidx = min(start / ps + bq, max_pages - 1);
  const int dst = live_page ? row[tidx] : 0;
  if (part != 0 || dst < 0 || dst >= num_pages) return;  // dropped, like XLA's scatter
  own.rows(i_lo, D).copy_rows(head.rows((long)dst * ps, D), ps, D);
}

template <int D, int KG, typename F>
int launch_tc(const void* q, am::Strides qs, F chunk_kv, F pools, const void* tables,
              const void* starts, const void* lens, void* out, am::Strides os, int slots,
              int kv_heads, int group, int hs, int chunk, int ps, int max_pages,
              int num_pages, int window, float sm_scale, cudaStream_t stream) {
  constexpr int PACK = Pack<F>::value;
  const int rows = ps * group, warps = (rows + 15) / 16;
  // the ring, the quantized loader's staging area, then the slot's table entries
  const size_t smem = am::Ring<D, D, kTcStages, KG>::bytes() +
                      (PACK ? QuantLoad<D, PACK ? PACK : 1, KG>::bytes() : 0) +
                      sizeof(int) * (size_t)max_pages;
  if (chunk % ps != 0 || am::KEYS % ps != 0 || (ps & (ps - 1)) != 0 || rows > am::MAX_ROWS ||
      slots > 65535 || chunk / ps > 65535 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = prefill_attention_kernel_tc<D, KG, F>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads * hs, chunk / ps, slots);
  kernel<<<grid, KG * warps * 32, smem, stream>>>(
      (const bf16*)q, qs, chunk_kv, pools, (const int*)tables, (const int*)starts,
      (const int*)lens, (bf16*)out, os, kv_heads, group, hs, chunk, ps, max_pages,
      num_pages, window, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// The tensor-core launch of format F: two key groups where their warps fit
// kKgThreads, head dim 64 or 128.
template <typename F>
int launch_tc_any(int d, const void* q, am::Strides qs, F chunk_kv, F pools,
                  const void* tables, const void* starts, const void* lens, void* out,
                  am::Strides os, int slots, int kv_heads, int group, int hs, int chunk,
                  int ps, int max_pages, int num_pages, int window, float sm_scale,
                  cudaStream_t stream) {
  const bool split = 2 * 32 * ((ps * group + 15) / 16) <= kKgThreads;  // two key groups
#define PF_TC(D, KG)                                                                     \
  return launch_tc<D, KG, F>(q, qs, chunk_kv, pools, tables, starts, lens, out, os,     \
                             slots, kv_heads, group, hs, chunk, ps, max_pages,          \
                             num_pages, window, sm_scale, stream)
  if (d == 128 && split) PF_TC(128, 2);
  if (d == 128) PF_TC(128, 1);
  if (d == 64 && split) PF_TC(64, 2);
  if (d == 64) PF_TC(64, 1);
#undef PF_TC
  return (int)cudaErrorInvalidValue;
}

template <typename T, int PACK>
ac::QuantKV<T, PACK> quant_kv(void* k, void* v, void* ks, void* vs) {
  return {(int8_t*)k, (int8_t*)v, (T*)ks, (T*)vs};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// A kv head's GQA group of `group` query heads is split over `hs` blocks
// (hs, the last argument, divides group), each taking page_size * group / hs query rows: the
// block of part p holds query heads h * group + p * group / hs + g, and the
// first part alone writes the chunk's pages.  tc 1 takes the tensor-core
// kernel (bfloat16, head_dim 64 or 128, 64 % page_size == 0, page_size *
// group / hs <= 128), with q and out (B, Hq, C, D) given by their batch,
// head and row strides in elements (qb ... os); tc 0 the CUDA-core kernel,
// with q and out contiguous and packed chunk-major with their part of the
// GQA group, (B, Hkv * hs, C * G / hs, D), and the strides unused.  Needs
// chunk % page_size == 0, page_size a power of two <= 32 and head_dim a
// multiple of 8, with 16-byte aligned tensors.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take
// (a block's shared memory past 227 KB among them).
extern "C" int prefill_attention_launch(
    int dtype, int tc, const void* q, void* k, void* v, void* k_pages, void* v_pages,
    const void* tables, const void* starts, const void* lens, void* out,
    long long qb, long long qh, long long qs, long long ob, long long oh, long long os,
    int slots, int kv_heads, int group, int chunk, int d, int ps,
    int max_pages, int num_pages, int window, float sm_scale, void* stream, int hs) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hs < 1 || group % hs != 0) return (int)cudaErrorInvalidValue;
  group /= hs;  // query heads a block
  if (tc) {
    using B = __nv_bfloat16;
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_tc_any(d, q, am::Strides{qb, qh, qs}, ac::FpKV<B>{(B*)k, (B*)v},
                         ac::FpKV<B>{(B*)k_pages, (B*)v_pages}, tables, starts, lens, out,
                         am::Strides{ob, oh, os}, slots, kv_heads, group, hs, chunk, ps,
                         max_pages, num_pages, window, sm_scale, s);
  }
  if (dtype == 0)
    return launch(q, ac::FpKV<float>{(float*)k, (float*)v},
                  ac::FpKV<float>{(float*)k_pages, (float*)v_pages}, tables,
                  starts, lens, out, slots, kv_heads, group, hs, chunk, d, ps,
                  max_pages, num_pages, window, sm_scale, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch(q, ac::FpKV<B>{(B*)k, (B*)v},
                  ac::FpKV<B>{(B*)k_pages, (B*)v_pages}, tables, starts, lens,
                  out, slots, kv_heads, group, hs, chunk, d, ps, max_pages,
                  num_pages, window, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The quantized twin: pack 1 = int8, 2 = int4; the chunk's scales and the
// scale pools are of q's dtype; tc, hs and the strides of q and out as
// above (the tensor-core kernel takes the same shapes, with bfloat16
// scales).
// Needs head_dim / pack a multiple of 16 bytes, with 16-byte aligned packed
// tensors.
extern "C" int prefill_attention_quant_launch(
    int dtype, int tc, int pack, const void* q, void* k, void* v, void* k_scale,
    void* v_scale, void* k_pages, void* v_pages, void* k_scales,
    void* v_scales, const void* tables, const void* starts, const void* lens,
    void* out, long long qb, long long qh, long long qs, long long ob, long long oh,
    long long os, int slots, int kv_heads, int group, int chunk, int d, int ps,
    int max_pages, int num_pages, int window, float sm_scale, void* stream, int hs) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hs < 1 || group % hs != 0) return (int)cudaErrorInvalidValue;
  group /= hs;  // query heads a block
#define PF_QUANT_TC(P)                                                                      \
  return launch_tc_any(d, q, am::Strides{qb, qh, qs},                                      \
                       quant_kv<__nv_bfloat16, P>(k, v, k_scale, v_scale),                 \
                       quant_kv<__nv_bfloat16, P>(k_pages, v_pages, k_scales, v_scales),  \
                       tables, starts, lens, out, am::Strides{ob, oh, os}, slots, kv_heads, \
                       group, hs, chunk, ps, max_pages, num_pages, window, sm_scale, s)
  if (tc && dtype == 1 && pack == 1) PF_QUANT_TC(1);
  if (tc && dtype == 1 && pack == 2) PF_QUANT_TC(2);
#undef PF_QUANT_TC
  if (tc) return (int)cudaErrorInvalidValue;
#define PF_QUANT(T, P)                                                       \
  return launch(q, quant_kv<T, P>(k, v, k_scale, v_scale),                   \
                quant_kv<T, P>(k_pages, v_pages, k_scales, v_scales), tables, \
                starts, lens, out, slots, kv_heads, group, hs, chunk, d, ps, \
                max_pages, num_pages, window, sm_scale, s)
  if (dtype == 0 && pack == 1) PF_QUANT(float, 1);
  if (dtype == 0 && pack == 2) PF_QUANT(float, 2);
  if (dtype == 1 && pack == 1) PF_QUANT(__nv_bfloat16, 1);
  if (dtype == 1 && pack == 2) PF_QUANT(__nv_bfloat16, 2);
#undef PF_QUANT
  return (int)cudaErrorInvalidValue;
}
