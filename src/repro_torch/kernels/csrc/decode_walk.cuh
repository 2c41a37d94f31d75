// The paged decode's bulk-copy walk: one query token a slot against a paged
// KV pool, for the bf16 GQA decode and its quantized twin
// (paged_attention.cu, route 2) at head width 256 (gemma-7b), and at a
// group of 1 at head widths 64 and 128 where the route takes them.
//
// Bound on the H100: bytes.  A decode does 4 G D FLOPs for every 4 D bytes
// of a key's K and V row (G query rows a kv head): at gemma's group of 1
// about 1 FLOP a byte, against a ridge of 295.  What set the older bodies'
// time at these shapes was how fast one block streams its split, not the
// card's bytes: the CUDA-core body walks one page at a time, fetched into
// registers, converted to fp32 in shared memory behind three block-wide
// barriers, each page's table entry a dependent load ahead of its copy
// (~4.7 GB/s a block at gemma's shape); the mma.sync walk at a group of 1
// keeps 1 of its 16-row m-tile live and one warp of four busy.
//
// The walk (grid (kv head, slot, split), on the split rule walk_splits of
// paged_attention.py; the partial states and merge of split_merge.cuh):
//   * a producer warp, one thread of which copies every page: the split's
//     table entries first go into shared memory (by every thread, once),
//     then per page one 1-D bulk copy (cp.async.bulk, hopper_core.cuh's
//     bulk_load) for K and one for V, plus the page's two scale columns for
//     the quantized twin, into a ring of WALK_STAGES stages with full and
//     empty mbarriers.  A page of one kv head is ps x D contiguous values,
//     so no tensor map is needed, and a block keeps WALK_STAGES pages in
//     flight while spending no registers on them.  A page whose table entry
//     lies outside the pool is not copied: the producer arrives on its full
//     barrier without bytes, and the consumers, which read the same table
//     entries, skip the stage.
//   * WALK_WARPS consumer warps, each scoring its share of every stage on the
//     CUDA cores in fp32: rounds of WALK_ROUND keys, WALK_ROUND / WALK_WARPS
//     a warp.  Lane l keeps elements [l E, l E + E) (E = D / 32) of the
//     group's q rows, prescaled by sm_scale log2e, and of their O rows; a
//     score is a dot product summed across the warp by shuffles; the online
//     softmax runs in the log2 domain with exp2, the running max clamped at
//     NEG_CLAMP before differencing (attention_core.cuh).  A key outside
//     [max(0, len - window), len) never multiplies a value (padding pages
//     may hold NaN, and 0 * NaN is NaN).  P stays fp32: no bf16 pair.
//   * the quantized twin's values are dequantized in registers, code x
//     scale in fp32 rounded once to bf16 (the plain version's
//     dequantize-then-round, bit for bit), the code and the rounding by
//     integer arithmetic: at these widths the conversion unit's 16 results
//     a clock an SM bounded the twin (tools/decode_walk_ablation.py).
//   * at the end of the split the warps' (O, m, l) meet in shared memory,
//     are rescaled to their common max and summed in warp order, and leave
//     the split's partial state; a split with no live key leaves m =
//     NEG_CLAMP and l = 0, which the merge weighs 0.
// The ring: stage s holds pages s, s + WALK_STAGES, ...; the producer waits
// for the (r - 1)-th completion of empty[s] before its r-th copy into it
// (empty[s] counts one arrival a consumer warp), a consumer for the r-th
// completion of full[s] (parity r & 1).  Every consumer warp reads every
// stage, so every arrival lands in its own phase.
//
// WALK_ABLATE (tools/decode_walk_ablation.py only): 1 leaves out the
// consumers' arithmetic (the loads alone), 2 the producer's copies (the
// arithmetic on whatever the ring holds).

#pragma once

#include "attention_core.cuh"
#include "hopper_core.cuh"
#include "split_merge.cuh"

#if !defined(WALK_STAGES) || !defined(WALK_SPLIT_KEYS) || !defined(WALK_WARPS) || \
    !defined(WALK_ROUND)
#error "the walk's tile constants come from paged_attention.py (build.Kernel defines)"
#endif
#ifndef WALK_ABLATE
#define WALK_ABLATE 0
#endif

namespace dw {

using bf16 = __nv_bfloat16;

constexpr int STAGES = WALK_STAGES;        // pages in flight a block
constexpr int SPLIT_KEYS = WALK_SPLIT_KEYS;  // keys a split at most
constexpr int WARPS = WALK_WARPS;          // consumer warps
constexpr int ROUND = WALK_ROUND;          // keys the consumer warps score together
constexpr int KB = ROUND / WARPS;          // keys a warp a round
constexpr int THREADS = 32 * (WARPS + 1);  // the producer warp first
constexpr int MIN_PAGE = 8;                // a scale column of 16 bytes
constexpr int MAX_PAGE = 32;
constexpr int MAX_SMEM = 232448;
constexpr int LOADS_ONLY = 1, COMPUTE_ONLY = 2;  // WALK_ABLATE
static_assert(ROUND % WARPS == 0 && MIN_PAGE % ROUND == 0,
              "a page holds whole rounds, each warp the same keys of each");
static_assert(SPLIT_KEYS % 32 == 0, "a split holds whole pages of 8 to 32");

// The kv pools at head 0, page 0: rows of Layout::ROW bytes; the quantized
// twin's bf16 scale pools beside them (null for bf16 rows).
struct Pools {
  const uint8_t *k, *v;
  const bf16 *ks, *vs;
};

// Shared memory of a block at pages of ps rows, in bytes: the ring (stage s:
// a page of K, of V, then K's and V's scale columns), the full and empty
// mbarriers, the split's table entries, the warps' merge area (O, m, l of
// G rows a warp).  paged_attention.py's walk_smem_bytes says the same.
template <int D, int G, int PACK>
struct Layout {
  static constexpr int ROW = PACK ? D / PACK : 2 * D;  // bytes of a K or V row
  int ps;
  __host__ __device__ int page() const { return ps * ROW; }
  __host__ __device__ int scales() const { return PACK ? ps * 2 : 0; }
  __host__ __device__ int stage() const { return 2 * (page() + scales()); }
  __host__ __device__ int k(int s) const { return s * stage(); }
  __host__ __device__ int v(int s) const { return k(s) + page(); }
  __host__ __device__ int ks(int s) const { return v(s) + page(); }
  __host__ __device__ int vs(int s) const { return ks(s) + scales(); }
  __host__ __device__ int bars() const { return STAGES * stage(); }
  __host__ __device__ int pages() const { return bars() + 2 * 8 * STAGES; }
  __host__ __device__ int merge() const { return pages() + 4 * (SPLIT_KEYS / MIN_PAGE); }
  __host__ __device__ int bytes() const { return merge() + 4 * WARPS * G * (D + 2); }
};

// NB bytes from shared memory (NB-aligned) as 32-bit words.
template <int NB>
struct Bytes {
  uint32_t w[NB >= 4 ? NB / 4 : 1];
};

template <int NB>
__device__ __forceinline__ Bytes<NB> load_bytes(const uint8_t* p) {
  Bytes<NB> x;
  if constexpr (NB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    x.w[0] = u.x, x.w[1] = u.y, x.w[2] = u.z, x.w[3] = u.w;
  } else if constexpr (NB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x.w[0] = u.x, x.w[1] = u.y;
  } else if constexpr (NB == 4) {
    x.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NB == 2) {
    x.w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    x.w[0] = *p;
  }
  return x;
}

// x rounded to the nearest bf16 (ties to even), as fp32, by integer
// arithmetic: the conversion unit (16 results a clock an SM) would bound the
// quantized twin's dequantization at these widths.  Equal to
// __float2bfloat16's rounding for every finite x; NaN stays NaN.
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// Byte k of u (an unsigned code: the signed one plus `bias`) as that signed
// code in fp32, without the conversion unit: the byte goes into the low
// mantissa bits of 2^23, and a subtraction leaves the code exactly
// (kv_dequant.cuh's trick).
template <int BIAS>
__device__ __forceinline__ float code_at(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) - (8388608.f + BIAS);
}

// A lane's E = D / 32 values of a K or V row in shared memory, as fp32:
// bf16 rows widened, packed rows dequantized: code x scale in fp32 (exact:
// at most 8 significant bits each) rounded once to bf16, the plain
// version's dequantize-then-round bit for bit (int4 low nibble first).
template <int D, int PACK>
__device__ __forceinline__ void load_row(float (&x)[D / 32], const uint8_t* row, int lane,
                                         float scale) {
  constexpr int E = D / 32;
  if constexpr (PACK == 0) {
    const Bytes<2 * E> b = load_bytes<2 * E>(row + lane * 2 * E);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t w = b.w[e / 2];
      x[e] = __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
    }
  } else if constexpr (PACK == 1) {  // byte e: value e
    const Bytes<E> b = load_bytes<E>(row + lane * E);
#pragma unroll
    for (int e = 0; e < E; ++e)
      x[e] = round_bf16(code_at<128>(b.w[e / 4] ^ 0x80808080u, e % 4) * scale);
  } else {  // byte e / 2: value e in its low nibble for even e, else its high one
    const Bytes<E / 2> b = load_bytes<E / 2>(row + lane * (E / 2));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t w = b.w[e / 8];
      const uint32_t nib = ((e % 2 ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
      x[e] = round_bf16(code_at<8>(nib, e / 2 % 4) * scale);
    }
  }
}

__device__ __forceinline__ float scale_at(const uint8_t* column, int j) {
  return __bfloat162float(reinterpret_cast<const bf16*>(column)[j]);
}

// A consumer warp's state: the group's q rows and each row's O, running max
// and sum (G rows: the group rounded up to a power of two, rows past the
// group zero and never stored).
template <int D, int G>
struct WarpState {
  static constexpr int E = D / 32;
  float qr[G][E], o[G][E], m[G], l[G];

  __device__ void init(const bf16* qg, int group, int lane, float qscale) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) {  // one element at a time: q needs no alignment
        qr[r][e] = r < group ? __bfloat162float(qg[(long)r * D + lane * E + e]) * qscale : 0.f;
        o[r][e] = 0.f;
      }
      m[r] = -CUDART_INF_F;
      l[r] = 0.f;
    }
  }

  // Keys j0 .. j0 + KB - 1 of the stage (K rows at kst, V rows at vst, their
  // scale columns at kss / vss), at positions pos0 + j; live where lo <= pos
  // < len.
  template <int PACK>
  __device__ void step(const uint8_t* kst, const uint8_t* vst, const uint8_t* kss,
                        const uint8_t* vss, int j0, int pos0, int lo, int len, int lane) {
    constexpr int ROW = Layout<D, G, PACK>::ROW;
    float sc[KB][G];
    bool live[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int j = j0 + k;
      float kv[E];
      load_row<D, PACK>(kv, kst + j * ROW, lane, PACK ? scale_at(kss, j) : 0.f);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc = fmaf(qr[r][e], kv[e], acc);
        sc[k][r] = acc;
      }
      const int pos = pos0 + j;
      live[k] = pos >= lo && pos < len;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < KB; ++k)
#pragma unroll
        for (int r = 0; r < G; ++r) sc[k][r] += __shfl_xor_sync(0xFFFFFFFFu, sc[k][r], off);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (live[k]) mx = fmaxf(mx, sc[k][r]);
      const float m_new = fmaxf(m[r], mx), mc = fmaxf(m_new, ac::NEG_CLAMP);
      const float alpha = exp2f(fmaxf(m[r], ac::NEG_CLAMP) - mc);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        sc[k][r] = live[k] ? exp2f(sc[k][r] - mc) : 0.f;  // now P
        sum += sc[k][r];
      }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) o[r][e] *= alpha;
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (!live[k]) continue;  // a dead key's value is never read
      const int j = j0 + k;
      float vv[E];
      load_row<D, PACK>(vv, vst + j * ROW, lane, PACK ? scale_at(vss, j) : 0.f);
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) o[r][e] = fmaf(sc[k][r], vv[e], o[r][e]);
    }
  }
};

// Block (kv head h, slot b, split s): the split's pages [p_lo, p_hi) that
// hold live keys, split_keys / ps pages a split.  Block row r < group is
// query head h * group + r, at position len - 1.
template <int D, int G, int PACK>
__global__ void __launch_bounds__(THREADS)
decode_walk_kernel(const bf16* __restrict__ q, Pools pools, const int* __restrict__ tables,
                   const int* __restrict__ lens, sk::Partials part, int kv_heads, int ps,
                   int max_pages, int num_pages, int window, int split_keys, float qscale) {
  using L = Layout<D, G, PACK>;
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int group = part.heads / kv_heads;
  const int len = lens[b];
  const int keys = min(len, max_pages * ps);  // a length past the table reads no more
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int split_pages = split_keys / ps;
  const int p_lo = max(lo / ps, s * split_pages);
  const int p_hi = min((keys + ps - 1) / ps, (s + 1) * split_pages);
  const int n = p_hi - p_lo;
  if (n <= 0) {
    part.empty(b, h * group, group, s);
    return;
  }
  extern __shared__ float4 smem4[];  // one declaration for the file's kernels
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const L lay{ps};
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars());
  uint64_t* empty = full + STAGES;
  int* pages = reinterpret_cast<int*>(smem + lay.pages());
  const int* row = tables + (long)b * max_pages + p_lo;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int page = row[i];
    pages[i] = page >= 0 && page < num_pages ? page : -1;  // out of the pool: skipped
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hc::mbar_init(&full[i], 1);
      hc::mbar_init(&empty[i], WARPS);
    }
    hc::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the producer: one thread issues every copy
    if (threadIdx.x == 0) {
      const long head = (long)h * num_pages;
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, r = i / STAGES;
        if (r > 0) hc::mbar_wait(&empty[st], (r - 1) & 1);  // its (r - 1)-th release
        const int page = pages[i];
        if (page < 0 || WALK_ABLATE == COMPUTE_ONLY) {
          hc::mbar_arrive(&full[st]);  // no bytes: the consumers skip or reuse the stage
          continue;
        }
        const long at = head + page;
        hc::mbar_expect_tx(&full[st], lay.stage());
        hc::bulk_load(smem + lay.k(st), pools.k + at * lay.page(), lay.page(), &full[st]);
        hc::bulk_load(smem + lay.v(st), pools.v + at * lay.page(), lay.page(), &full[st]);
        if constexpr (PACK != 0) {
          hc::bulk_load(smem + lay.ks(st), pools.ks + at * ps, lay.scales(), &full[st]);
          hc::bulk_load(smem + lay.vs(st), pools.vs + at * ps, lay.scales(), &full[st]);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32 - 1, lane = threadIdx.x % 32;
  WarpState<D, G> ws;
  ws.init(q + ((long)b * part.heads + (long)h * group) * D, group, lane, qscale);
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    hc::mbar_wait(&full[st], (i / STAGES) & 1);
    if (pages[i] >= 0 && WALK_ABLATE != LOADS_ONLY) {
      const int pos0 = (p_lo + i) * ps;
      for (int j0 = warp * KB; j0 < ps; j0 += ROUND)
        ws.template step<PACK>(smem + lay.k(st), smem + lay.v(st), smem + lay.ks(st),
                                smem + lay.vs(st), j0, pos0, lo, len, lane);
    }
    __syncwarp();
    if (lane == 0) hc::mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  // the warps' states meet: O (WARPS x G x D), then m and l (WARPS x G)
  float* mo = reinterpret_cast<float*>(smem + lay.merge());
  float* mm = mo + WARPS * G * D;
  float* ml = mm + WARPS * G;
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int e = 0; e < WarpState<D, G>::E; ++e)
      mo[(warp * G + r) * D + lane * WarpState<D, G>::E + e] = ws.o[r][e];
    if (lane == 0) {
      mm[warp * G + r] = fmaxf(ws.m[r], ac::NEG_CLAMP);
      ml[warp * G + r] = ws.l[r];
    }
  }
  hc::bar_sync(1, 32 * WARPS);
  for (int i = threadIdx.x - 32; i < group * D; i += 32 * WARPS) {
    const int r = i / D, c = i - r * D;
    float mx = ac::NEG_CLAMP;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mm[w * G + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(mm[w * G + r] - mx);
      num += wt * mo[(w * G + r) * D + c];
      den += wt * ml[w * G + r];
    }
    const long at = part.row(b, h * group + r, s);
    part.o[at * D + c] = num;
    if (c == 0) {
      part.m[at] = mx;
      part.l[at] = den;
    }
  }
}

template <int D, int G, int PACK>
int launch_at(const void* q, Pools pools, const void* tables, const void* lens,
              const sk::Partials& part, int slots, int kv_heads, int ps, int max_pages,
              int num_pages, int window, int split_keys, float sm_scale, cudaStream_t stream) {
  const int smem = Layout<D, G, PACK>{ps}.bytes();
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = decode_walk_kernel<D, G, PACK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, slots, part.splits);
  kernel<<<grid, THREADS, smem, stream>>>((const bf16*)q, pools, (const int*)tables,
                                          (const int*)lens, part, kv_heads, ps, max_pages,
                                          num_pages, window, split_keys,
                                          sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// Whether the walk takes a launch's grid: pages of 8 to 32 rows (a power of
// two: whole rounds, a scale column of 16 bytes or more), splits of whole
// pages, no more of them than the table entries' place holds, covering the
// table.
inline bool grid_ok(int slots, int splits, int split_keys, int ps, int max_pages) {
  return splits >= 1 && splits <= 65535 && slots >= 1 && slots <= 65535 && ps >= MIN_PAGE &&
         ps <= MAX_PAGE && (ps & (ps - 1)) == 0 && split_keys >= ps && split_keys % ps == 0 &&
         split_keys / ps <= SPLIT_KEYS / MIN_PAGE &&
         (long)splits * split_keys >= (long)max_pages * ps;
}

// The walk at head dim d with `group` query heads a kv head: d 256 with a
// group of up to 4 (registers: q and O of each row, D / 32 values a lane),
// d 64 or 128 at a group of 1.  PACK 0: bf16 rows; 1 / 2: int8 / int4 rows
// with bf16 scales.
template <int PACK>
int launch(int d, int group, const void* q, Pools pools, const void* tables, const void* lens,
           const sk::Partials& part, int slots, int kv_heads, int ps, int max_pages,
           int num_pages, int window, int splits, int split_keys, float sm_scale,
           cudaStream_t stream) {
  if (!grid_ok(slots, splits, split_keys, ps, max_pages)) return (int)cudaErrorInvalidValue;
#define DW_AT(D, G)                                                                         \
  return launch_at<D, G, PACK>(q, pools, tables, lens, part, slots, kv_heads, ps, max_pages, \
                               num_pages, window, split_keys, sm_scale, stream)
  if (d == 256 && group == 1) DW_AT(256, 1);
  if (d == 256 && group == 2) DW_AT(256, 2);
  if (d == 256 && group <= 4) DW_AT(256, 4);
  if (d == 128 && group == 1) DW_AT(128, 1);
  if (d == 64 && group == 1) DW_AT(64, 1);
#undef DW_AT
  return (int)cudaErrorInvalidValue;
}

}  // namespace dw
