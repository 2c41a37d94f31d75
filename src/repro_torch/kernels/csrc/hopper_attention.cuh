// The warpgroup attention walk at head width 256 (Dk = Dv = 256, bf16), for
// the flash forward (flash_attention.cu, flash_attention_kernel_wg) and the
// chunked prefill over pages (prefill_attention.cu,
// prefill_attention_kernel_wg), over hopper_core.cuh.
//
// A block is three warpgroups: a producer (setmaxnreg.dec to 40) whose one
// thread copies every tile by TMA, and two consumers (setmaxnreg.inc to
// 232).  Each consumer owns a tile of 64 query rows and all 256 output
// columns: O is 64 x 256 fp32, 128 registers a thread.  Thread (warp w,
// lane) holds rows r0 = 16 w + lane / 4 and r0 + 8 (h = 0, 1), columns 8 j
// + 2 (lane % 4) + e in acc[4 j + 2 h + e] (hopper_core.cuh's accumulator
// layout).
//
// * Shared memory (Layout): the query tiles (64 rows x 256 columns, four
//   64-column boxes of 8 KB under 128-byte swizzle), then STAGES stages of
//   [K tile | V tile] (KEYS rows x 256, four boxes each), then the full /
//   empty mbarrier pairs and Q's, then what the kernel keeps beside them
//   (the prefill's table entries).
// * Scores.  S (64 x KEYS) = Q . K^T by wgmma m64nKEYSk16 with both
//   operands K-major in shared memory, over the 16 k-steps of Q's 256
//   columns, one fp32 accumulator (KEYS / 2 registers).
// * Softmax in fp32 registers, as attention_core.cuh's: exp2 on
//   log2e-scaled scores, the running max clamped at NEG_CLAMP before
//   differencing, a row with no live key 0.  A row lives in the 4 lanes of
//   a quad: two shuffles for the max, two for the sum.
// * P as the bf16 pair hi + lo, converted in place into wgmma A fragments
//   (the accumulator's pairs, rounded and packed, are mma.sync's m16n8k16 A
//   layout), then O += P_hi . V + P_lo . V by wgmma m64n256k16 with A from
//   registers and V read MN-major.  P rounded once reads 20-160 bf16 ulps at
//   these widths; the pair keeps ~16 significant bits for twice P.V's
//   tensor work.
// * The ring.  Stage s holds tiles s, s + STAGES, ...; the producer waits
//   for the (r - 1)-th completion of empty[s] before its r-th load into it,
//   a consumer for the r-th completion of full[s] (parity r & 1) before
//   reading.  empty[s] counts one arrival from each consumer that reads the
//   stage's tiles (`readers`: 2 where both consumers walk every tile, 1
//   where they take alternate tiles).  A consumer done with its rows before
//   the block's last tile still waits for each later tile to land and then
//   releases it (pass), so that every arrival lands in its own phase.
// * The walk is cut into phases whose wgmma waits are unconditional, and no
//   register of a product is written between the first product issued after
//   a wait and the next wait: otherwise ptxas serializes every wgmma (notes
//   C7514 / C7515).

#pragma once

#include "hopper_core.cuh"
#include "mma_core.cuh"  // gc::store2, ac::NEG_CLAMP

namespace ha {

using bf16 = __nv_bfloat16;

constexpr int D = 256;                  // Dk = Dv
constexpr int ROWS = 64;                // query rows a consumer: one wgmma m64
constexpr int BOX = 64;                 // columns a TMA box: 128 bytes
constexpr int BOXES = D / BOX;          // boxes a row
constexpr int THREADS = 3 * 128;        // the producer's warpgroup first
constexpr int Q_BOX = ROWS * BOX * 2;   // 8 KB: 64 rows of one box
constexpr int Q_BYTES = BOXES * Q_BOX;  // a consumer's query tile
constexpr int MAX_SMEM = 232448;        // the most a block may take
constexpr int BAR_WALKED = 1;           // both consumers done with the ring
constexpr int BAR_MERGE = 2;            // the second consumer's state handed over

// Shared memory of a block, in bytes from a 1024-byte boundary.
template <int KEYS, int STAGES>
struct Layout {
  static constexpr int K_BOX = KEYS * BOX * 2;      // KEYS rows of one box
  static constexpr int KV_BYTES = BOXES * K_BOX;    // a K (or V) tile
  static constexpr int BARS = 128;                  // full, empty, Q's: 8 bytes each
  static_assert(8 * (2 * STAGES + 1) <= BARS, "the mbarriers fit their place");
  static_assert(STAGES * 2 * KV_BYTES >= 128 * (128 + 4) * 4,
                "the ring holds a consumer's O and row state for the merge");
  int q_tiles;
  __host__ __device__ explicit Layout(int q_tiles_) : q_tiles(q_tiles_) {}
  __host__ __device__ size_t q(int i) const { return (size_t)i * Q_BYTES; }
  __host__ __device__ size_t k(int s) const {
    return (size_t)q_tiles * Q_BYTES + (size_t)s * 2 * KV_BYTES;
  }
  __host__ __device__ size_t v(int s) const { return k(s) + KV_BYTES; }
  __host__ __device__ size_t bars() const { return k(STAGES); }
  __host__ __device__ size_t extra() const { return bars() + BARS; }
  // + what the kernel keeps past the bars + room to align the base
  __host__ __device__ size_t bytes(size_t extra_bytes) const {
    return extra() + extra_bytes + 1024;
  }
};

// The block's shared memory from a 1024-byte boundary.
__device__ __forceinline__ uint8_t* aligned(void* raw) {
  uint8_t* p = reinterpret_cast<uint8_t*>(raw);
  return p + ((1024 - (hc::smem_addr(p) & 1023)) & 1023);
}

// The mbarriers: full[STAGES], empty[STAGES], then Q's.
template <int STAGES>
struct Bars {
  uint64_t* full;
  __device__ uint64_t* empty() const { return full + STAGES; }
  __device__ uint64_t* q() const { return full + 2 * STAGES; }
  // by one thread, before the block's first __syncthreads
  __device__ void init(int readers) const {
    for (int s = 0; s < STAGES; ++s) {
      hc::mbar_init(&full[s], 1);
      hc::mbar_init(&empty()[s], readers);
    }
    hc::mbar_init(q(), 1);
    hc::fence_barrier_init();
  }
};

// Two 16-bit values in one register, x in the low half (a wgmma A operand);
// rx, ry receive the rounded values.
__device__ __forceinline__ uint32_t pack(float x, float y, float& rx, float& ry) {
  const bf16 a = __float2bfloat16(x), b = __float2bfloat16(y);
  rx = __bfloat162float(a);
  ry = __bfloat162float(b);
  return (uint32_t)__bfloat16_as_ushort(a) | (uint32_t)__bfloat16_as_ushort(b) << 16;
}

// Keeps the compiler from moving O's reads and writes across the
// asynchronous products that accumulate into it.
__device__ __forceinline__ void fence(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) hc::reg_fence(acc[i]);
}

// A consumer warpgroup's walk state: O, and each of its two rows' running
// max and sum.
template <int KEYS, int STAGES>
struct Consumer {
  using L = Layout<KEYS, STAGES>;
  static constexpr int NS = KEYS / 2;   // score registers a thread
  static constexpr int KS = KEYS / 16;  // 16-key steps a tile
  using Pair = uint32_t[KS][4];          // P's hi or lo as wgmma A fragments
  uint8_t* smem;
  const L lay;  // one int: held by value
  Bars<STAGES> bars;
  const uint8_t* qt;  // this consumer's query tile
  int tid, q4, r0;
  float qscale;
  float acc[128];
  float m_run[2], l_run[2];

  __device__ Consumer(uint8_t* smem_, const L& lay_, int q_tile, float qscale_)
      : smem(smem_), lay(lay_), qscale(qscale_) {
    bars.full = reinterpret_cast<uint64_t*>(smem + lay.bars());
    qt = smem + lay.q(q_tile);
    tid = threadIdx.x % 128;
    q4 = tid % 4;
    r0 = 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    m_run[0] = m_run[1] = -CUDART_INF_F;
    l_run[0] = l_run[1] = 0.f;
  }

  __device__ void wait_q() const { hc::mbar_wait(bars.q(), 0); }
  __device__ void wait_tile(int t) const {
    hc::mbar_wait(&bars.full[t % STAGES], (t / STAGES) & 1);
  }
  __device__ void release(int t) const {
    if (tid == 0) hc::mbar_arrive(&bars.empty()[t % STAGES]);
  }
  // A tile whose rows this consumer does not walk: landed, then released.
  __device__ void pass(int t) const {
    wait_tile(t);
    release(t);
  }

  // S = Q . K_t^T over all 256 columns, landed.
  __device__ void score(int t, float (&s)[NS]) {
    const uint8_t* kt = smem + lay.k(t % STAGES);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = 0.f;
      hc::reg_fence(s[i]);
    }
    hc::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hc::wgmma_m64nNk16_kk<bf16, KEYS>(
          s, hc::sw128_desc(qt + (k / 4) * Q_BOX + (k % 4) * 32, 16, 1024),
          hc::sw128_desc(kt + (k / 4) * L::K_BOX + (k % 4) * 32, 16, 1024), k > 0);
    hc::wgmma_commit();
    hc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NS; ++i) hc::reg_fence(s[i]);
  }

  // The online softmax of a tile's scores: P as the pair in registers, the
  // rows' alpha in a.  live(r, j): whether key j of the tile is live for
  // row r of this consumer's 64 (asked only where `masked`).
  template <typename Live>
  __device__ void softmax(float (&s)[NS], bool masked, const Live& live, float (&a)[2], Pair& ph,
                          Pair& pl) {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i / 2) % 2, key = 8 * (i / 4) + 2 * q4 + i % 2;
      s[i] = !masked || live(r0 + 8 * h, key) ? s[i] * qscale : -CUDART_INF_F;
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_cur = fmaxf(m_run[h], mx[h]);
      mc[h] = fmaxf(m_cur, ac::NEG_CLAMP);
      a[h] = exp2f(fmaxf(m_run[h], ac::NEG_CLAMP) - mc[h]);
      m_run[h] = m_cur;
    }
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[4 * j + 2 * h] - mc[h]), p1 = exp2f(s[4 * j + 2 * h + 1] - mc[h]);
        sum[h] += p0 + p1;
        float h0, h1, unused0, unused1;
        ph[j / 2][2 * (j % 2) + h] = pack(p0, p1, h0, h1);
        pl[j / 2][2 * (j % 2) + h] = pack(p0 - h0, p1 - h1, unused0, unused1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * a[h] + sum[h];
    }
  }

  // O = O a + P_hi . V_t + P_lo . V_t, landed.  A warp whose rows' maxima
  // did not move skips the rescale.
  __device__ void pv(int t, const float (&a)[2], Pair& ph, Pair& pl) {
    if (!__all_sync(0xffffffffu, a[0] == 1.f && a[1] == 1.f)) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= a[(i / 2) % 2];
    }
    fence(acc);
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(ph[k][e]), "+r"(pl[k][e])::"memory");
    const uint8_t* vt = smem + lay.v(t % STAGES);
    hc::wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k)
      hc::wgmma_m64n256k16_rs<bf16>(acc, ph[k], hc::sw128_desc(vt + 16 * k * 128, L::K_BOX, 1024));
#pragma unroll
    for (int k = 0; k < KS; ++k)
      hc::wgmma_m64n256k16_rs<bf16>(acc, pl[k], hc::sw128_desc(vt + 16 * k * 128, L::K_BOX, 1024));
    hc::wgmma_commit();
    hc::wgmma_wait<0>();
    fence(acc);
  }

  // Tile t: landed, scored, softmaxed, multiplied, released.
  template <typename Live>
  __device__ void step(int t, bool masked, const Live& live) {
    float s[NS], a[2];
    Pair ph, pl;
    wait_tile(t);
    score(t, s);
    softmax(s, masked, live, a, ph, pl);
    pv(t, a, ph, pl);
    release(t);
  }

  // The other consumer's O and row state, handed over through the ring once
  // both have walked their tiles (the ring is then free), merged into this
  // one's: the writer (`give`) arrives, the reader syncs.
  __device__ void merge(bool give) {
    float* o = reinterpret_cast<float*>(smem + lay.k(0));  // [128 / 4][128 threads] float4
    float* st = o + 128 * 128;                              // [4][128 threads]
    hc::bar_sync(BAR_WALKED, 256);
    if (give) {
#pragma unroll
      for (int i = 0; i < 128; i += 4)
        *reinterpret_cast<float4*>(o + (i / 4 * 128 + tid) * 4) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
      st[0 * 128 + tid] = m_run[0];
      st[1 * 128 + tid] = m_run[1];
      st[2 * 128 + tid] = l_run[0];
      st[3 * 128 + tid] = l_run[1];
      __threadfence_block();
      hc::bar_arrive(BAR_MERGE, 256);
      return;
    }
    hc::bar_sync(BAR_MERGE, 256);
    float a[2], b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = st[h * 128 + tid];
      const float mc = fmaxf(fmaxf(m_run[h], m1), ac::NEG_CLAMP);
      a[h] = exp2f(fmaxf(m_run[h], ac::NEG_CLAMP) - mc);
      b[h] = exp2f(fmaxf(m1, ac::NEG_CLAMP) - mc);
      m_run[h] = fmaxf(m_run[h], m1);
      l_run[h] = l_run[h] * a[h] + st[(2 + h) * 128 + tid] * b[h];
    }
#pragma unroll
    for (int i = 0; i < 128; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(o + (i / 4 * 128 + tid) * 4);
      acc[i] = acc[i] * a[(i / 2) % 2] + x.x * b[(i / 2) % 2];
      acc[i + 1] = acc[i + 1] * a[(i / 2) % 2] + x.y * b[(i / 2) % 2];
      acc[i + 2] = acc[i + 2] * a[(i / 2 + 1) % 2] + x.z * b[(i / 2 + 1) % 2];
      acc[i + 3] = acc[i + 3] * a[(i / 2 + 1) % 2] + x.w * b[(i / 2 + 1) % 2];
    }
  }

  // O / max(l, 1e-30), rounded once, into row(r) (nullptr: not stored).
  template <typename RowPtr>
  __device__ void store(const RowPtr& row) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* dst = row(r0 + 8 * h);
      if (dst == nullptr) continue;
      const float inv = 1.f / fmaxf(l_run[h], 1e-30f);
      dst += 2 * q4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        gc::store2(dst + 8 * j, acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
};

}  // namespace ha
