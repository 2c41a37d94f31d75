// Contiguous multi-head latent attention (MLA) decode: FlashMLA.
//
// Replaces the TPU kernel repro/kernels/mla.py:33 (mla_program, the paper's
// Fig. 18): q (B, Hq, D) latent queries and q_pe (B, Hq, Dpe) rotary ones
// against a contiguous cache kv (B, S, Hkv, D) and k_pe (B, S, Hkv, Dpe),
// Hq / Hkv query heads to a latent head, out (B, Hq, D) =
// softmax(scale (q . kv + q_pe . k_pe)) . kv: V is the latent itself.
// fp32, bf16 or fp16.
//
// Numerics: the function is ref.mla's.  Fig. 18's formulation keeps a
// per-block max and stages the probabilities through shared memory in the
// input type; those are schedule choices.  Both kernels here run the online
// softmax of attention_core.cuh, as the port's other MLA kernels do: scores,
// the softmax and the accumulator in fp32, exp2 on log2e-scaled scores, the
// running max clamped at NEG_CLAMP, a row with no live key 0 (safe_div), the
// output rounded once.
//
// Bound on the H100: bytes.  Each latent and rope row is read once for the
// Hq / Hkv heads that share it ((D + Dpe) * itemsize bytes a key), and
// 2 Hq / Hkv (2 D + Dpe) FLOPs are done on it: at the paper's shapes (128
// heads over one latent head, D 512, Dpe 64) about 240 FLOPs a byte, under
// the card's 295 FLOP/byte bf16 ridge; b128 x s8192 moves 1.24 GB, 0.37 ms
// at 3.35 TB/s.  The tensor-core kernel multiplies P as a pair (below), so
// its own floor is its tensor work: 2 b Hq s (3 D + Dpe) = 429 GFLOP at
// b128 x s8192, 0.434 ms at 989 TFLOP/s.
//
// Two kernels, chosen by the launch (tc_takes; mla.py's tensor_core_path):
//
// * wgmma, for bf16 / fp16 at D = 512 with D + Dpe a multiple of 64, up to
//   832 (the paper's shapes): FlashMLA's Hopper design.  A block holds 64
//   query heads of one latent head (the reference's block_H = 64; two
//   blocks split 128 heads), grid (head groups x latent heads, batch), the
//   head group the fastest axis so that the second group reads each key
//   tile from L2; rows past the group are computed and not stored.  Three
//   warpgroups:
//   - a producer (setmaxnreg.dec) whose one thread copies Q and q_pe once
//     by TMA (2-D maps, 64-column boxes, 128-byte swizzle) and then key
//     tiles of KEYS keys ([latent | rope] rows; 3-D maps over (B, S, Hkv *
//     width), so keys past the sequence arrive as zeros) into a ring of
//     STAGES stages, each with a full / empty mbarrier pair;
//   - two consumers (setmaxnreg.inc), consumer c owning O's columns [256
//     c, 256 c + 256): 64 x 256 fp32 = 128 registers a thread.  Consumer
//     t % 2 scores tile t: S (64 x KEYS) = Q . K^T over all D + Dpe columns
//     in one fp32 wgmma accumulator (m64nKEYSk16, both operands K-major in
//     shared memory), the softmax in registers (a quad of 4 lanes a row:
//     two shuffles for the max, two for the sum), P as the bf16 / fp16
//     pair hi + lo.  It keeps P in registers, converted in place into
//     wgmma A fragments, for its own half (O += P_hi V + P_lo V,
//     m64n256k16, V = the tile's latent columns read MN-major), and hands
//     the pair and the row max to the other consumer through shared
//     memory under named barriers; the other rescales its half by the same
//     alpha and multiplies the pair from shared memory.  Each consumer
//     keeps the row sum of its own tiles (rescaled by every tile's alpha);
//     the two meet once at the end.  A stage is released when both
//     consumers' P.V on it are done; the reader's before its own next
//     softmax, so that one pair buffer serves both consumers and the
//     producer's next load starts a step earlier.
//   KEYS 32, STAGES 4 at Dpe 64 (231 KB of shared memory; 3 at Dpe 128, 2
//   up to D + Dpe 832).  On the card 32 x 4 read 0.78 ms at b128_s8192
//   against 0.81-0.82 for 32 x 3, 1.00 for 48 x 2 and 1.26-1.27 for 32 x 2
//   (tools/mla_wgmma_ablation.py; PERF.md, PR 23): with two stages no load
//   overlaps the walk, and 48-key tiles leave room for no third.  The pair: P rounded once to 16 bits reads 10-25 bf16 ulps,
//   outside the 2-ulp limit; hi + lo keeps ~16 significant bits at twice
//   P.V's tensor work.
// * CUDA cores, for fp32 and every other shape: attention_core.cuh's online
//   softmax over strided key tiles of 16 rows (RowsLatent), up to 16 heads
//   of one latent head a block, head groups the fastest grid axis; scores,
//   softmax and P.V in fp32.
//
// Known first bottleneck (PERF.md, PR 23): the walk's own work.  The same
// walk with every load after the first stages taken out reads within ~10%
// of the full one, ~60% of the pair's dense tensor rate: the scores at N
// 32 are bound by wgmma's shared-memory reads of Q (3 KB for 32 K FMAs a
// step), and each tile's softmax hand-over orders the two consumers.

#include "hopper_core.cuh"
#include "mma_core.cuh"  // gc::store2, ac::

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;  // keys a tile

struct SeqMask {  // key j of the tile is live when it lies before the end
  int valid;
  __device__ bool operator()(int /*r*/, int j) const { return j < valid; }
};

template <typename T>
struct SeqTiles {
  using KV = ac::RowsLatent<T>;
  KV base;  // the batch row's latent head, at key 0
  int seq;

  __device__ bool tile(int t, KV& kv) const {
    kv = base.rows((long)t * kCols);
    return true;
  }
  __device__ SeqMask mask(int t) const { return {seq - t * kCols}; }
};

struct GroupRows {  // block row r is head h0 + r of batch row b
  long g0;
  __device__ long operator()(int r) const { return g0 + r; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_kernel(const T* __restrict__ q, const T* __restrict__ q_pe, const T* __restrict__ kv,
           const T* __restrict__ k_pe, T* __restrict__ out, int heads, int kv_heads, int seq,
           int d, int pe, int bh, float qscale) {
  const int hb = blockIdx.x;  // head group, the fastest-varying axis
  const int b = blockIdx.y;   // batch row
  const int group = heads / kv_heads;
  const int h0 = hb * bh, hk = h0 / group;
  const int dk = d + pe;
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), bh, kCols, dk, d);

  const GroupRows rows{(long)b * heads + h0};
  ac::load_latent_rows(sm, q, q_pe, bh, d, pe, qscale, rows);
  ac::init_state(sm, bh, d);

  const long row0 = (long)b * seq * kv_heads + hk;  // (b, s = 0, hk)
  SeqTiles<T> src{{kv + row0 * d, k_pe + row0 * pe, (long)kv_heads * d, (long)kv_heads * pe,
                   seq, d, pe},
                  seq};
  ac::attend_tiles(sm, bh, kCols, dk, d, (seq + kCols - 1) / kCols, src);
  __syncthreads();
  ac::store_rows(out + rows.g0 * d, d, sm, bh, d);
}

// ---- the wgmma kernel ---------------------------------------------------

namespace wg {
constexpr int ROWS = 64;                       // query rows a block: one wgmma m64
constexpr int D = 512;                         // the latent width, V's
constexpr int BOX = 64;                        // columns a TMA box: 128 bytes
constexpr int HALF_BOXES = D / 2 / BOX;        // V boxes a consumer multiplies
constexpr int THREADS = 3 * 128;               // the producer's warpgroup first
constexpr int Q_BOX = ROWS * BOX * 2;          // 8 KB: 64 rows of one box
constexpr int MAX_SMEM = 232448;               // the most a block may take
constexpr int MAX_DK = 832;                    // D + Dpe that 2 stages fit
constexpr int BAR_P = 1;    // + c: consumer c's tile published (P pair, row max)
constexpr int BAR_END = 3;  // the row sums exchanged

// Shared memory of a block, in bytes from a 1024-byte boundary: Q, the
// STAGES key tiles, the P pair of the tile last scored, the mbarriers and
// the row maxima and sums the consumers exchange.  A key tile is dk / 64
// boxes of KEYS rows; the pair is [hi | lo], 2 KEYS columns, in 64-column
// boxes.
template <int KEYS, int STAGES>
struct Layout {
  static constexpr int K_BOX = KEYS * BOX * 2;
  static constexpr int P_BYTES = (2 * KEYS + BOX - 1) / BOX * Q_BOX;
  int boxes;  // 64-column boxes a row of Q or of a key tile
  __host__ __device__ explicit Layout(int dk) : boxes(dk / BOX) {}
  __host__ __device__ size_t stage(int s) const {
    return (size_t)boxes * Q_BOX + (size_t)s * boxes * K_BOX;
  }
  __host__ __device__ size_t pair() const { return stage(STAGES); }
  __host__ __device__ size_t bars() const { return pair() + P_BYTES; }  // full, empty, Q's
  __host__ __device__ size_t rows() const { return bars() + 8 * (2 * STAGES + 1); }
  // + the row state (m, l: two floats a row a consumer) + room to align
  __host__ __device__ size_t bytes() const { return rows() + 4 * 4 * ROWS + 1024; }
};

// Byte offset of column col (even) of row r in a P pair under 128-byte
// swizzle.
__device__ __forceinline__ uint32_t pair_offset(int r, int col) {
  return (col / BOX) * Q_BOX + r * 128 + ((((col % BOX) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
}

// Two 16-bit values in one register, x in the low half: a wgmma A operand;
// rx, ry receive the rounded values.
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ uint32_t bits(__half x) { return __half_as_ushort(x); }
template <typename CT>
__device__ __forceinline__ uint32_t pack(float x, float y, float& rx, float& ry) {
  const CT a = ac::from_float<CT>(x), b = ac::from_float<CT>(y);
  rx = ac::to_float(a);
  ry = ac::to_float(b);
  return bits(a) | bits(b) << 16;
}

// Keeps the compiler from moving O's reads and writes across the
// asynchronous products that accumulate into it.
__device__ __forceinline__ void fence(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) hc::reg_fence(acc[i]);
}

// O's rows times their alpha: acc[4 j + 2 h + e] is row r0 + 8 h.  A warp
// whose 16 rows' maxima did not move (most tiles, once they settle) skips
// the 128 products (tools/mla_wgmma_ablation.py: "rescale always").
__device__ __forceinline__ void rescale(float (&acc)[128], const float (&a)[2]) {
  if (__all_sync(0xffffffffu, a[0] == 1.f && a[1] == 1.f)) return;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] *= a[(i / 2) % 2];
}
}  // namespace wg

// A consumer warpgroup: O's columns [256 c, 256 c + 256) and its softmax
// state.  Thread (warp w, lane) holds rows r0 = 16 w + lane / 4 and r0 + 8
// (h = 0, 1): O[:, 256 c + 8 j + 2 (lane % 4) + e] in acc[4 j + 2 h + e].
// The walk is cut into phases whose wgmma waits are unconditional, and no
// register of a product is written between the first product issued after
// a wait and the next wait: otherwise ptxas serializes every wgmma (its
// notes C7514 / C7515).
template <typename CT, int KEYS, int STAGES>
struct Consumer {
  using L = wg::Layout<KEYS, STAGES>;
  static constexpr int NS = KEYS / 2;   // score registers a thread
  static constexpr int KS = KEYS / 16;  // 16-key steps a tile
  using Pair = uint32_t[KS][4];          // P's hi or lo as wgmma A fragments
  uint8_t* smem;
  const L lay;  // one int: held by value
  uint64_t *full, *empty;
  float *row_m, *row_l;  // [2][ROWS] each: the consumers' row maxima and sums
  int c, o, n, seq, dk, tid, q4, r0;
  float qscale;
  float acc[128];
  float m_run[2], l_run[2];

  __device__ Consumer(uint8_t* smem_, const L& lay_, int c_, int seq_, int dk_, float qscale_)
      : smem(smem_), lay(lay_), c(c_), o(1 - c_), seq(seq_), dk(dk_), qscale(qscale_) {
    full = reinterpret_cast<uint64_t*>(smem + lay.bars());
    empty = full + STAGES;
    row_m = reinterpret_cast<float*>(smem + lay.rows());
    row_l = row_m + 2 * wg::ROWS;
    n = (seq + KEYS - 1) / KEYS;
    tid = threadIdx.x % 128;
    q4 = tid % 4;
    r0 = 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    m_run[0] = m_run[1] = -CUDART_INF_F;
    l_run[0] = l_run[1] = 0.f;
  }

  // B of this consumer's P.V: its 256 latent columns of stage st, keys k0..
  __device__ uint64_t v_desc(int st, int k0) const {
    return hc::sw128_desc(smem + lay.stage(st) + (size_t)c * wg::HALF_BOXES * L::K_BOX + k0 * 128,
                          L::K_BOX, 1024);
  }

  // Issue S = Q . K_t^T over all dk columns (one group).
  __device__ void score(int t, float (&s)[NS]) {
    const int st = t % STAGES;
    hc::mbar_wait(&full[st], (t / STAGES) & 1);
    const uint8_t* kt = smem + lay.stage(st);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = 0.f;
      hc::reg_fence(s[i]);
    }
    hc::wgmma_fence();
    for (int k = 0; k < dk / 16; ++k)
      hc::wgmma_m64nNk16_kk<CT, KEYS>(
          s, hc::sw128_desc(smem + (k / 4) * wg::Q_BOX + (k % 4) * 32, 16, 1024),
          hc::sw128_desc(kt + (k / 4) * L::K_BOX + (k % 4) * 32, 16, 1024), k > 0);
    hc::wgmma_commit();
  }

  // The other consumer's tile u: its row max, O rescaled, then its pair
  // from shared memory times this consumer's V half (one group).
  __device__ void read(int u) {
    const int su = u % STAGES;
    hc::bar_sync(wg::BAR_P + o, 256);
    hc::mbar_wait(&full[su], (u / STAGES) & 1);  // landed: the other scored it
    float a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mu = row_m[o * wg::ROWS + r0 + 8 * h];
      a[h] = exp2f(fmaxf(m_run[h], ac::NEG_CLAMP) - fmaxf(mu, ac::NEG_CLAMP));
      m_run[h] = mu;
      l_run[h] *= a[h];
    }
    hc::wgmma_wait<1>();  // a stage boundary: this consumer's scores may still run
    wg::fence(acc);
    wg::rescale(acc, a);
    wg::fence(acc);
    hc::wgmma_fence();
    const uint8_t* pair = smem + lay.pair();
#pragma unroll
    for (int k = 0; k < 2 * KS; ++k)  // [hi | lo] . [V; V]
      hc::wgmma_m64n256k16<CT>(
          acc, hc::sw128_desc(pair + (16 * k / wg::BOX) * wg::Q_BOX + (16 * k % wg::BOX) * 2,
                              16, 1024),
          v_desc(su, 16 * k % KEYS));
    hc::wgmma_commit();
  }

  // The softmax of tile t once its scores have landed: P as the pair in
  // registers, alpha in a; then the pair and the row max handed over.
  __device__ void softmax(int t, float (&s)[NS], float (&a)[2], Pair& ph, Pair& pl) {
#pragma unroll
    for (int i = 0; i < NS; ++i) hc::reg_fence(s[i]);
    const int valid = seq - t * KEYS;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = 8 * (i / 4) + 2 * q4 + i % 2;
      s[i] = key < valid ? s[i] * qscale : -CUDART_INF_F;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
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
        ph[j / 2][2 * (j % 2) + h] = wg::pack<CT>(p0, p1, h0, h1);
        pl[j / 2][2 * (j % 2) + h] = wg::pack<CT>(p0 - h0, p1 - h1, unused0, unused1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * a[h] + sum[h];
    }
    // the pair's one buffer: this consumer has read tile t - 1's (done_reading)
    uint8_t* pair = smem + lay.pair();
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, col = 8 * j + 2 * q4;
        *reinterpret_cast<uint32_t*>(pair + wg::pair_offset(r, col)) = ph[j / 2][2 * (j % 2) + h];
        *reinterpret_cast<uint32_t*>(pair + wg::pair_offset(r, KEYS + col)) =
            pl[j / 2][2 * (j % 2) + h];
      }
    if (q4 == 0) {
      row_m[c * wg::ROWS + r0] = m_run[0];
      row_m[c * wg::ROWS + r0 + 8] = m_run[1];
    }
    hc::fence_proxy_async();  // for the other's wgmma
    __threadfence_block();     // for its loads of the row max
    hc::bar_arrive(wg::BAR_P + c, 256);
  }

  // Tile t's scores and the other's tile t - 1's P.V are done: release
  // tile t - 1's stage (before this softmax, so that the next load starts
  // early) and free the pair's buffer for tile t's.
  __device__ void done_reading(int t) {
    hc::wgmma_wait<0>();
    wg::fence(acc);
    if (tid == 0) hc::mbar_arrive(&empty[(t - 1) % STAGES]);
  }

  // O = O a + P_hi . V + P_lo . V for tile t, the pair from registers; its
  // stage released once done.
  __device__ void own_pv(int t, const float (&a)[2], Pair& ph, Pair& pl) {
    wg::rescale(acc, a);
    wg::fence(acc);
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(ph[k][e]), "+r"(pl[k][e])::"memory");
    hc::wgmma_fence();
    const int st = t % STAGES;
#pragma unroll
    for (int k = 0; k < KS; ++k) hc::wgmma_m64n256k16_rs<CT>(acc, ph[k], v_desc(st, 16 * k));
#pragma unroll
    for (int k = 0; k < KS; ++k) hc::wgmma_m64n256k16_rs<CT>(acc, pl[k], v_desc(st, 16 * k));
    hc::wgmma_commit();
    hc::wgmma_wait<0>();
    wg::fence(acc);
    if (tid == 0) hc::mbar_arrive(&empty[st]);
  }

  // O / max(l, 1e-30) with l both consumers' row sums, rounded once; block
  // rows from `rows` on are not stored.
  __device__ void store(CT* __restrict__ out, long orow0, int rows) {
    hc::wgmma_wait<0>();
    wg::fence(acc);
    if (q4 == 0) {
      row_l[c * wg::ROWS + r0] = l_run[0];
      row_l[c * wg::ROWS + r0 + 8] = l_run[1];
    }
    hc::bar_sync(wg::BAR_END, 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float inv = 1.f / fmaxf(l_run[h] + row_l[o * wg::ROWS + r], 1e-30f);
      if (r >= rows) continue;
      CT* dst = out + (orow0 + r) * wg::D + c * (wg::D / 2) + 2 * q4;
#pragma unroll
      for (int j = 0; j < wg::D / 2 / 8; ++j)
        gc::store2(dst + 8 * j, acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
};

// Consumer c's walk: its tiles t = c, c + 2, ..., each after the other's
// tile t - 1, then the other's last tile if that is the last of all.  A
// step: tile t's scores issued; the other's tile t - 1 read and its P.V
// issued; both done (tile t - 1's stage released before this softmax, so
// that the producer's next load starts early; the pair's one buffer free);
// the softmax, its pair and row max handed over; this consumer's P.V.
template <typename CT, int KEYS, int STAGES>
__device__ __forceinline__ void mla_consume(uint8_t* smem, const wg::Layout<KEYS, STAGES>& lay,
                                            int c, CT* __restrict__ out, long orow0, int rows,
                                            int seq, int dk, float qscale) {
  using W = Consumer<CT, KEYS, STAGES>;
  W w(smem, lay, c, seq, dk, qscale);
  const int n = w.n;
  hc::mbar_wait(w.full + 2 * STAGES, 0);  // Q
  int t = c;
  if (c == 0) {  // tile 0: nothing of the other's before it
    float s[W::NS], a[2];
    typename W::Pair ph, pl;
    w.score(0, s);
    hc::wgmma_wait<0>();
    w.softmax(0, s, a, ph, pl);
    w.own_pv(0, a, ph, pl);
    t = 2;
  }
  for (; t < n; t += 2) {
    float s[W::NS], a[2];
    typename W::Pair ph, pl;
    w.score(t, s);
    w.read(t - 1);
    w.done_reading(t);
    w.softmax(t, s, a, ph, pl);
    w.own_pv(t, a, ph, pl);
  }
  if (t == n) w.read(n - 1);
  w.store(out, orow0, rows);
}

template <typename CT, int KEYS, int STAGES>
__global__ void __launch_bounds__(wg::THREADS, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tqpe,
                 const __grid_constant__ CUtensorMap tkv,
                 const __grid_constant__ CUtensorMap tkpe, CT* __restrict__ out, int heads,
                 int kv_heads, int seq, int dk, float qscale) {
  using namespace wg;
  using L = Layout<KEYS, STAGES>;
  extern __shared__ float4 smem4[];  // one declaration for both kernels of the file
  uint8_t* raw = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* smem = raw + ((1024 - (hc::smem_addr(raw) & 1023)) & 1023);
  const L lay(dk);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars());
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;  // the consumers wait on it in mla_consume

  const int group = heads / kv_heads, per_head = (group + ROWS - 1) / ROWS;
  const int hk = blockIdx.x / per_head, part = blockIdx.x % per_head;
  const int b = blockIdx.y;
  const int h0 = hk * group + part * ROWS;
  const long qrow0 = (long)b * heads + h0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hc::mbar_init(&full[s], 1);
      hc::mbar_init(&empty[s], 2);  // both consumers release a stage
    }
    hc::mbar_init(qbar, 1);
    hc::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: one thread issues every copy
    hc::regs_dec<40>();
    if (threadIdx.x == 0) {
      const int pe = dk - D, n = (seq + KEYS - 1) / KEYS;
      hc::mbar_expect_tx(qbar, lay.boxes * Q_BOX);
      for (int j = 0; j < lay.boxes; ++j)
        hc::tma_load_2d(smem + j * Q_BOX, j < D / BOX ? &tq : &tqpe, qbar,
                        (j < D / BOX ? j : j - D / BOX) * BOX, (int)qrow0);
      for (int u = 0; u < n; ++u) {
        const int s = u % STAGES, r = u / STAGES;
        if (r > 0) hc::mbar_wait(&empty[s], (r - 1) & 1);  // its (r - 1)-th release
        uint8_t* kt = smem + lay.stage(s);
        hc::mbar_expect_tx(&full[s], lay.boxes * L::K_BOX);
        for (int j = 0; j < lay.boxes; ++j) {
          if (j < D / BOX)
            hc::tma_load_3d(kt + j * L::K_BOX, &tkv, &full[s], hk * D + j * BOX, u * KEYS, b);
          else
            hc::tma_load_3d(kt + j * L::K_BOX, &tkpe, &full[s], hk * pe + (j - D / BOX) * BOX,
                            u * KEYS, b);
        }
      }
    }
    return;
  }
  hc::regs_inc<232>();
  mla_consume<CT, KEYS, STAGES>(smem, lay, threadIdx.x / 128 - 1, out, qrow0,
                                min(ROWS, group - part * ROWS), seq, dk, qscale);
}

template <typename CT, int KEYS, int STAGES>
int launch_wgmma(const void* q, const void* q_pe, const void* kv, const void* k_pe, void* out,
                 int batch, int heads, int kv_heads, int seq, int pe, float sm_scale,
                 cudaStream_t stream) {
  using namespace wg;
  const int dk = D + pe;
  const size_t smem = Layout<KEYS, STAGES>(dk).bytes();
  const uint64_t qrows = (uint64_t)batch * heads, wkv = (uint64_t)kv_heads * D,
                 wpe = (uint64_t)kv_heads * pe;
  CUtensorMap tq, tqpe, tkv, tkpe;
  if (smem > (size_t)MAX_SMEM || !hc::tensor_map_2d<CT>(&tq, q, qrows, D, D, ROWS) ||
      !hc::tensor_map_2d<CT>(&tqpe, q_pe, qrows, pe, pe, ROWS) ||
      !hc::tensor_map_3d<CT>(&tkv, kv, batch, seq, wkv, wkv, seq * wkv, KEYS) ||
      !hc::tensor_map_3d<CT>(&tkpe, k_pe, batch, seq, wpe, wpe, seq * wpe, KEYS))
    return (int)cudaErrorInvalidValue;
  auto kernel = mla_wgmma_kernel<CT, KEYS, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_head = (heads / kv_heads + ROWS - 1) / ROWS;
  dim3 grid(per_head * kv_heads, batch);
  kernel<<<grid, THREADS, smem, stream>>>(tq, tqpe, tkv, tkpe, (CT*)out, heads, kv_heads, seq,
                                          dk, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// 32-key tiles in as many stages, four to two, as fit beside Q.
template <typename CT>
int launch_tc(const void* q, const void* q_pe, const void* kv, const void* k_pe, void* out,
              int batch, int heads, int kv_heads, int seq, int pe, float sm_scale,
              cudaStream_t stream) {
  const int dk = wg::D + pe;
  if (wg::Layout<32, 4>(dk).bytes() <= (size_t)wg::MAX_SMEM)
    return launch_wgmma<CT, 32, 4>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, pe,
                                   sm_scale, stream);
  if (wg::Layout<32, 3>(dk).bytes() <= (size_t)wg::MAX_SMEM)
    return launch_wgmma<CT, 32, 3>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, pe,
                                   sm_scale, stream);
  return launch_wgmma<CT, 32, 2>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, pe,
                                 sm_scale, stream);
}

// Whether the wgmma kernel takes a launch: 16-bit elements, D = 512, D + Dpe
// a multiple of 64 up to MAX_DK (two stages of 32-key tiles fit beside Q).
inline bool tc_takes(int dtype, int d, int pe) {
  return dtype != 0 && d == wg::D && pe > 0 && (d + pe) % 64 == 0 && d + pe <= wg::MAX_DK;
}

// ---- the CUDA-core kernel's launch ------------------------------------------

template <typename T>
int launch(const void* q, const void* q_pe, const void* kv, const void* k_pe, void* out,
           int batch, int heads, int kv_heads, int seq, int d, int pe, int bh, float sm_scale,
           cudaStream_t stream) {
  if (batch < 1 || seq < 1 || kv_heads < 1 || heads % kv_heads != 0 || bh < 1 ||
      (heads / kv_heads) % bh != 0 || batch > 65535 ||
      !ac::RowsLatent<T>::shapes_ok(kCols, d, pe, kThreads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ac::Smem::latent_bytes(bh, kCols, d + pe, d);
  auto kernel = mla_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads / bh, batch);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)q_pe, (const T*)kv,
                                           (const T*)k_pe, (T*)out, heads, kv_heads, seq, d, pe,
                                           bh, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  tc: the caller's route,
// which must be tc_takes(dtype, d, pe): the wgmma kernel (16-bit at D = 512,
// D + Dpe a multiple of 64 up to 832; q, q_pe, kv, k_pe 16-byte aligned),
// or the CUDA-core kernel, where bh heads share a block (it must divide
// heads / kv_heads).  Needs D and Dpe multiples of 16 bytes' worth of
// elements and 16-byte aligned, contiguous tensors.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int mla_launch(int dtype, int tc, const void* q, const void* q_pe, const void* kv,
                          const void* k_pe, void* out, int batch, int heads, int kv_heads,
                          int seq, int d, int pe, int bh, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tc != (int)tc_takes(dtype, d, pe)) return (int)cudaErrorInvalidValue;
  if (tc) {
    if (batch < 1 || batch > 65535 || seq < 1 || kv_heads < 1 || heads % kv_heads != 0)
      return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return launch_tc<__nv_bfloat16>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, pe,
                                      sm_scale, s);
    return launch_tc<__half>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, pe, sm_scale,
                             s);
  }
  if (dtype == 0)
    return launch<float>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, d, pe, bh,
                         sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, d, pe, bh,
                                 sm_scale, s);
  if (dtype == 2)
    return launch<__half>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, d, pe, bh,
                          sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
