// The tensor-core step of multi-head latent attention (MLA), shared by the
// contiguous FlashMLA decode (mla.cu), the paged chunked prefill
// (mla_prefill.cu) and the split-KV paged decode (mla_paged.cu).
//
// MLA scores a key of width dk = D + Dpe (the latent plus its rope part)
// and takes as value the key's first D = 512 columns: every query row of a
// block attends the same latent head, so one key tile in shared memory
// serves all of them.  A block holds R query rows (a multiple of 16: 64 for
// FlashMLA and the prefill, 16 for the decode's heads) and 8 R threads, R /
// 16 m-tiles x four column quarters of warps; per tile of 32 keys:
//   - scores: warp (m-tile, quarter) multiplies its 16 rows' queries by the
//     tile over a quarter of the dk columns (mma.sync m16n8k16, fp32 sums);
//     the four partial sums meet in shared memory in a fixed order;
//   - the online softmax in fp32, 8 lanes a row (exp2 on log2e-scaled
//     scores, NEG_CLAMP, safe_div, as attention_core.cuh); the caller's
//     mask says which (row, key) scores are live;
//   - P.V: the fp32 probabilities go to the tensor cores as two 16-bit
//     terms, p = hi + lo (hi = p rounded, lo = the rest rounded), so they
//     keep ~16 significant bits where one bf16 term would keep 8; warp
//     (m-tile, quarter) accumulates 16 rows x 128 columns of the output,
//     V read from the key tile by ldmatrix.trans.
// Key tiles are double-buffered: while tile t is scored, the loader's
// copies of tile t + 1 are in flight.  Three barriers a tile.  Rows are
// padded to dk + 8 elements, so the 8 rows of one ldmatrix fall on
// distinct banks.
//
// The two kernels differ in what they hand `attend`: where Q rows come
// from, how a key tile is loaded (a contiguous run of keys; pages through a
// block table, dequantized on the way in), which scores are live, and where
// output rows go.  `attend` leaves the unnormalised state: `finish`
// normalises it, or a split-KV kernel stores it for a merge.

#pragma once

#include "mma_core.cuh"

namespace mm {

constexpr int ROWS = 64;      // query rows a block (FlashMLA's and the prefill's)
constexpr int KEYS = 32;      // keys a tile
constexpr int THREADS = 512;  // 16 warps: (m-tile, column quarter)
constexpr int D = 512;        // the latent width, V's
constexpr int SPS = KEYS + 4; // row stride of the partial scores (floats)
constexpr int PS = KEYS + 8;  // row stride of the probability terms

// Threads of a block of `rows` query rows: rows / 16 m-tiles x 4 quarters.
__host__ __device__ constexpr int threads(int rows) { return 8 * rows; }

// Shared memory of a block: Q, two key tiles (row stride ks elements), the
// probability pair, the four partial score sums and the softmax state.
// Whatever a kernel adds goes at end().
template <typename CT, int R = ROWS>
struct Smem {
  CT *qs, *k0, *k1, *ph, *pl;
  float *sp, *m, *l, *alpha;

  __device__ Smem(void* base, int ks) {
    qs = reinterpret_cast<CT*>(base);
    k0 = qs + R * ks;
    k1 = k0 + KEYS * ks;
    ph = k1 + KEYS * ks;
    pl = ph + R * PS;
    sp = reinterpret_cast<float*>(pl + R * PS);
    m = sp + 4 * R * SPS;
    l = m + R;
    alpha = l + R;
  }
  // key tile stage s (a select, not an indexed array: that would live in
  // local memory)
  __device__ CT* kt(int s) const { return s ? k1 : k0; }
  __device__ void* end() const { return alpha + R; }
  static size_t bytes(int ks) {  // a multiple of 16 for ks a multiple of 8
    return sizeof(CT) * ((size_t)(R + 2 * KEYS) * ks + 2 * R * PS) +
           sizeof(float) * (4 * R * SPS + 3 * R);
  }
};

// Start the copies of the block's Q rows [q | q_pe]: block row r from row
// qrow(r) of q (D values a row) and q_pe (pe a row), or zeros where qrow(r)
// < 0.  The caller commits them with the first tile.
template <typename CT, int R, typename QRow>
__device__ void load_q(const Smem<CT, R>& sm, int ks, const CT* __restrict__ q,
                       const CT* __restrict__ q_pe, int pe, const QRow& qrow) {
  const int chunks = (D + pe) / 8;
  for (int i = threadIdx.x; i < R * chunks; i += threads(R)) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const long g = qrow(r);
    const bool p = g >= 0;
    const CT* src = c < D ? q + g * D + c : q_pe + g * pe + (c - D);
    gc::cp_async<16>(sm.qs + r * ks + c, p ? src : q, p);
  }
}

using Acc = gc::WarpAcc<1, D / 4 / 8>;  // a warp's 16 rows x 128 columns of O

// The online softmax over n key tiles into `o`, unnormalised: O, with the
// running max and row sum left in sm.m and sm.l.  The loader:
//   issue(u, stage)  at the top of the step before tile u's, once the
//                    stage is free: starts tile u's copies into it
//                    (committed here, with Q for tile 0);
//   first()          after tile 0's copies are committed;
//   landed(more)     in every thread before the barrier that ends each
//                    tile's softmax (more: a next tile is in flight);
//   convert(u)       after the tile's P.V, for the next tile u: may fill
//                    stage u % 2 from what landed, and start tile u + 1.
// A loader that copies straight into the tile does nothing in the last
// three.  mask(t, r, j): whether key j of tile t is live for block row r.
template <typename CT, int R, typename Load, typename Mask>
__device__ void attend(const Smem<CT, R>& sm, Acc& o, int n, int dk, int ks, Load& ld,
                       const Mask& mask, float qscale) {
  constexpr int MTS = R / 16;  // m-tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % MTS, quarter = warp / MTS;
  if (threadIdx.x < R) {
    sm.m[threadIdx.x] = -CUDART_INF_F;
    sm.l[threadIdx.x] = 0.f;
  }
  if (n > 0) ld.issue(0, 0);
  gc::cp_async_commit();
  if (n > 0) ld.first();
  o.zero();
  const int dq = dk / 4;
  for (int t = 0; t < n; ++t) {
    gc::cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; tile t - 1 fully consumed
    if (t + 1 < n) ld.issue(t + 1, (t + 1) & 1);
    gc::cp_async_commit();
    const CT* kt = sm.kt(t & 1);
    {  // partial scores over this warp's quarter of the dk columns
      gc::WarpAcc<1, KEYS / 8> s;
      s.zero();
      s.mma_span<CT>(sm.qs + quarter * dq, ks, kt + quarter * dq, ks, mt * 16, 0, dq);
      s.store(sm.sp + quarter * R * SPS, SPS, R, KEYS, mt * 16, 0);
    }
    __syncthreads();
    {  // online softmax: 8 lanes a row, 4 keys a lane
      const int r = threadIdx.x >> 3, k0 = (threadIdx.x & 7) * 4;
      float sc[4], mx = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = r * SPS + k0 + e;
        const float v = ((sm.sp[j] + sm.sp[R * SPS + j]) + sm.sp[2 * R * SPS + j]) +
                        sm.sp[3 * R * SPS + j];
        sc[e] = mask(t, r, k0 + e) ? v * qscale : -CUDART_INF_F;
        mx = fmaxf(mx, sc[e]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm.m[r];
      const float m_cur = fmaxf(m_prev, mx), mc = fmaxf(m_cur, ac::NEG_CLAMP);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(sc[e] - mc);
        const CT hi = gc::from_float<CT>(pr);
        sum += pr;
        sm.ph[r * PS + k0 + e] = hi;
        sm.pl[r * PS + k0 + e] = gc::from_float<CT>(pr - gc::to_float(hi));
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();  // every lane has read m[r] before its owner rewrites it
      if ((threadIdx.x & 7) == 0) {
        const float a = exp2f(fmaxf(m_prev, ac::NEG_CLAMP) - mc);
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_cur;
        sm.alpha[r] = a;
      }
    }
    ld.landed(t + 1 < n);
    __syncthreads();
    {  // o = o * alpha + (hi + lo) . V over this warp's quarter of D
      const int g = lane >> 2;
      const float f[1][2] = {{sm.alpha[mt * 16 + g], sm.alpha[mt * 16 + g + 8]}};
      o.scale_rows(f);
      const CT* v = kt + quarter * (D / 4);
      o.template mma_tile<CT, KEYS, true>(sm.ph, PS, v, ks, mt * 16, 0);
      o.template mma_tile<CT, KEYS, true>(sm.pl, PS, v, ks, mt * 16, 0);
    }
    if (t + 1 < n) ld.convert(t + 1);
  }
  if (n == 0) {  // no tile: Q's copies and the state's writes still settle
    gc::cp_async_wait<0>();
    __syncthreads();
  }
}

// o / max(l, 1e-30) after `attend`: a row with no live key emits 0.
template <typename CT, int R>
__device__ void finish(const Smem<CT, R>& sm, Acc& o) {
  const int mt = (threadIdx.x >> 5) % (R / 16), g = (threadIdx.x & 31) >> 2;
  const float f[1][2] = {{1.f / fmaxf(sm.l[mt * 16 + g], 1e-30f),
                          1.f / fmaxf(sm.l[mt * 16 + g + 8], 1e-30f)}};
  o.scale_rows(f);
}

// Store this warp's share of the output, rounded once to CT (or kept in
// fp32): block row r of a block of R rows at row orow(r) of out (D values
// a row), not stored where orow(r) < 0.
template <int R = ROWS, typename CT, typename ORow>
__device__ void store(const Acc& o, CT* __restrict__ out, const ORow& orow) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % (R / 16), quarter = warp / (R / 16), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long row = orow(mt * 16 + g + 8 * h);
    if (row < 0) continue;
    CT* dst = out + row * D + quarter * (D / 4) + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 4 / 8; ++j)
      gc::store2(dst + j * 8, o.c[0][j][2 * h], o.c[0][j][2 * h + 1]);
  }
}

}  // namespace mm
