// The tensor-core online softmax shared by the bf16 flash-attention forward
// (flash_attention.cu) and the bf16 chunked-prefill kernel
// (prefill_attention.cu).
//
// Counterpart of repro/kernels/attention_core.py (OnlineSoftmax) for
// Hopper's tensor cores, with the numerics of attention_core.cuh:
//
//   * scores in the log2 domain: S = Q.K^T is summed in fp32 by mma.sync
//     from the unscaled bf16 inputs, then multiplied by sm_scale * log2(e)
//     in fp32 (the plain version scales in fp32 too: no extra rounding of
//     q), and every exponential is an exp2;
//   * the running max is clamped at NEG_CLAMP before differencing, so a
//     fully masked tile leaves no NaN;
//   * the output divides by max(l, 1e-30) (safe_div): a row with no live
//     key emits 0.
//
// Per warp: 16 query rows.  Q lives in registers as bf16 A fragments of
// m16n8k16 (loaded once with ldmatrix); S (16 x 64 keys) and O (16 x D) in
// fp32 registers; the row max by quad shuffles.  The S accumulator turns
// into P's A fragments in registers (the C and A layouts of m16n8k16 line
// up), as a pair p = hi + lo, hi = bf16(p) and lo = bf16(p - hi): the TPU
// template multiplies fp32 probabilities by V (attention_core.py:104-112).
// One bf16 rounding of p reads 22-122 bf16 ulps from the plain value on the
// card at qwen2-1.5B's shapes (chip_smoke.py's bf16_p_ulps control), over
// the limit of 2; the pair keeps ~16 significant bits and reads 1.00 ulp.
// So P.V is two tensor-core products, O += hi.V + lo.V, with V read by
// ldmatrix.trans: 1.5x the tensor-core work of one.  O is rounded once, at
// the store.
//
// Per block: K/V tiles of 64 keys arrive in bf16 through a ring of S stages
// of cp.async (16 B a copy, rows with no live key zero-filled, so a masked
// probability never multiplies garbage: 0 * NaN is NaN); while tile t is
// scored, the next S - 1 are in flight, and one barrier a tile separates
// them.  Each tile carries the absolute position of each of its keys (-1:
// no live key) in shared memory beside it, written by the threads that copy
// the rows, so one positional mask serves paged, chunk and contiguous keys;
// each thread computes its rows' query positions once.  Q is copied through
// the last stage before the first tile needs it.  Rows are padded to D + 8
// elements (16 bytes), so the 8 rows of one ldmatrix fall on distinct
// banks.  A block whose grid leaves SMs idle can split its key walk between
// two groups of warps (key groups, KG): each group scores every other tile
// against the same rows, and the two softmax states merge through shared
// memory at the end, as two halves of a split-KV would.

#pragma once

#include "mma_core.cuh"

namespace am {

using bf16 = __nv_bfloat16;

constexpr int KEYS = 64;  // keys a tile
constexpr int MAX_ROWS = 128;  // query rows a block: Q fits one stage

struct Strides {  // elements between batches, heads and rows
  long b, h, s;
};

// Shared memory of a block: S stages of KG slots of [K tile | V tile] (Q
// borrows the last slot before the first tile is scored), then each slot's
// key positions.  KG > 1 splits the key walk between KG groups of warps
// (key groups): group g scores tiles g, g + KG, ... against the same query
// rows, and the groups' softmax states merge at the end.
template <int D, int S, int KG = 1>
struct Ring {
  static_assert(S >= 2, "a ring of at least two stages");
  static constexpr int STRIDE = D + 8;  // elements between rows
  static constexpr int TILE = KEYS * STRIDE;
  static constexpr int SLOTS = S * KG;
  bf16* base;

  __device__ explicit Ring(void* smem) : base(reinterpret_cast<bf16*>(smem)) {}
  __device__ bf16* k(int s) const { return base + 2 * s * TILE; }
  __device__ bf16* v(int s) const { return base + (2 * s + 1) * TILE; }
  __device__ int* kpos(int s) const {
    return reinterpret_cast<int*>(base + 2 * SLOTS * TILE) + s * KEYS;
  }
  __device__ bf16* q() const { return k(SLOTS - 1); }
  static constexpr size_t bytes() {
    return sizeof(bf16) * 2 * SLOTS * (size_t)TILE + sizeof(int) * SLOTS * KEYS;
  }
};

// Copy `rows` query rows into Q's place: row r from row(r), a pointer or
// nullptr (a dead row, zero-filled, so that its scores stay finite).
// `any` is a readable address for the zero-filling copies.
template <typename Ring, typename QRow>
__device__ void load_q_async(const Ring& ring, int rows, const QRow& row, const bf16* any) {
  constexpr int CH = (Ring::STRIDE - 8) / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bf16* p = row(r);
    gc::cp_async<16>(ring.q() + r * Ring::STRIDE + c, p ? p + c : any, p != nullptr);
  }
}

// Copy key tile t into slot s: src.row(t, r, kp, vp, pos) gives key row r's
// K and V rows and its absolute position, or returns false (zero-filled,
// position -1).
template <typename Ring, typename Src>
__device__ void load_tile_async(const Ring& ring, int s, int t, const Src& src,
                                const bf16* any) {
  constexpr int CH = (Ring::STRIDE - 8) / 8;
  bf16 *kd = ring.k(s), *vd = ring.v(s);
  int* kpos = ring.kpos(s);
  for (int i = threadIdx.x; i < KEYS * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bf16 *kp = any, *vp = any;
    int pos = -1;
    const bool live = src.row(t, r, kp, vp, pos);
    gc::cp_async<16>(kd + r * Ring::STRIDE + c, live ? kp + c : any, live);
    gc::cp_async<16>(vd + r * Ring::STRIDE + c, live ? vp + c : any, live);
    if (c == 0) kpos[r] = live ? pos : -1;
  }
}

// Block row r holds the query at position q0 + r / group.  Key column c of
// the tile is live for a query at position qp when it holds a key, the key
// is not past the query (causal) and lies inside the window.
struct PosMask {
  const int* kpos;
  int q0, group, window;
  bool causal;
  __device__ int qpos(int r) const { return q0 + r / group; }
  __device__ bool live(int qp, int c) const {
    const int kp = kpos[c];
    return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
  }
};

// What a warp does with a tile.
enum TileKind { SKIP = 0, FULL = 1, MASKED = 2 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = hi + lo for two neighbouring probabilities, each half a bf16 pair
// (the lower column in the low 16 bits, as mma's A fragment wants).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// One warp's 16 query rows through the online softmax.
template <int D>
struct WarpAttention {
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  static constexpr int KT = D / 16;    // k-steps of Q.K^T
  static constexpr int NT = KEYS / 8;  // n-tiles of S
  static constexpr int OT = D / 8;     // n-tiles of O
  static constexpr int ST = D + 8;     // elements between rows in the ring
  static constexpr int FIELDS = 4 + 4 * OT;  // floats of one thread's state
  uint32_t qf[KT][4];
  int row0;   // the warp's first block row
  int qp[2];  // positions of the thread's rows g and g + 8
  float o[OT][4];
  float m[2], l[2];  // rows g and g + 8; l is this thread's share of the row sum

  // Q fragments of block rows [r0, r0 + 16) from Q's place in the ring.
  template <typename Mask>
  __device__ void load_q(const bf16* qs, int r0, const Mask& mask) {
    const int lane = threadIdx.x & 31, g = lane >> 2;
    row0 = r0;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      gc::ldmatrix_x4(qf[kk], qs + (r0 + (lane & 15)) * ST + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      qp[rr] = mask.qpos(r0 + g + 8 * rr);
      m[rr] = -CUDART_INF_F;
      l[rr] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }

  // Fold one tile of KEYS keys (K and V stored [key][d]) into the running
  // softmax; with MASKED, mask.live says which scores are live.
  template <bool MASKED, typename Mask>
  __device__ void tile(const bf16* ks, const bf16* vs, float qscale, const Mask& mask) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        gc::ldmatrix_x4(b, ks + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * ST + kk * 16 +
                               ((lane >> 3) & 1) * 8);
        gc::mma16816<bf16>(s[j], qf[kk], b[0], b[1]);
        gc::mma16816<bf16>(s[j + 1], qf[kk], b[2], b[3]);
      }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * qscale;
        if (MASKED && !mask.live(qp[e >> 1], j * 8 + 2 * t + (e & 1))) x = -CUDART_INF_F;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mc[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_cur = fmaxf(m[rr], mx[rr]);
      mc[rr] = fmaxf(m_cur, ac::NEG_CLAMP);
      alpha[rr] = exp2f(fmaxf(m[rr], ac::NEG_CLAMP) - mc[rr]);
      m[rr] = m_cur;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mc[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      uint32_t ph[4], pl[4];  // A fragments of P's keys [16 kk, 16 kk + 16)
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t b[4];
        gc::ldmatrix_x4_trans(b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST +
                                     j * 8 + (lane >> 4) * 8);
        gc::mma16816<bf16>(o[j], ph, b[0], b[1]);
        gc::mma16816<bf16>(o[j], pl, b[0], b[1]);
        gc::mma16816<bf16>(o[j + 1], ph, b[2], b[3]);
        gc::mma16816<bf16>(o[j + 1], pl, b[2], b[3]);
      }
    }
  }

  // The state as FIELDS floats at x[f * stride], f the field.
  __device__ void save(float* x, int stride) const {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      x[rr * stride] = m[rr];
      x[(2 + rr) * stride] = l[rr];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(4 + 4 * j + e) * stride] = o[j][e];
  }

  // Merge a state saved by the same lane of another key group (the same
  // rows and columns, other keys): both rescaled to the larger running max,
  // clamped at NEG_CLAMP as in tile().
  __device__ void absorb(const float* x, int stride) {
    float a[2], b[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m1 = x[rr * stride], l1 = x[(2 + rr) * stride];
      const float mc = fmaxf(fmaxf(m[rr], m1), ac::NEG_CLAMP);
      a[rr] = exp2f(fmaxf(m[rr], ac::NEG_CLAMP) - mc);
      b[rr] = exp2f(fmaxf(m1, ac::NEG_CLAMP) - mc);
      m[rr] = fmaxf(m[rr], m1);
      l[rr] = l[rr] * a[rr] + l1 * b[rr];
    }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = o[j][e] * a[e >> 1] + x[(4 + 4 * j + e) * stride] * b[e >> 1];
  }

  // out = O / max(l, 1e-30), rounded once: row(r) is block row r in device
  // memory, or nullptr (not stored).
  template <typename ORow>
  __device__ void store(const ORow& row) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[rr] + __shfl_xor_sync(0xffffffffu, l[rr], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      bf16* dst = row(row0 + g + 8 * rr);
      if (dst == nullptr) continue;
      const float den = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int j = 0; j < OT; ++j)
        gc::store2(dst + j * 8 + 2 * t, o[j][2 * rr] / den, o[j][2 * rr + 1] / den);
    }
  }

  // The unnormalised state, for a merge in another pass (split-KV): block
  // row r's O at os + idx(r) * D in fp32, its running max (clamped at
  // NEG_CLAMP) at ms[idx(r)] and its row sum at ls[idx(r)]; idx(r) < 0: not
  // stored.
  template <typename Idx>
  __device__ void store_state(float* os, float* ms, float* ls, const Idx& idx) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[rr] + __shfl_xor_sync(0xffffffffu, l[rr], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const long i = idx(row0 + g + 8 * rr);
      if (i < 0) continue;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        gc::store2(os + i * D + j * 8 + 2 * t, o[j][2 * rr], o[j][2 * rr + 1]);
      if (t == 0) {
        ms[i] = fmaxf(m[rr], ac::NEG_CLAMP);
        ls[i] = lt;
      }
    }
  }
};

// A key source whose tiles reach the ring through a staging area of its
// own declares STAGED (the quantized prefill's loader: packed bytes copied
// in, dequantized into the ring's bf16 tile); any other copies straight
// into the ring with load_tile_async.
template <typename Src, typename = void>
struct is_staged : std::false_type {};
template <typename Src>
struct is_staged<Src, std::void_t<decltype(Src::STAGED)>> : std::bool_constant<Src::STAGED> {};

// The block's pass over n key tiles.  The block's warps form KG key groups
// of W = blockDim.x / 32 / KG warps; warp w is warp w % W of group w / W and
// holds query rows [16 (w % W), 16 (w % W) + 16).  Q's 16 W rows (qrow(r))
// are copied in and held by each group's warps as fragments; then the ring
// takes KG tiles a step, one a group, S - 1 steps in flight while one is
// scored, one barrier a step.
// src.row(...) as load_tile_async; src.kind(t, r0, r1) says whether a warp
// of block rows [r0, r1) skips tile t, takes it whole or masks it with
// `mask` (whose kpos the pass points at the tile's slot).
// A staged source (is_staged, two stages) instead has copy(u, any), which
// starts step u's copies into its staging area and touches no ring slot,
// and convert(ring, u), which fills stage u % 2 (tiles and key positions)
// from what it staged, each thread from the bytes it copied itself, so no
// barrier lies between the two.  Each thread converts step u + 1 after its
// share of step u (stage (u + 1) % 2 was freed by the step's barrier) and
// then starts step u + 2's copies into the bytes it has just read; those
// stay uncommitted past the next barrier's wait, so they have a whole step
// to land.
// With KG > 1 the groups' states merge into group 0 through shared memory
// (the ring's, after the walk).  Leaves group 0's rows in its warps' `wa`.
template <int D, int S, int KG, typename QRow, typename Src>
__device__ void attend(WarpAttention<D>& wa, const Ring<D, S, KG>& ring, const QRow& qrow,
                       int n, Src& src, PosMask mask, float qscale, const bf16* any) {
  constexpr bool STAGED = is_staged<Src>::value;
  static_assert(!STAGED || S == 2, "a staged source converts into two stages");
  const int warps = blockDim.x / 32 / KG;
  const int warp = (threadIdx.x >> 5) % warps, group = (threadIdx.x >> 5) / warps;
  const int r0 = warp * 16;  // the warp's block rows [r0, r0 + 16)
  const int steps = (n + KG - 1) / KG;
  auto load_step = [&](int u) {  // tiles u KG .. u KG + KG - 1 into stage u % S
    if constexpr (!STAGED) {
#pragma unroll
      for (int g = 0; g < KG; ++g)
        if (u * KG + g < n) load_tile_async(ring, (u % S) * KG + g, u * KG + g, src, any);
    }
  };
  load_q_async(ring, warps * 16, qrow, any);  // into the last slot
  if constexpr (!STAGED) {
    for (int u = 0; u < S - 1; ++u) {  // one commit group a stage: Q rides with the first
      if (u < steps) load_step(u);
      gc::cp_async_commit();
    }
    gc::cp_async_wait<S - 2>();
    __syncthreads();
    wa.load_q(ring.q(), r0, mask);
    for (int u = 0; u < steps; ++u) {
      gc::cp_async_wait<S - 2>();
      __syncthreads();  // step u landed for all; step u - 1 (and Q) fully read
      if (u + S - 1 < steps) load_step(u + S - 1);
      gc::cp_async_commit();
      const int t = u * KG + group;
      if (t >= n) continue;
      const int kind = src.kind(t, r0, r0 + 16);  // uniform across the warp
      if (kind == SKIP) continue;
      const int slot = (u % S) * KG + group;
      if (kind == FULL) {
        wa.template tile<false>(ring.k(slot), ring.v(slot), qscale, mask);
      } else {
        mask.kpos = ring.kpos(slot);
        wa.template tile<true>(ring.k(slot), ring.v(slot), qscale, mask);
      }
    }
  } else {  // step 0 converted into stage 0, step 1 on its way
    if (steps > 0) src.copy(0, any);
    gc::cp_async_commit();  // with Q
    gc::cp_async_wait<0>();
    if (steps > 0) src.convert(ring, 0);
    if (steps > 1) src.copy(1, any);
    __syncthreads();
    wa.load_q(ring.q(), r0, mask);
    for (int u = 0; u < steps; ++u) {
      __syncthreads();  // step u converted for all; step u - 1 (and Q) fully read
      const int t = u * KG + group;
      const int kind = t < n ? src.kind(t, r0, r0 + 16) : SKIP;  // uniform across the warp
      const int slot = (u % S) * KG + group;
      if (kind == FULL) {
        wa.template tile<false>(ring.k(slot), ring.v(slot), qscale, mask);
      } else if (kind == MASKED) {
        mask.kpos = ring.kpos(slot);
        wa.template tile<true>(ring.k(slot), ring.v(slot), qscale, mask);
      }
      if (u + 1 < steps) {
        gc::cp_async_commit();
        gc::cp_async_wait<0>();  // this thread's copies of step u + 1
        src.convert(ring, u + 1);
        if (u + 2 < steps) src.copy(u + 2, any);
      }
    }
  }
  if (KG > 1) {
    constexpr int FIELDS = WarpAttention<D>::FIELDS;
    using R = Ring<D, S, KG>;
    static_assert(4 * FIELDS * 2 * MAX_ROWS * (KG - 1) <= 2 * 2 * R::SLOTS * R::TILE,
                  "the groups' states fit the ring");
    const int tid = warp * 32 + (threadIdx.x & 31), stride = warps * 32;
    float* x = reinterpret_cast<float*>(ring.base);
    __syncthreads();  // every group is done with the ring
    if (group > 0) wa.save(x + (group - 1) * FIELDS * stride + tid, stride);
    __syncthreads();
    if (group == 0)
      for (int g = 1; g < KG; ++g) wa.absorb(x + (g - 1) * FIELDS * stride + tid, stride);
  }
}

}  // namespace am
