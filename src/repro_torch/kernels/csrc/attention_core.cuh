// Shared online-softmax device functions for the attention kernels.
//
// CUDA counterpart of repro/kernels/attention_core.py (OnlineSoftmax): every
// attention kernel streams K/V tiles through shared memory, scores them
// against a resident block of query rows and folds each tile into a running
// softmax.  The numerics follow the TPU template exactly:
//
//   * queries are prescaled by sm_scale * log2(e), so scores live in the
//     log2 domain and every exponential is an exp2;
//   * the running max is clamped at NEG_CLAMP = -2^20 before differencing
//     (attention_core.py:34, :97-102): a fully masked tile leaves the max at
//     -inf, and (-inf) - (-inf) would be NaN;
//   * the final normalisation divides by max(l, 1e-30) (safe_div,
//     attention_core.py:117), so a row with no live key emits 0, not NaN.
//
// All state lives in shared memory and is fp32 whatever the input type.  The
// functions are written for a whole thread block (blockDim.x a multiple of
// 32): each spreads its work over threadIdx.x, and the caller separates the
// phases with __syncthreads().
//
// A K/V tile is `cols` consecutive rows of `d` values, contiguous in device
// memory (one KV page, or one page-sized slice of the chunk), in one of two
// formats: FpKV (rows of T) or QuantKV (the DequantStage of
// attention_core.py:127: packed int8 / int4 rows plus one scale per row,
// dequantized on the way into shared memory).  RowsKV reads rows of T at a
// stride (the contiguous full-sequence layout, any sequence length).  Every
// format lands in the same fp32 shared tiles and goes through the one online
// softmax below.
//
// Multi-head latent attention (MLA) scores a key of width dk = R + Dpe (the
// shared latent plus its rotary part) and takes as value the key's first
// dv = R columns: its tiles are FpLatent / QuantLatent (pool pages) or
// RowsLatent (strided rows of a contiguous cache), one shared tile of
// [latent | rope] rows that P.V reads again (no second load), and the
// latent layout of Smem points the V tile at the K tile.
// Tiles are read with 16-byte vector loads into registers one tile ahead of
// the compute (attend_tiles), so the device-memory latency of tile t + 1
// overlaps the scoring of tile t.  Scores of one query row sit in `cols`
// neighbouring lanes of a warp, so the row's max and sum are warp shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ac {

constexpr float NEG_CLAMP = -1048576.0f;  // -2^20; exp2 underflows long before
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAXV = 4;  // 16-byte vectors per thread per tile (K or V)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

// Whether a launch's shapes fit the kernels' vector loads and shuffles:
// d a multiple of the vector width, cols a power of two <= 32, and one tile
// at most MAXV vectors per thread.
template <typename T>
inline bool shapes_ok(int cols, int d, int threads) {
  const int vec = vec_elems<T>();
  return d % vec == 0 && d % 4 == 0 && cols >= 1 && cols <= 32 &&
         (cols & (cols - 1)) == 0 && cols * d / vec <= MAXV * threads;
}

// Stage `rows` rows of `d` values into shared memory as fp32 (row stride
// `sstride` floats), multiplied by `scale`.  Used once per block, for Q.
template <typename T>
__device__ void load_rows(float* dst, int sstride, const T* __restrict__ src,
                          long gstride, int rows, int d, float scale) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * sstride + c] = to_float(src[r * gstride + c]) * scale;
  }
}

// A K or V tile in flight: this thread's 16-byte vectors of it.
struct Stage {
  uint4 v[MAXV];
};

// Start the loads of one contiguous tile (cols * d elements) into registers.
template <typename T>
__device__ __forceinline__ void fetch(Stage& st, const T* __restrict__ src,
                                      int cols, int d) {
  const int n = cols * d / vec_elems<T>();
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) st.v[k] = __ldg(s + i);
  }
}

// Convert a fetched tile to fp32 and store it in shared memory (row stride
// `sstride` floats, a multiple of 4).
template <typename T>
__device__ __forceinline__ void commit(float* dst, int sstride, const Stage& st,
                                       int cols, int d) {
  constexpr int VEC = vec_elems<T>();
  const int n = cols * d / VEC;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      const int e = i * VEC, r = e / d, c = e - r * d;
      const T* x = reinterpret_cast<const T*>(&st.v[k]);
      float* o = dst + r * sstride + c;
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(o + q) = make_float4(
            to_float(x[q]), to_float(x[q + 1]), to_float(x[q + 2]), to_float(x[q + 3]));
    }
  }
}

// Shared-memory layout common to all the kernels: a resident block of `rows`
// query rows, one K and one V tile of `cols` keys, the probability tile, the
// output accumulator and the per-row softmax carries.  Q and K rows are
// padded to d + 4 floats: 16-byte aligned, and rows a lane apart start four
// banks apart, so a quarter warp's float4 reads of eight rows hit all 32
// banks once.
struct Smem {
  float *qs, *ks, *vs, *s, *acc, *m, *l, *alpha;
  int stride, vstride;  // floats between Q/K rows, and between V rows

  __device__ Smem(float* base, int rows, int cols, int d) {
    stride = d + 4;
    vstride = d;
    qs = base;
    ks = qs + rows * stride;
    vs = ks + cols * stride;
    acc = vs + cols * d;  // every float4-read array starts 16-byte aligned
    s = acc + rows * d;
    m = s + rows * cols;
    l = m + rows;
    alpha = l + rows;
  }

  static size_t bytes(int rows, int cols, int d) {
    return sizeof(float) * ((size_t)rows * (d + 4) + (size_t)cols * (d + 4) +
                            (size_t)cols * d + (size_t)rows * cols +
                            (size_t)rows * d + 3 * (size_t)rows);
  }

  // The latent layout: Q and K rows of dk values (padded to dk + 4 as
  // above), V the first dv columns of the K tile itself, the accumulator
  // dv wide.
  __device__ Smem(float* base, int rows, int cols, int dk, int dv) {
    stride = dk + 4;
    vstride = stride;
    qs = base;
    ks = qs + rows * stride;
    vs = ks;
    acc = ks + cols * stride;
    s = acc + rows * dv;
    m = s + rows * cols;
    l = m + rows;
    alpha = l + rows;
  }

  static size_t latent_bytes(int rows, int cols, int dk, int dv) {
    return sizeof(float) * ((size_t)rows * (dk + 4) + (size_t)cols * (dk + 4) +
                            (size_t)rows * dv + (size_t)rows * cols +
                            3 * (size_t)rows);
  }
};

// ---- K/V tile formats ---------------------------------------------------
//
// A format is a bundle of pointers to consecutive K and V rows, plus how one
// tile of `cols` rows is fetched into registers (Regs) and committed to the
// shared tiles sm.ks / sm.vs as fp32.  rows(n, d) advances the bundle by n
// rows: a pool page and a page-sized chunk slice are both runs of rows.
// copy_rows(dst, n, d) copies n rows onto another bundle of the same format
// (the prefill kernels' page write).

// fp K/V: rows of d values of T.
template <typename T>
struct FpKV {
  using Elem = T;
  T *k, *v;
  struct Regs {
    Stage k, v;
  };

  static bool shapes_ok(int cols, int d, int threads) {
    return ac::shapes_ok<T>(cols, d, threads);
  }
  __device__ FpKV rows(long n, int d) const { return {k + n * d, v + n * d}; }
  __device__ void fetch(Regs& r, int cols, int d) const {
    ac::fetch<T>(r.k, k, cols, d);
    ac::fetch<T>(r.v, v, cols, d);
  }
  __device__ static void commit(Smem& sm, const Regs& r, int cols, int d) {
    ac::commit<T>(sm.ks, sm.stride, r.k, cols, d);
    ac::commit<T>(sm.vs, d, r.v, cols, d);
  }
  __device__ void copy_rows(const FpKV& dst, int n, int d) const {
    const int nvec = n * d / vec_elems<T>();
    const uint4* ks = reinterpret_cast<const uint4*>(k);
    const uint4* vs = reinterpret_cast<const uint4*>(v);
    uint4* kd = reinterpret_cast<uint4*>(dst.k);
    uint4* vd = reinterpret_cast<uint4*>(dst.v);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      kd[i] = ks[i];
      vd[i] = vs[i];
    }
  }
};

// Start the loads of `cols` rows of d values, row r at src + r * stride (a
// strided run of rows: a (batch, head) slice of a (B, S, H, D) tensor);
// rows at or past `valid` read as zeros.
template <typename T>
__device__ __forceinline__ void fetch_rows(Stage& st, const T* __restrict__ src,
                                           long stride, int valid, int cols,
                                           int d) {
  constexpr int VEC = vec_elems<T>();
  const int rv = d / VEC;  // vectors a row
  const int n = cols * rv;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      const int r = i / rv, c = (i - r * rv) * VEC;
      st.v[k] = r < valid
                    ? __ldg(reinterpret_cast<const uint4*>(src + r * stride + c))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Strided fp K/V rows (the contiguous flash-attention layout): key r at
// k + r * kstride, value r at v + r * vstride, and only the first `valid`
// rows of a tile are read: a partial last tile reads nothing past the
// sequence's end, and its dead rows commit as zeros, so that their (zero)
// probabilities never multiply garbage (0 * NaN is NaN).
template <typename T>
struct RowsKV {
  using Elem = T;
  const T *k, *v;
  long kstride, vstride;
  int valid;
  struct Regs {
    Stage k, v;
  };

  static bool shapes_ok(int cols, int d, int threads) {
    return ac::shapes_ok<T>(cols, d, threads);
  }
  __device__ RowsKV rows(long n) const {
    return {k + n * kstride, v + n * vstride, kstride, vstride, valid - (int)n};
  }
  __device__ void fetch(Regs& r, int cols, int d) const {
    fetch_rows<T>(r.k, k, kstride, valid, cols, d);
    fetch_rows<T>(r.v, v, vstride, valid, cols, d);
  }
  __device__ static void commit(Smem& sm, const Regs& r, int cols, int d) {
    ac::commit<T>(sm.ks, sm.stride, r.k, cols, d);
    ac::commit<T>(sm.vs, d, r.v, cols, d);
  }
};

// A packed tile in flight: this thread's 16-byte vectors of codes and the
// scale of the row each vector lies in, both as loaded: converting a scale
// at fetch time would wait for its load there and stall the prefetch.
template <typename T>
struct QStage {
  uint4 v[MAXV];
  T s[MAXV];
};

// The dequantized value, rounded once to T: the TPU DequantStage computes
// int x scale in the compute dtype (attention_core.py:166) and the plain
// version casts the fp32 product to the query's dtype.  For a bf16 scale the
// fp32 product of a code (at most 8 bits) and the scale (8 significant bits)
// is exact, so both round the same exact value once.
template <typename T>
__device__ __forceinline__ float deq(int code, float scale) {
  return to_float(from_float<T>((float)code * scale));
}

// int4 code of nibble `hi` of byte b, sign-extended (v >= 8 -> v - 16).
__device__ __forceinline__ int nibble(uint32_t b, int hi) {
  const int v = (b >> (hi * 4)) & 0xF;
  return v >= 8 ? v - 16 : v;
}

// Start the loads of one packed tile: cols rows of d / PACK bytes, plus the
// scale of each vector's row.
template <typename T, int PACK>
__device__ __forceinline__ void fetch_q(QStage<T>& st, const int8_t* __restrict__ src,
                                        const T* __restrict__ scales, int cols,
                                        int d) {
  const int row_vecs = d / PACK / 16;
  const int n = cols * row_vecs;
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      st.v[k] = __ldg(s + i);
      st.s[k] = scales[i / row_vecs];
    }
  }
}

// Unpack one packed vector (16 int8 or 32 int4 codes), scale it and store
// it at `o` as fp32.
template <typename T, int PACK>
__device__ __forceinline__ void unpack_vec(float* o, const uint4& v, float sc) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
  if (PACK == 1) {
#pragma unroll
    for (int q = 0; q < 16; q += 4)
      *reinterpret_cast<float4*>(o + q) = make_float4(
          deq<T>((int8_t)b[q], sc), deq<T>((int8_t)b[q + 1], sc),
          deq<T>((int8_t)b[q + 2], sc), deq<T>((int8_t)b[q + 3], sc));
  } else {  // low nibble first: byte j holds values 2j and 2j + 1
#pragma unroll
    for (int q = 0; q < 16; q += 2)
      *reinterpret_cast<float4*>(o + 2 * q) = make_float4(
          deq<T>(nibble(b[q], 0), sc), deq<T>(nibble(b[q], 1), sc),
          deq<T>(nibble(b[q + 1], 0), sc), deq<T>(nibble(b[q + 1], 1), sc));
  }
}

// Unpack a fetched tile, scale it and store it in shared memory as fp32
// (row stride `sstride` floats): 16 int8 or 32 int4 values per vector.
template <typename T, int PACK>
__device__ __forceinline__ void commit_q(float* dst, int sstride, const QStage<T>& st,
                                         int cols, int d) {
  const int row_vecs = d / PACK / 16;
  const int n = cols * row_vecs;
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      const int r = i / row_vecs, c = (i - r * row_vecs) * 16 * PACK;
      unpack_vec<T, PACK>(dst + r * sstride + c, st.v[k], to_float(st.s[k]));
    }
  }
}

// Quantized K/V, the DequantStage: rows of d / PACK packed bytes (PACK = 1:
// int8 codes; PACK = 2: two int4 codes a byte, low nibble first) plus one
// scale of T per row.
template <typename T, int PACK>
struct QuantKV {
  using Elem = T;
  int8_t *k, *v;
  T *ks, *vs;
  struct Regs {
    QStage<T> k, v;
  };

  static bool shapes_ok(int cols, int d, int threads) {
    return d % (16 * PACK) == 0 && cols >= 1 && cols <= 32 &&
           (cols & (cols - 1)) == 0 && cols * (d / PACK / 16) <= MAXV * threads;
  }
  __device__ QuantKV rows(long n, int d) const {
    const long nb = n * (d / PACK);
    return {k + nb, v + nb, ks + n, vs + n};
  }
  __device__ void fetch(Regs& r, int cols, int d) const {
    fetch_q<T, PACK>(r.k, k, ks, cols, d);
    fetch_q<T, PACK>(r.v, v, vs, cols, d);
  }
  __device__ static void commit(Smem& sm, const Regs& r, int cols, int d) {
    commit_q<T, PACK>(sm.ks, sm.stride, r.k, cols, d);
    commit_q<T, PACK>(sm.vs, d, r.v, cols, d);
  }
  // packed bytes and scales of the same rows, so that no page holds the
  // bytes of one write and the scales of another
  __device__ void copy_rows(const QuantKV& dst, int n, int d) const {
    const int nvec = n * (d / PACK) / 16;
    const uint4* kb = reinterpret_cast<const uint4*>(k);
    const uint4* vb = reinterpret_cast<const uint4*>(v);
    uint4* kd = reinterpret_cast<uint4*>(dst.k);
    uint4* vd = reinterpret_cast<uint4*>(dst.v);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      kd[i] = kb[i];
      vd[i] = vb[i];
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      dst.ks[i] = ks[i];
      dst.vs[i] = vs[i];
    }
  }
};

// ---- latent (MLA) tile formats -------------------------------------------
//
// A latent tile is `cols` rows of the latent pool (R values a row) and the
// same rows of the rope pool (Dpe values a row), two contiguous runs in
// device memory, committed side by side into sm.ks as rows [latent | rope]
// of dk = R + Dpe floats.  A page at full width (R 512, Dpe 64, page 16) is
// 1152 16-byte vectors in bf16 and 2304 in fp32, so these formats hold NV
// vectors a thread (at 256 threads: 5 and 9), more than FpKV's MAXV.

// Commit a fetched latent tile: vectors [0, cols * r / VEC) are the latent
// rows, the rest the rope rows, stored side by side in sm.ks as fp32 rows
// [latent | rope].
template <typename T, int NV>
__device__ __forceinline__ void commit_latent(Smem& sm, const uint4 (&v)[NV], int cols, int r,
                                              int pe) {
  constexpr int VEC = vec_elems<T>();
  const int nc = cols * r / VEC, n = nc + cols * pe / VEC;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      int row, col;
      if (i < nc) {
        const int e = i * VEC;
        row = e / r;
        col = e - row * r;
      } else {
        const int e = (i - nc) * VEC;
        row = e / pe;
        col = r + e - row * pe;
      }
      const T* x = reinterpret_cast<const T*>(&v[k]);
      float* o = sm.ks + row * sm.stride + col;
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(o + q) = make_float4(
            to_float(x[q]), to_float(x[q + 1]), to_float(x[q + 2]), to_float(x[q + 3]));
    }
  }
}

// fp latent: rows of R and Dpe values of T.
template <typename T>
struct FpLatent {
  using Elem = T;
  static constexpr int NV = sizeof(T) == 4 ? 9 : 5;
  T *ckv, *kpe;
  int r, pe;
  struct Regs {
    uint4 v[NV];
  };

  static bool shapes_ok(int cols, int r, int pe, int threads) {
    const int vec = vec_elems<T>();
    return r % vec == 0 && pe % vec == 0 && cols >= 1 && cols <= 32 &&
           (cols & (cols - 1)) == 0 && cols * (r + pe) / vec <= NV * threads;
  }
  __device__ FpLatent rows(long n) const { return {ckv + n * r, kpe + n * pe, r, pe}; }
  __device__ void fetch(Regs& st, int cols, int /*dk*/) const {
    constexpr int VEC = vec_elems<T>();
    const int nc = cols * r / VEC, n = nc + cols * pe / VEC;
    const uint4* c = reinterpret_cast<const uint4*>(ckv);
    const uint4* p = reinterpret_cast<const uint4*>(kpe);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nc)
        st.v[k] = __ldg(c + i);
      else if (i < n)
        st.v[k] = __ldg(p + (i - nc));
    }
  }
  __device__ void commit(Smem& sm, const Regs& st, int cols, int /*dk*/) const {
    commit_latent<T, NV>(sm, st.v, cols, r, pe);
  }
  // n rows of both pools onto `dst` (the prefill kernels' page write)
  __device__ void copy_rows(const FpLatent& dst, int n) const {
    const int nc = n * r / vec_elems<T>(), np = n * pe / vec_elems<T>();
    const uint4* c = reinterpret_cast<const uint4*>(ckv);
    const uint4* p = reinterpret_cast<const uint4*>(kpe);
    uint4* cd = reinterpret_cast<uint4*>(dst.ckv);
    uint4* pd = reinterpret_cast<uint4*>(dst.kpe);
    for (int i = threadIdx.x; i < nc; i += blockDim.x) cd[i] = c[i];
    for (int i = threadIdx.x; i < np; i += blockDim.x) pd[i] = p[i];
  }
};

// Strided latent rows (the contiguous MLA layout, kv (B, S, Hkv, R) and
// k_pe (B, S, Hkv, Dpe)): latent row j at ckv + j * cstride, rope row j at
// kpe + j * pstride, and only the first `valid` rows of a tile are read: the
// rows of a partial last tile past the sequence's end commit as zeros.
template <typename T>
struct RowsLatent {
  using Elem = T;
  static constexpr int NV = FpLatent<T>::NV;
  const T *ckv, *kpe;
  long cstride, pstride;
  int valid, r, pe;
  struct Regs {
    uint4 v[NV];
  };

  static bool shapes_ok(int cols, int r, int pe, int threads) {
    return FpLatent<T>::shapes_ok(cols, r, pe, threads);
  }
  __device__ RowsLatent rows(long n) const {
    return {ckv + n * cstride, kpe + n * pstride, cstride, pstride, valid - (int)n, r, pe};
  }
  __device__ void fetch(Regs& st, int cols, int /*dk*/) const {
    constexpr int VEC = vec_elems<T>();
    const int rc = r / VEC, rp = pe / VEC;
    const int nc = cols * rc, n = nc + cols * rp;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nc) {
        const int row = i / rc;
        st.v[k] = row < valid ? __ldg(reinterpret_cast<const uint4*>(
                                    ckv + row * cstride + (i - row * rc) * VEC))
                              : make_uint4(0u, 0u, 0u, 0u);
      } else if (i < n) {
        const int j = i - nc, row = j / rp;
        st.v[k] = row < valid ? __ldg(reinterpret_cast<const uint4*>(
                                    kpe + row * pstride + (j - row * rp) * VEC))
                              : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  __device__ void commit(Smem& sm, const Regs& st, int cols, int /*dk*/) const {
    commit_latent<T, NV>(sm, st.v, cols, r, pe);
  }
};

// Quantized latent: rows of R / PACK and Dpe / PACK packed bytes with one
// scale of T per row in each pool.  The latent columns are dequantized with
// the latent row's scale and the rope columns with the rope row's.
template <typename T, int PACK>
struct QuantLatent {
  using Elem = T;
  static constexpr int NV = PACK == 1 ? 3 : 2;
  int8_t *ckv, *kpe;
  T *cs, *rs;  // (rows, 1) scales of the latent and the rope rows
  int r, pe;
  struct Regs {
    uint4 v[NV];
    T s[NV];
  };

  static bool shapes_ok(int cols, int r, int pe, int threads) {
    return r % (16 * PACK) == 0 && pe % (16 * PACK) == 0 && cols >= 1 &&
           cols <= 32 && (cols & (cols - 1)) == 0 &&
           cols * (r + pe) / PACK / 16 <= NV * threads;
  }
  __device__ QuantLatent rows(long n) const {
    return {ckv + n * (r / PACK), kpe + n * (pe / PACK), cs + n, rs + n, r, pe};
  }
  __device__ void fetch(Regs& st, int cols, int /*dk*/) const {
    const int rc = r / PACK / 16, rp = pe / PACK / 16;
    const int nc = cols * rc, n = nc + cols * rp;
    const uint4* c = reinterpret_cast<const uint4*>(ckv);
    const uint4* p = reinterpret_cast<const uint4*>(kpe);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nc) {
        st.v[k] = __ldg(c + i);
        st.s[k] = cs[i / rc];
      } else if (i < n) {
        st.v[k] = __ldg(p + (i - nc));
        st.s[k] = rs[(i - nc) / rp];
      }
    }
  }
  __device__ void commit(Smem& sm, const Regs& st, int cols, int /*dk*/) const {
    const int rc = r / PACK / 16, rp = pe / PACK / 16;
    const int nc = cols * rc, n = nc + cols * rp;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n) {
        int row, col;
        if (i < nc) {
          row = i / rc;
          col = (i - row * rc) * 16 * PACK;
        } else {
          const int j = i - nc;
          row = j / rp;
          col = r + (j - row * rp) * 16 * PACK;
        }
        unpack_vec<T, PACK>(sm.ks + row * sm.stride + col, st.v[k], to_float(st.s[k]));
      }
    }
  }
  // packed bytes and both scales of the same n rows, together
  __device__ void copy_rows(const QuantLatent& dst, int n) const {
    const int nc = n * (r / PACK) / 16, np = n * (pe / PACK) / 16;
    const uint4* c = reinterpret_cast<const uint4*>(ckv);
    const uint4* p = reinterpret_cast<const uint4*>(kpe);
    uint4* cd = reinterpret_cast<uint4*>(dst.ckv);
    uint4* pd = reinterpret_cast<uint4*>(dst.kpe);
    for (int i = threadIdx.x; i < nc; i += blockDim.x) cd[i] = c[i];
    for (int i = threadIdx.x; i < np; i += blockDim.x) pd[i] = p[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      dst.cs[i] = cs[i];
      dst.rs[i] = rs[i];
    }
  }
};

// Stage `rows` latent query rows [q_lat | q_pe] into sm.qs as fp32,
// multiplied by `scale`; block row rr is row row_of(rr) of q (R values a
// row) and of q_pe (Dpe values a row).
template <typename T, typename RowOf>
__device__ void load_latent_rows(Smem& sm, const T* __restrict__ q,
                                 const T* __restrict__ q_pe, int rows, int r,
                                 int pe, float scale, const RowOf& row_of) {
  const int dk = r + pe;
  for (int i = threadIdx.x; i < rows * dk; i += blockDim.x) {
    const int rr = i / dk, c = i - rr * dk;
    const long g = row_of(rr);
    const float x = c < r ? to_float(q[g * r + c]) : to_float(q_pe[g * pe + c - r]);
    sm.qs[rr * sm.stride + c] = x * scale;
  }
}

// acc = 0, m = -inf, l = 0 for `rows` query rows of width `d`.
__device__ void init_state(Smem& sm, int rows, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    sm.m[r] = -CUDART_INF_F;
    sm.l[r] = 0.f;
  }
}

// Score the staged K tile against every query row and fold it into the
// running softmax: s[r][j] = exp2(q[r].k[j] - m_new[r]) (0 where the mask
// is false), l and m updated, and the accumulator's rescale factor left in
// alpha.  Row r's `cols` scores sit in neighbouring lanes, so its max and
// sum are xor shuffles; every warp runs every iteration, so the shuffles
// always see full warps.
template <typename Mask>
__device__ void score_softmax(Smem& sm, int rows, int cols, int d,
                              const Mask& mask) {
  const int total = rows * cols;
  for (int base = 0; base < total; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool act = i < total;
    const int r = act ? i / cols : 0, j = i - r * cols;
    float sc = -CUDART_INF_F;
    float m_prev = -CUDART_INF_F;
    if (act) {
      const float4* q = reinterpret_cast<const float4*>(sm.qs + r * sm.stride);
      const float4* k = reinterpret_cast<const float4*>(sm.ks + j * sm.stride);
      float a0 = 0.f, a1 = 0.f;
      for (int c = 0; c < d / 4; ++c) {
        const float4 x = q[c], y = k[c];
        a0 = fmaf(x.x, y.x, a0);
        a1 = fmaf(x.y, y.y, a1);
        a0 = fmaf(x.z, y.z, a0);
        a1 = fmaf(x.w, y.w, a1);
      }
      if (mask(r, j)) sc = a0 + a1;
      m_prev = sm.m[r];
    }
    float mx = sc;
    for (int off = cols >> 1; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_cur = fmaxf(m_prev, mx);
    const float mc = fmaxf(m_cur, NEG_CLAMP);
    const float e = act ? exp2f(sc - mc) : 0.f;
    float sum = e;
    for (int off = cols >> 1; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();  // every lane has read m[r] before its owner rewrites it
    if (act) {
      sm.s[i] = e;
      if (j == 0) {
        const float a = exp2f(fmaxf(m_prev, NEG_CLAMP) - mc);
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_cur;
        sm.alpha[r] = a;
      }
    }
  }
}

// acc[r] = acc[r] * alpha[r] + sum_j p[r][j] * v[j]   (the P.V product),
// four output columns per thread.
__device__ void pv_accumulate(Smem& sm, int rows, int cols, int d) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < rows * d4; i += blockDim.x) {
    const int r = i / d4, c = (i - r * d4) * 4;
    const float* p = sm.s + r * cols;
    float4 o = *reinterpret_cast<float4*>(sm.acc + r * d + c);
    const float a = sm.alpha[r];
    o.x *= a; o.y *= a; o.z *= a; o.w *= a;
    for (int j = 0; j < cols; ++j) {
      const float pj = p[j];
      const float4 v = *reinterpret_cast<const float4*>(sm.vs + j * sm.vstride + c);
      o.x = fmaf(pj, v.x, o.x);
      o.y = fmaf(pj, v.y, o.y);
      o.z = fmaf(pj, v.z, o.z);
      o.w = fmaf(pj, v.w, o.w);
    }
    *reinterpret_cast<float4*>(sm.acc + r * d + c) = o;
  }
}

// The online-softmax pass over `n` K/V tiles, scoring dk columns and
// accumulating dv.  `src.tile(t, kv)` sets the bundle of tile t (a Src::KV
// format above, `cols` rows) and returns false when the tile must contribute
// nothing; `src.mask(t)` gives the tile's (r, j) mask.  Tile t + 1's loads
// are in flight while tile t is scored.
template <typename Src>
__device__ void attend_tiles(Smem& sm, int rows, int cols, int dk, int dv,
                             int n, const Src& src) {
  using KV = typename Src::KV;
  typename KV::Regs regs;
  KV kv;
  bool ok = n > 0 && src.tile(0, kv);
  if (ok) kv.fetch(regs, cols, dk);
  for (int t = 0; t < n; ++t) {
    const bool cur_ok = ok;
    __syncthreads();  // the previous tile is fully consumed
    if (cur_ok) kv.commit(sm, regs, cols, dk);  // kv is still tile t here
    ok = t + 1 < n && src.tile(t + 1, kv);
    if (ok) kv.fetch(regs, cols, dk);
    if (!cur_ok) continue;  // uniform across the block
    __syncthreads();
    score_softmax(sm, rows, cols, dk, src.mask(t));
    __syncthreads();
    pv_accumulate(sm, rows, cols, dv);
  }
}

// The same with one width d for Q, K and V (FpKV, QuantKV).
template <typename Src>
__device__ void attend_tiles(Smem& sm, int rows, int cols, int d, int n,
                             const Src& src) {
  attend_tiles(sm, rows, cols, d, d, n, src);
}

// out[r] = acc[r] / max(l[r], 1e-30): empty rows emit zeros (safe_div).
template <typename T>
__device__ void store_rows(T* __restrict__ dst, long gstride, const Smem& sm,
                           int rows, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * gstride + c] = from_float<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

// The same with block row r stored at row row_of(r) of dst (d values a row).
template <typename T, typename RowOf>
__device__ void store_rows_at(T* __restrict__ dst, const Smem& sm, int rows,
                              int d, const RowOf& row_of) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[row_of(r) * d + c] = from_float<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

}  // namespace ac
