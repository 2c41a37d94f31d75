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
// the softmax and the accumulator in fp32, the output rounded once.
//
// Bound on the H100: bytes.  Each latent and rope row is read once for the
// Hq / Hkv heads that share it ((D + Dpe) * itemsize bytes a key), and
// 2 Hq / Hkv (2 D + Dpe) FLOPs are done on it: at the paper's shapes (128
// heads over one latent head, D 512, Dpe 64) about 240 FLOPs a byte, under
// the card's 295 FLOP/byte bf16 ridge; b128 x s8192 moves 1.24 GB, 0.37 ms
// at 3.35 TB/s.
//
// Two kernels, chosen by the launch:
//
// * tensor cores, for bf16 / fp16 at D = 512 with D + Dpe a multiple of 64
//   (the paper's shapes): a block holds 64 heads of one latent head (the
//   reference's block_H = 64; 128 heads x 512 fp32 accumulators do not fit
//   one block, so two blocks split the 128), so each key tile is read from
//   device memory once and from L2 twice.  The head group is the fastest
//   grid axis, so the blocks of one batch row run together.  16 warps;
//   per tile of 32 keys, double-buffered through cp.async:
//     - scores: warp (m-tile, quarter) multiplies its 16 heads' queries by
//       the tile over a quarter of the D + Dpe columns (mma.sync m16n8k16,
//       fp32 sums); the four partial sums meet in shared memory in a fixed
//       order;
//     - the online softmax in fp32, 8 lanes a head (exp2 on log2e-scaled
//       scores, NEG_CLAMP, safe_div, as attention_core.cuh);
//     - P.V: the fp32 probabilities go to the tensor cores as two 16-bit
//       terms, p = hi + lo (hi = p rounded, lo = the rest rounded), so they
//       keep ~16 significant bits where one bf16 term would keep 8: the
//       port's other MLA kernels keep fp32 probabilities, and this stays
//       within their error; warp (m-tile, quarter) accumulates 16 heads x
//       128 columns of the output.
// * CUDA cores, for fp32 and every other shape: attention_core.cuh's online
//   softmax over strided key tiles of 16 rows (RowsLatent), up to 16 heads
//   of one latent head a block, head groups the fastest grid axis; scores,
//   softmax and P.V in fp32.
//
// Known first bottleneck: mma.sync and one block of 16 warps an SM; the
// tile's four partial score sums and the two P.V terms cost shared-memory
// traffic that wgmma (with P in registers) would not.

#include "attention_core.cuh"
#include "mma_core.cuh"

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

// ---- the tensor-core kernel ----------------------------------------------

constexpr int kRows = 64;      // heads a block
constexpr int kKeys = 32;      // keys a tile
constexpr int kTcThreads = 512;
constexpr int kTcD = 512;      // the latent width it takes
constexpr int kSps = kKeys + 4;  // row stride of the partial scores (floats)
constexpr int kPs = kKeys + 8;   // row stride of the probability terms

template <typename CT>
struct TcSmem {
  CT *qs, *kt[2], *ph, *pl;
  float *sp, *m, *l, *alpha;

  __device__ TcSmem(void* base, int ks) {
    qs = reinterpret_cast<CT*>(base);
    kt[0] = qs + kRows * ks;
    kt[1] = kt[0] + kKeys * ks;
    ph = kt[1] + kKeys * ks;
    pl = ph + kRows * kPs;
    sp = reinterpret_cast<float*>(pl + kRows * kPs);
    m = sp + 4 * kRows * kSps;
    l = m + kRows;
    alpha = l + kRows;
  }
  static size_t bytes(int ks) {
    return sizeof(CT) * ((size_t)(kRows + 2 * kKeys) * ks + 2 * kRows * kPs) +
           sizeof(float) * (4 * kRows * kSps + 3 * kRows);
  }
};

template <typename CT>
__global__ void __launch_bounds__(kTcThreads, 1)
mla_tc_kernel(const CT* __restrict__ q, const CT* __restrict__ q_pe, const CT* __restrict__ kv,
              const CT* __restrict__ k_pe, CT* __restrict__ out, int heads, int kv_heads,
              int seq, int pe, float qscale) {
  constexpr int d = kTcD;
  const int group = heads / kv_heads, per_head = (group + kRows - 1) / kRows;
  const int hk = blockIdx.x / per_head, part = blockIdx.x % per_head;
  const int b = blockIdx.y;
  const int h0 = hk * group + part * kRows, rows = min(kRows, group - part * kRows);
  const int dk = d + pe, ks = dk + 8, chunks = dk / 8;
  extern __shared__ float4 smem4[];  // one declaration for both kernels of the file
  TcSmem<CT> sm(smem4, ks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp & 3, quarter = warp >> 2;

  const long qrow0 = (long)b * heads + h0;
  for (int i = threadIdx.x; i < kRows * chunks; i += kTcThreads) {  // Q: rows past `rows` are 0
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool p = r < rows;
    const CT* src = c < d ? q + (qrow0 + r) * d + c : q_pe + (qrow0 + r) * pe + (c - d);
    gc::cp_async<16>(sm.qs + r * ks + c, p ? src : q, p);
  }
  auto load_tile = [&](int stage, int t) {  // keys past the end are 0
    const int s0 = t * kKeys;
    for (int i = threadIdx.x; i < kKeys * chunks; i += kTcThreads) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const bool p = s0 + r < seq;
      const long row = ((long)b * seq + s0 + r) * kv_heads + hk;
      const CT* src = c < d ? kv + row * d + c : k_pe + row * pe + (c - d);
      gc::cp_async<16>(sm.kt[stage] + r * ks + c, p ? src : kv, p);
    }
  };
  if (threadIdx.x < kRows) {
    sm.m[threadIdx.x] = -CUDART_INF_F;
    sm.l[threadIdx.x] = 0.f;
  }
  load_tile(0, 0);
  gc::cp_async_commit();

  gc::WarpAcc<1, kTcD / 4 / 8> o;  // 16 heads x 128 columns
  o.zero();
  const int ntiles = (seq + kKeys - 1) / kKeys, dq = dk / 4;
  for (int t = 0; t < ntiles; ++t) {
    gc::cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; tile t - 1 fully consumed
    if (t + 1 < ntiles) load_tile((t + 1) & 1, t + 1);
    gc::cp_async_commit();
    const CT* kt = sm.kt[t & 1];
    {  // partial scores over this warp's quarter of the D + Dpe columns
      gc::WarpAcc<1, kKeys / 8> s;
      s.zero();
      s.mma_span<CT>(sm.qs + quarter * dq, ks, kt + quarter * dq, ks, mt * 16, 0, dq);
      s.store(sm.sp + quarter * kRows * kSps, kSps, kRows, kKeys, mt * 16, 0);
    }
    __syncthreads();
    {  // online softmax: 8 lanes a head, 4 keys a lane
      const int r = threadIdx.x >> 3, k0 = (threadIdx.x & 7) * 4;
      const int valid = seq - t * kKeys;
      float sc[4], mx = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = r * kSps + k0 + e;
        const float v = ((sm.sp[j] + sm.sp[kRows * kSps + j]) + sm.sp[2 * kRows * kSps + j]) +
                        sm.sp[3 * kRows * kSps + j];
        sc[e] = k0 + e < valid ? v * qscale : -CUDART_INF_F;
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
        sm.ph[r * kPs + k0 + e] = hi;
        sm.pl[r * kPs + k0 + e] = gc::from_float<CT>(pr - gc::to_float(hi));
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
    __syncthreads();
    {  // o = o * alpha + (hi + lo) . V over this warp's quarter of D
      const int g = lane >> 2;
      const float f[1][2] = {{sm.alpha[mt * 16 + g], sm.alpha[mt * 16 + g + 8]}};
      o.scale_rows(f);
      const CT* v = kt + quarter * (d / 4);
      o.mma_tile<CT, kKeys, true>(sm.ph, kPs, v, ks, mt * 16, 0);
      o.mma_tile<CT, kKeys, true>(sm.pl, kPs, v, ks, mt * 16, 0);
    }
  }
  const int g = lane >> 2;  // out = o / max(l, 1e-30): a head with no key emits 0
  const float f[1][2] = {{1.f / fmaxf(sm.l[mt * 16 + g], 1e-30f),
                          1.f / fmaxf(sm.l[mt * 16 + g + 8], 1e-30f)}};
  o.scale_rows(f);
  o.store(out + qrow0 * d, d, rows, d, mt * 16, quarter * (d / 4));
}

template <typename CT>
int launch_tc(const void* q, const void* q_pe, const void* kv, const void* k_pe, void* out,
              int batch, int heads, int kv_heads, int seq, int pe, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = TcSmem<CT>::bytes(kTcD + pe + 8);
  auto kernel = mla_tc_kernel<CT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_head = (heads / kv_heads + kRows - 1) / kRows;
  dim3 grid(per_head * kv_heads, batch);
  kernel<<<grid, kTcThreads, smem, stream>>>((const CT*)q, (const CT*)q_pe, (const CT*)kv,
                                             (const CT*)k_pe, (CT*)out, heads, kv_heads, seq, pe,
                                             sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// Whether the tensor-core kernel takes a launch: 16-bit elements, D = 512,
// D + Dpe a multiple of 64 (four column quarters of 16-wide steps).
inline bool tc_takes(int dtype, int d, int pe) {
  return dtype != 0 && d == kTcD && pe > 0 && (d + pe) % 64 == 0;
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  bf16 / fp16 at D = 512
// with D + Dpe a multiple of 64 take the tensor-core kernel; everything
// else the CUDA-core kernel, where bh heads share a block (it must divide
// heads / kv_heads).  Needs D and Dpe multiples of 16 bytes' worth of
// elements and 16-byte aligned, contiguous tensors.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int mla_launch(int dtype, const void* q, const void* q_pe, const void* kv,
                          const void* k_pe, void* out, int batch, int heads, int kv_heads,
                          int seq, int d, int pe, int bh, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tc_takes(dtype, d, pe)) {
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
