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
//   grid axis, so the blocks of one batch row run together.  The step, 16
//   warps over tiles of 32 keys double-buffered through cp.async, scores on
//   mma.sync in four column quarters, the fp32 online softmax and P.V as
//   the pair hi + lo, is mla_mma.cuh's (shared with the MLA chunked
//   prefill); here a tile is a contiguous run of keys and the mask stops at
//   the sequence's end.
// * CUDA cores, for fp32 and every other shape: attention_core.cuh's online
//   softmax over strided key tiles of 16 rows (RowsLatent), up to 16 heads
//   of one latent head a block, head groups the fastest grid axis; scores,
//   softmax and P.V in fp32.
//
// Known first bottleneck: mma.sync and one block of 16 warps an SM; the
// tile's four partial score sums and the two P.V terms cost shared-memory
// traffic that wgmma (with P in registers) would not.

#include "attention_core.cuh"
#include "mla_mma.cuh"

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

// Copies key tile t of the batch row's latent head straight into the ring;
// keys past the end are 0.
template <typename CT>
struct SeqLoad {
  const mm::Smem<CT>& sm;
  const CT *kv, *k_pe;
  long row0;  // (b, s = 0, hk)
  int seq, kv_heads, pe, ks;

  __device__ void issue(int t, int stage) const {
    const int s0 = t * mm::KEYS, chunks = (mm::D + pe) / 8;
    for (int i = threadIdx.x; i < mm::KEYS * chunks; i += mm::THREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const bool p = s0 + r < seq;
      const long row = row0 + (long)(s0 + r) * kv_heads;
      const CT* src = c < mm::D ? kv + row * mm::D + c : k_pe + row * pe + (c - mm::D);
      gc::cp_async<16>(sm.kt(stage) + r * ks + c, p ? src : kv, p);
    }
  }
  __device__ void first() const {}
  __device__ void landed(bool) const {}
  __device__ void convert(int) const {}
};

template <typename CT>
__global__ void __launch_bounds__(mm::THREADS, 1)
mla_tc_kernel(const CT* __restrict__ q, const CT* __restrict__ q_pe, const CT* __restrict__ kv,
              const CT* __restrict__ k_pe, CT* __restrict__ out, int heads, int kv_heads,
              int seq, int pe, float qscale) {
  const int group = heads / kv_heads, per_head = (group + mm::ROWS - 1) / mm::ROWS;
  const int hk = blockIdx.x / per_head, part = blockIdx.x % per_head;
  const int b = blockIdx.y;
  const int h0 = hk * group + part * mm::ROWS, rows = min(mm::ROWS, group - part * mm::ROWS);
  const int dk = mm::D + pe, ks = dk + 8;
  extern __shared__ float4 smem4[];  // one declaration for both kernels of the file
  const mm::Smem<CT> sm(smem4, ks);

  const long qrow0 = (long)b * heads + h0;
  auto rows_at = [&](int r) { return r < rows ? qrow0 + r : -1L; };  // rows past `rows` are 0
  mm::load_q(sm, ks, q, q_pe, pe, rows_at);
  SeqLoad<CT> ld{sm, kv, k_pe, (long)b * seq * kv_heads + hk, seq, kv_heads, pe, ks};
  mm::Acc o;
  mm::attend(sm, o, (seq + mm::KEYS - 1) / mm::KEYS, dk, ks, ld,
             [&](int t, int, int j) { return j < seq - t * mm::KEYS; }, qscale);
  mm::finish(sm, o);
  mm::store(o, out, rows_at);
}

template <typename CT>
int launch_tc(const void* q, const void* q_pe, const void* kv, const void* k_pe, void* out,
              int batch, int heads, int kv_heads, int seq, int pe, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = mm::Smem<CT>::bytes(mm::D + pe + 8);
  auto kernel = mla_tc_kernel<CT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_head = (heads / kv_heads + mm::ROWS - 1) / mm::ROWS;
  dim3 grid(per_head * kv_heads, batch);
  kernel<<<grid, mm::THREADS, smem, stream>>>((const CT*)q, (const CT*)q_pe, (const CT*)kv,
                                             (const CT*)k_pe, (CT*)out, heads, kv_heads, seq, pe,
                                             sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// Whether the tensor-core kernel takes a launch: 16-bit elements, D = 512,
// D + Dpe a multiple of 64 (four column quarters of 16-wide steps).
inline bool tc_takes(int dtype, int d, int pe) {
  return dtype != 0 && d == mm::D && pe > 0 && (d + pe) % 64 == 0;
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
