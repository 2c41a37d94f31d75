// Contiguous flash-attention forward, GQA, causal or not.
//
// flash_attention_launch replaces the TPU kernel
// repro/kernels/flash_attention.py:25 (flash_attention_program): q (B, Hq,
// Sq, D), k / v (B, Hkv, Sk, D), out (B, Hq, Sq, D), each given by its
// batch, head and row strides in elements (the last dimension contiguous), so
// the (B, S, H, D) projections of a layer are read and written in place
// without a transposing copy.  The causal mask aligns the queries to the
// suffix of the keys: query i may see key j when j <= i + Sk - Sq
// (flash_attention.py:69-75).  Scores and the softmax run in fp32; the
// output is rounded once to the input dtype.
//
// Bound on the H100: operations.  At qwen2-1.5B's training shapes (B 8, Hq
// 12, S 1024, D 128, causal) the forward is 4 * B * Hq * S^2 * D / 2 = 25.8
// GFLOP against 59 MB of Q, K, V and O.  This first kernel scores and
// accumulates on CUDA cores in fp32 (67 TFLOP/s at the card's peak, not the
// tensor cores' 989), so its arithmetic bounds it far above the bound.
//
// Design:
//   * grid (query block, q head, batch), as the TPU grid; a block holds 64
//     query rows of one head in shared memory (fp32, prescaled by sm_scale *
//     log2(e)) and walks its KV head's rows (kv_head = head / group) in tiles
//     of 32 keys through the online softmax of attention_core.cuh (exp2,
//     the NEG_CLAMP running max, safe_div), with the loads of tile t + 1 in
//     flight while tile t is scored;
//   * any Sq and Sk: the TPU program needs Sq % block_M == Sk % block_N == 0;
//     here a partial last query block loads and stores only its live rows,
//     and a partial last key tile reads only its live rows (RowsKV) and masks
//     the rest;
//   * a causal block stops its walk at the tile holding its last row's
//     diagonal key: the tiles past it are fully masked and contribute
//     nothing, so a causal launch does about half the work of a full one;
//   * a query row with no live key (causal with Sq > Sk) emits zeros, where
//     the plain softmax gives NaN;
//   * shared memory at 64 rows and D 128 is 109 KB (the resident Q block,
//     one K and one V tile, the probability tile and the accumulator, all
//     fp32): above the 48 KB static limit, so the launcher opts in with
//     cudaFuncSetAttribute(MaxDynamicSharedMemorySize).

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // query rows a block
constexpr int kCols = 32;  // keys a tile (at most a warp: the row shuffles)
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on the H100

struct FlashMask {  // keys [k_lo, k_lo + cols): live, and causal when asked
  int q_lo, k_lo, sk, off, causal;
  __device__ bool operator()(int r, int j) const {
    const int kj = k_lo + j;
    return kj < sk && (!causal || kj <= q_lo + r + off);
  }
};

// The (batch, kv head)'s key rows [t * cols, (t + 1) * cols).
template <typename T>
struct FlashTiles {
  using KV = ac::RowsKV<T>;
  KV head;  // at key row 0, valid = Sk
  int cols, sk, q_lo, off, causal;

  __device__ bool tile(int t, KV& kv) const {
    kv = head.rows((long)t * cols);
    return true;
  }
  __device__ FlashMask mask(int t) const {
    return {q_lo, t * cols, sk, off, causal};
  }
};

struct Strides {  // elements between batches, heads and rows
  long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int group, int sq, int sk, int d, int rows, int cols,
                       int causal, float qscale) {
  const int q_lo = blockIdx.x * rows;
  const int h = blockIdx.y;  // q head
  const int b = blockIdx.z;  // batch row
  const int hk = h / group;  // its kv head
  const int nq = min(rows, sq - q_lo);  // live query rows of the block
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), rows, cols, d);

  ac::load_rows(sm.qs, sm.stride, q + b * qs.b + h * qs.h + q_lo * qs.s, qs.s,
                nq, d, qscale);
  for (int i = threadIdx.x; i < (rows - nq) * sm.stride; i += blockDim.x)
    sm.qs[nq * sm.stride + i] = 0.f;  // rows past Sq: finite, never stored
  ac::init_state(sm, rows, d);

  const int off = sk - sq;  // suffix alignment of the queries
  int n = (sk + cols - 1) / cols;
  if (causal) {  // stop at the tile holding the last row's diagonal key
    const int last = q_lo + nq - 1 + off;
    n = min(n, last < 0 ? 0 : last / cols + 1);
  }
  const ac::RowsKV<T> head{k + b * ks.b + hk * ks.h, v + b * vs.b + hk * vs.h,
                           ks.s, vs.s, sk};
  FlashTiles<T> src{head, cols, sk, q_lo, off, causal};
  ac::attend_tiles(sm, rows, cols, d, n, src);
  __syncthreads();
  ac::store_rows(out + b * os.b + h * os.h + q_lo * os.s, os.s, sm, nq, d);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs,
           Strides ks, Strides vs, Strides os, int batch, int heads,
           int kv_heads, int sq, int sk, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  int cols = kCols;
  while (cols > 1 && !ac::RowsKV<T>::shapes_ok(cols, d, kThreads)) cols >>= 1;
  if (!ac::RowsKV<T>::shapes_ok(cols, d, kThreads))
    return (int)cudaErrorInvalidValue;
  int rows = kRows;
  while (rows > 8 && ac::Smem::bytes(rows, cols, d) > kMaxSmem) rows >>= 1;
  const size_t smem = ac::Smem::bytes(rows, cols, d);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + rows - 1) / rows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os,
      heads / kv_heads, sq, sk, d, rows, cols, causal, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; every row
// must start 16-byte aligned (the wrapper checks).  head_dim a multiple of
// 8.  Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for shapes it does not take.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    long long qb, long long qh, long long qs, long long kb, long long kh,
    long long ks, long long vb, long long vh, long long vs, long long ob,
    long long oh, long long os, int batch, int heads, int kv_heads, int sq,
    int sk, int d, int causal, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides qst{qb, qh, qs}, kst{kb, kh, ks}, vst{vb, vh, vs}, ost{ob, oh, os};
  if (dtype == 0)
    return launch<float>(q, k, v, out, qst, kst, vst, ost, batch, heads,
                         kv_heads, sq, sk, d, causal, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, qst, kst, vst, ost, batch,
                                 heads, kv_heads, sq, sk, d, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
