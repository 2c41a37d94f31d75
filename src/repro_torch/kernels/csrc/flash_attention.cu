// Contiguous flash-attention forward, GQA, causal or not.
//
// flash_attention_launch replaces the TPU kernel
// repro/kernels/flash_attention.py:25 (flash_attention_program): q (B, Hq,
// Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), out (B, Hq, Sq, Dv), each
// given by its batch, head and row strides in elements (the last dimension
// contiguous), so the (B, S, H, D) projections of a layer are read and
// written in place without a transposing copy.  Dv = D but for MLA's
// expanded heads (deepseek-v2-lite's training forward: keys of 128 nope +
// 64 rope columns, values of 128), which the TPU program, with one head_dim
// for Q, K, V and the output, does not take.  The causal mask aligns the queries to the
// suffix of the keys: query i may see key j when j <= i + Sk - Sq
// (flash_attention.py:69-75).  Scores and the softmax run in fp32; the
// output is rounded once to the input dtype.
//
// Three paths, chosen by the wrapper from dtype and shape alone
// (flash_attention.py, tensor_core_path):
//
// * wgmma, bf16 at (D, Dv) = (256, 256) (gemma-7b's training shape):
//   flash_attention_kernel_wg over hopper_attention.cuh.
//   - Bound on the H100: bytes.  At (B 8, 16 heads over 16, S 1024, causal)
//     Q, K, V and O are 268 MB, 0.080 ms at 3.35 TB/s, against 68.8 GFLOP,
//     0.070 ms at 989 TFLOP/s; P as the pair makes the tensor work 103
//     GFLOP.
//   - Why not mma.sync: a warp's 16 rows would hold O (16 x 256 fp32, 128
//     registers a thread) beside Q's fragments (64) and the scores, over
//     the 255-register limit.  A warpgroup's wgmma keeps O in registers
//     (128 a thread for 64 x 256) and reads Q and K from shared memory.
//   - Design: 128 query rows a block, one 64-row tile for each of two
//     consumer warpgroups; a producer thread copies both tiles, then
//     64-key tiles of K and V in 2 stages (a ring of full / empty
//     mbarriers), by TMA from 4-D maps over the (B, H, S, D) strides, so
//     the transposed views of the projections cost no copy and rows past
//     Sq or Sk arrive as zeros.  Each consumer walks the tiles up to its
//     own last row's diagonal (masking only the tiles that cross it or the
//     keys' end) and passes the block's later ones; S = Q . K^T by m64n64k16
//     with both operands in shared memory, the softmax in fp32 registers, P
//     as the bf16 pair hi + lo in registers times V read MN-major by
//     m64n256k16.  192 KB of shared memory, one block an SM; 168
//     registers at compile time (setmaxnreg: 232 a consumer, 40 the
//     producer), no spills.  64 x 2 read 0.294 ms at gemma's shape against
//     0.312-0.316 for 32 x 4 and 0.318-0.321 for 32 x 3 (the scores at N 64
//     read Q from shared memory half as often;
//     tools/d256_wgmma_ablation.py).  Grid (q head, batch, query tile) as
//     below.
// * mma.sync, bf16 at (D, Dv) = (64, 64), (128, 128) or (192, 128)
//   (the training shapes of qwen2-1.5B, granite, whisper, internvl2 and
//   deepseek-v2-lite): the online softmax of
//   attention_mma.cuh, P.V as the bf16 pair hi + lo (1.00 bf16 ulp on the
//   card; P rounded once would read 22-122).
//   - Bound on the H100: operations.  At qwen2-1.5B's training shapes (B 8,
//     Hq 12, S 1024, D 128, causal) the forward is 4 * B * Hq * S^2 * D / 2
//     = 25.8 GFLOP against 59 MB of Q, K, V and O: 26 us at 989 TFLOP/s,
//     18 us at 3.35 TB/s.  The pair makes the kernel's tensor-core work
//     1.5x that, on mma.sync.
//     At deepseek-v2-lite's (B 8, 16 heads over 16, S 1024, D 192, Dv 128,
//     causal) it is bytes: 168 MB of Q, K, V and O, 50 us at 3.35 TB/s,
//     against 43.0 GFLOP, 43 us at 989 TFLOP/s.
//   - Tiles: 128 query rows a block (8 warps of 16 rows), 64 keys a tile
//     through three cp.async stages, one barrier a tile; Q copied through
//     the last stage, then held in registers.  Shared memory 105 KB a
//     block at D 128, 56 KB at D 64; 189 and 138 registers a thread, no
//     spills, so one block an SM at D 128 (its registers), two at D 64.
//     At D 192 Q's 128 rows (51,200 bytes) overflow a stage of 64 keys
//     (43,008 bytes at 192 + 128), so Q comes through a place of its own:
//     181 KB a block; 227 registers a thread, no spills.
//   - Grid (q head, batch, query tile): the q head fastest, so the heads
//     of one KV head run together and read its tiles through L2; a causal
//     launch runs its query tiles last first, so the longest walks start
//     first.
//   - Causal: a warp skips the tiles past its last row's diagonal and
//     masks only the tiles that cross its rows' diagonals or the end of the
//     keys; a block stops at its last row's diagonal tile.
//   - What sets its time (2.9x SDPA at the training shape, PERF.md): each
//     warp's dependent chain through a tile (scores, softmax, the two P.V
//     products) rather than the tensor cores' rate; chip_smoke.py reads
//     the cost of one tile from the time against the walk's length.  Two
//     m-tiles a warp (each K and V fragment feeding both) hit the
//     255-register limit and spill; wgmma with P in registers is the next
//     step.
// * CUDA cores, fp32 (D 256 included) and bf16 at any other (D, Dv)
//   (multiples of 8):
//   attention_core.cuh's online softmax in fp32 shared memory, 64 query
//   rows a block, tiles of 32 keys, three barriers a tile.  At D 128 it
//   takes 109 KB of shared memory, one block an SM; on fp32 it is bound by
//   its fp32 FMAs (67 TFLOP/s), far above the bound.
//
// All take any Sq and Sk (the TPU program needs Sq % block_M == Sk %
// block_N == 0): a partial last query block loads and stores only its live
// rows, and a partial last key tile reads only its live rows and masks the
// rest.  A query row with no live key (causal with Sq > Sk) emits zeros,
// where the plain softmax gives NaN.

#include "attention_core.cuh"
#include "attention_mma.cuh"
#include "hopper_attention.cuh"

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

using am::Strides;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int group, int sq, int sk, int d, int dv, int rows, int cols,
                       int causal, float qscale) {
  const int q_lo = blockIdx.x * rows;
  const int h = blockIdx.y;  // q head
  const int b = blockIdx.z;  // batch row
  const int hk = h / group;  // its kv head
  const int nq = min(rows, sq - q_lo);  // live query rows of the block
  extern __shared__ float4 smem4[];
  ac::Smem sm(reinterpret_cast<float*>(smem4), rows, cols, d, dv, ac::Smem::OwnV{});

  ac::load_rows(sm.qs, sm.stride, q + b * qs.b + h * qs.h + q_lo * qs.s, qs.s,
                nq, d, qscale);
  for (int i = threadIdx.x; i < (rows - nq) * sm.stride; i += blockDim.x)
    sm.qs[nq * sm.stride + i] = 0.f;  // rows past Sq: finite, never stored
  ac::init_state(sm, rows, dv);

  const int off = sk - sq;  // suffix alignment of the queries
  int n = (sk + cols - 1) / cols;
  if (causal) {  // stop at the tile holding the last row's diagonal key
    const int last = q_lo + nq - 1 + off;
    n = min(n, last < 0 ? 0 : last / cols + 1);
  }
  const ac::RowsKV<T> head{k + b * ks.b + hk * ks.h, v + b * vs.b + hk * vs.h,
                           ks.s, vs.s, sk, dv};
  FlashTiles<T> src{head, cols, sk, q_lo, off, causal};
  ac::attend_tiles(sm, rows, cols, d, dv, n, src);
  __syncthreads();
  ac::store_rows(out + b * os.b + h * os.h + q_lo * os.s, os.s, sm, nq, dv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs,
           Strides ks, Strides vs, Strides os, int batch, int heads,
           int kv_heads, int sq, int sk, int d, int dv, int causal, float sm_scale,
           cudaStream_t stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  int cols = kCols;
  while (cols > 1 && !ac::RowsKV<T>::shapes_ok(cols, d, dv, kThreads)) cols >>= 1;
  if (!ac::RowsKV<T>::shapes_ok(cols, d, dv, kThreads))
    return (int)cudaErrorInvalidValue;
  int rows = kRows;
  while (rows > 8 && ac::Smem::bytes(rows, cols, d, dv) > kMaxSmem) rows >>= 1;
  const size_t smem = ac::Smem::bytes(rows, cols, d, dv);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + rows - 1) / rows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os,
      heads / kv_heads, sq, sk, d, dv, rows, cols, causal, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// ---- the tensor-core path ---------------------------------------------

// The (batch, kv head)'s keys in tiles of am::KEYS, and what each warp of a
// block of `rows` queries does with tile t.
struct FlashKeys {
  const am::bf16 *k, *v;
  long ks, vs;  // elements between key rows
  int sk, q_lo, nq, off, causal;

  __device__ bool row(int t, int r, const am::bf16*& kp, const am::bf16*& vp, int& pos) const {
    const int kj = t * am::KEYS + r;
    if (kj >= sk) return false;
    kp = k + kj * ks;
    vp = v + kj * vs;
    pos = kj;
    return true;
  }
  __device__ int kind(int t, int r0, int r1) const {  // a warp of block rows [r0, r1)
    if (r0 >= nq) return am::SKIP;  // no live row
    const int k0 = t * am::KEYS, k1 = k0 + am::KEYS - 1;
    if (causal && k0 > q_lo + min(r1, nq) - 1 + off) return am::SKIP;
    if (k1 < sk && (!causal || k1 <= q_lo + r0 + off)) return am::FULL;
    return am::MASKED;
  }
};

constexpr int kTcRows = 128;  // query rows a block: 8 warps of 16
constexpr int kTcStages = 3;

template <int DK, int DV>
__global__ void __launch_bounds__(am::MAX_ROWS * 2)
flash_attention_kernel_tc(const am::bf16* __restrict__ q, const am::bf16* __restrict__ k,
                          const am::bf16* __restrict__ v, am::bf16* __restrict__ out,
                          Strides qs, Strides ks, Strides vs, Strides os, int group, int sq,
                          int sk, int causal, float qscale) {
  const int rows = blockDim.x / 2;  // 16 a warp
  const int h = blockIdx.x;  // q head, the fastest axis
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int hk = h / group;
  const int q_lo = qt * rows;
  const int nq = min(rows, sq - q_lo);
  const int off = sk - sq;  // suffix alignment of the queries
  extern __shared__ float4 smem4[];
  const am::Ring<DK, DV, kTcStages> ring(smem4);

  int n = (sk + am::KEYS - 1) / am::KEYS;
  if (causal) {  // stop at the tile holding the last row's diagonal key
    const int last = q_lo + nq - 1 + off;
    n = min(n, last < 0 ? 0 : last / am::KEYS + 1);
  }
  const am::bf16* qb = q + b * qs.b + h * qs.h + q_lo * qs.s;
  const FlashKeys src{k + b * ks.b + hk * ks.h, v + b * vs.b + hk * vs.h, ks.s, vs.s, sk,
                      q_lo, nq, off, causal};
  const am::PosMask mask{nullptr, q_lo + off, 1, 0, causal != 0};
  am::WarpAttention<DK, DV> wa;
  am::attend(
      wa, ring, [&](int r) { return r < nq ? qb + r * qs.s : nullptr; }, n, src, mask, qscale,
      q);
  am::bf16* ob = out + b * os.b + h * os.h + q_lo * os.s;
  wa.store([&](int r) { return r < nq ? ob + r * os.s : nullptr; });
}

template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
              Strides vs, Strides os, int batch, int heads, int kv_heads, int sq, int sk,
              int causal, float sm_scale, cudaStream_t stream) {
  using B = am::bf16;
  const int qtiles = (sq + kTcRows - 1) / kTcRows;
  if (batch > 65535 || qtiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = am::Ring<DK, DV, kTcStages>::bytes();
  auto kernel = flash_attention_kernel_tc<DK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, batch, qtiles);
  kernel<<<grid, kTcRows * 2, smem, stream>>>((const B*)q, (const B*)k, (const B*)v, (B*)out, qs,
                                           ks, vs, os, heads / kv_heads, sq, sk, causal,
                                           sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

// ---- the warpgroup path: bf16 at (256, 256) ----------------------------

// WG_KEYS (keys a tile) and WG_STAGES (tiles in flight) come from the build:
// flash_attention.py states them once, for its shape rule and for this file.
#if !defined(WG_KEYS) || !defined(WG_STAGES)
#error "WG_KEYS and WG_STAGES are passed by build.py (flash_attention.KERNEL.defines)"
#endif
constexpr int WG_ROWS = 2 * ha::ROWS;     // query rows a block: one tile a consumer
using WgLayout = ha::Layout<WG_KEYS, WG_STAGES>;

// Block (q head, batch, query tile of 128 rows): the producer copies both
// consumers' query tiles, then key tiles up to the block's last live row's
// diagonal, by TMA from 4-D maps over the (B, H, S, D) strides (keys past
// Sk and rows past Sq arrive as zeros).  Consumer c walks rows [q_lo + 64
// c, + 64) over the tiles up to its own last row's diagonal, masking only
// the tiles that cross the diagonal or the end of the keys, and passes the
// rest.
__global__ void __launch_bounds__(ha::THREADS, 1)
flash_attention_kernel_wg(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, am::bf16* __restrict__ out,
                          Strides os, int group, int sq, int sk, int causal, float qscale) {
  using W = ha::Consumer<WG_KEYS, WG_STAGES>;
  extern __shared__ float4 smem4[];  // one declaration for the file's kernels
  uint8_t* smem = ha::aligned(smem4);
  const WgLayout lay(2);
  const ha::Bars<WG_STAGES> bars{reinterpret_cast<uint64_t*>(smem + lay.bars())};
  const int h = blockIdx.x;  // q head, the fastest axis
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int hk = h / group, q_lo = qt * WG_ROWS, nq = min(WG_ROWS, sq - q_lo);
  const int off = sk - sq;  // suffix alignment of the queries
  const int n_all = (sk + WG_KEYS - 1) / WG_KEYS;
  auto tiles = [&](int c) {  // consumer c's walk: to its last live row's diagonal
    const int live = min(ha::ROWS, nq - c * ha::ROWS);
    if (live <= 0) return 0;
    if (!causal) return n_all;
    const int last = q_lo + c * ha::ROWS + live - 1 + off;
    return last < 0 ? 0 : min(n_all, last / WG_KEYS + 1);
  };
  const int n = max(tiles(0), tiles(1));
  if (threadIdx.x == 0) bars.init(2);
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: one thread issues every copy
    hc::regs_dec<40>();
    if (threadIdx.x == 0) {
      const int q_tiles = nq > ha::ROWS ? 2 : 1;
      hc::mbar_expect_tx(bars.q(), q_tiles * ha::Q_BYTES);
      for (int i = 0; i < q_tiles; ++i)
        for (int j = 0; j < ha::BOXES; ++j)
          hc::tma_load_4d(smem + lay.q(i) + j * ha::Q_BOX, &tq, bars.q(), j * ha::BOX,
                          q_lo + i * ha::ROWS, h, b);
      for (int u = 0; u < n; ++u) {
        const int s = u % WG_STAGES, r = u / WG_STAGES;
        if (r > 0) hc::mbar_wait(&bars.empty()[s], (r - 1) & 1);  // its (r - 1)-th release
        hc::mbar_expect_tx(&bars.full[s], 2 * WgLayout::KV_BYTES);
        for (int j = 0; j < ha::BOXES; ++j) {
          hc::tma_load_4d(smem + lay.k(s) + j * WgLayout::K_BOX, &tk, &bars.full[s],
                          j * ha::BOX, u * WG_KEYS, hk, b);
          hc::tma_load_4d(smem + lay.v(s) + j * WgLayout::K_BOX, &tv, &bars.full[s],
                          j * ha::BOX, u * WG_KEYS, hk, b);
        }
      }
    }
    return;
  }
  hc::regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;
  W w(smem, lay, c, qscale);
  const int nc = tiles(c);
  const int q0 = q_lo + c * ha::ROWS;   // this consumer's first row
  const int nqc = nq - c * ha::ROWS;    // its live rows (at most 64; may be none)
  w.wait_q();
  for (int t = 0; t < nc; ++t) {
    const int k0 = t * WG_KEYS, k1 = k0 + WG_KEYS - 1;
    const bool masked = k1 >= sk || (causal && k1 > q0 + off);
    w.step(t, masked, [&](int r, int j) {
      const int kj = k0 + j;
      return kj < sk && (!causal || kj <= q0 + r + off);
    });
  }
  for (int t = nc; t < n; ++t) w.pass(t);
  am::bf16* ob = out + b * os.b + h * os.h + (long)q0 * os.s;
  w.store([&](int r) { return r < nqc ? ob + r * os.s : nullptr; });
}

int launch_wg(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
              Strides vs, Strides os, int batch, int heads, int kv_heads, int sq, int sk,
              int causal, float sm_scale, cudaStream_t stream) {
  using B = am::bf16;
  const int qtiles = (sq + WG_ROWS - 1) / WG_ROWS;
  if (batch > 65535 || qtiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = WgLayout(2).bytes(0);
  CUtensorMap tq, tk, tv;
  if (smem > (size_t)ha::MAX_SMEM ||
      !hc::tensor_map_4d<B>(&tq, q, batch, heads, sq, ha::D, qs.s, qs.h, qs.b, ha::ROWS) ||
      !hc::tensor_map_4d<B>(&tk, k, batch, kv_heads, sk, ha::D, ks.s, ks.h, ks.b, WG_KEYS) ||
      !hc::tensor_map_4d<B>(&tv, v, batch, kv_heads, sk, ha::D, vs.s, vs.h, vs.b, WG_KEYS))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel_wg;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, batch, qtiles);
  kernel<<<grid, ha::THREADS, smem, stream>>>(tq, tk, tv, (B*)out, os, heads / kv_heads, sq, sk,
                                              causal, sm_scale * ac::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tc 0 takes the CUDA-core kernel, tc 1
// the tensor-core kernels (bfloat16 at (d, dv) = (64, 64), (128, 128) or
// (192, 128) on mma.sync, (256, 256) on wgmma only).  q and k are d wide, v
// and out dv wide.  Strides are in elements; every row must start 16-byte
// aligned (the wrapper checks).  d
// and dv multiples of 8.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int flash_attention_launch(
    int dtype, int tc, const void* q, const void* k, const void* v, void* out,
    long long qb, long long qh, long long qs, long long kb, long long kh,
    long long ks, long long vb, long long vh, long long vs, long long ob,
    long long oh, long long os, int batch, int heads, int kv_heads, int sq,
    int sk, int d, int causal, int dv, float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides qst{qb, qh, qs}, kst{kb, kh, ks}, vst{vb, vh, vs}, ost{ob, oh, os};
  if (tc) {
    if (dtype != 1 || kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 || sk <= 0)
      return (int)cudaErrorInvalidValue;
    if (d == 128 && dv == 128)
      return launch_tc<128, 128>(q, k, v, out, qst, kst, vst, ost, batch, heads, kv_heads, sq,
                                 sk, causal, sm_scale, s);
    if (d == 64 && dv == 64)
      return launch_tc<64, 64>(q, k, v, out, qst, kst, vst, ost, batch, heads, kv_heads, sq, sk,
                               causal, sm_scale, s);
    if (d == 192 && dv == 128)
      return launch_tc<192, 128>(q, k, v, out, qst, kst, vst, ost, batch, heads, kv_heads, sq,
                                 sk, causal, sm_scale, s);
    if (d == 256 && dv == 256)
      return launch_wg(q, k, v, out, qst, kst, vst, ost, batch, heads, kv_heads, sq, sk, causal,
                       sm_scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch<float>(q, k, v, out, qst, kst, vst, ost, batch, heads,
                         kv_heads, sq, sk, d, dv, causal, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, qst, kst, vst, ost, batch,
                                 heads, kv_heads, sq, sk, d, dv, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
