// Mamba-2 SSD chunk kernels: chunk_state and chunk_scan.
//
// chunk_state_launch replaces the TPU kernel
// repro/kernels/linear_attention.py:21 (chunk_state_program): per (batch,
// head, chunk), the chunk's local state
//     S[n, p] = sum_l exp(dA[L-1] - dA[l]) * B[l, n] * X[l, p]
// from B (L, N) and X (L, P) in the model dtype and dA (L) fp32, written as
// (N, P) fp32.
//
// chunk_scan_launch replaces repro/kernels/linear_attention.py:58
// (chunk_scan_program): per (batch, head, chunk), the outputs
//     Y[l, p] = exp(dA[l]) * sum_n C[l, n] S_prev[n, p]
//             + sum_{m <= l} (sum_n C[l, n] B[m, n]) exp(dA[l] - dA[m]) X[m, p]
// with S_prev (N, P) the state carried into the chunk (fp32), rounded once
// to X's dtype.  The decay is taken only where l >= m, selected before the
// exp: above the diagonal dA[l] - dA[m] may be positive and overflow, and
// inf * 0 would be NaN (ref.py:610-614 selects the same way).
//
// Every tensor is addressed through its element strides of batch, head,
// chunk and row (the last dimension contiguous), so the head-broadcast B
// and C of a Mamba-2 layer (an expanded view, head stride 0) are read where
// they lie, without the 80 copies the reference's broadcast_to makes.  Rows
// are read an element at a time: any N and P work, rows that are not 16-byte
// aligned included (hymba's P 50 is 100 bytes a row in bf16).
//
// Bound on the H100 at mamba2-2.7B's training shapes (batch 8, 80 heads,
// 8 chunks of 128, N 128, P 64, bf16): bytes.  chunk_state reads B, X and dA
// and writes 168 MB of fp32 states for 10.7 GFLOP; chunk_scan reads C, B, X,
// dA and the carried states and writes Y for 42.9 GFLOP: under 0.25
// operations a byte, far below the card's ~295 (chip_smoke.py counts the
// bytes handed over, the expanded B and C once).  Both kernels' bf16
// launches at L, N and P multiples of 16 run on the tensor cores
// (chunk_state_kernel_tc and chunk_scan_kernel_tc below), each block taking
// a group of heads where B (and C) are broadcast over the heads: the scan
// computes C B^T once for the group (21.5 of the CUDA-core launch's 42.9
// GFLOP recomputed it for every head), the state stages B once for it.
// fp32, and shapes the tensor-core paths do not take (hymba's P 50), do
// their products on CUDA cores in fp32 (67 TFLOP/s at the card's peak, not
// the tensor cores' 989), so their arithmetic, not their bytes, sets their
// time.
//
// The CUDA-core design (256 threads a block, as 16 x 16; each thread owns rows ty + 16 i
// and columns tx + 16 j of an output tile, so a warp's shared-memory reads
// are one broadcast and one run of 16 consecutive words):
//   * chunk_state: one block per (batch, head, chunk) and tile of 128 state
//     rows by 64 columns of P.  B (scaled by its row's decay) and X are
//     staged in shared memory as fp32 ([L][128] and [L][64], 97 KB at L
//     128); the (N, P) tile accumulates in registers (8 x 4 a thread) over
//     the chunk's rows.  A state of at most 16 rows (hymba-1.5B's N 16)
//     takes a tile of 16 rows (1 x 4 a thread, 41 KB): the same sums in the
//     same order, without the 112 rows of zeros.
//   * chunk_scan: one block per (batch, head, chunk) and tile of 64 columns
//     of P.  (1) The (L, L) score tile C B^T accumulates in registers (8 x 8
//     a thread) over N in steps of 32 columns of C and B staged in shared
//     memory; the causal decay is applied and the tile is kept in shared
//     memory in fp32 (66 KB): scores are never rounded to bf16.  (2) Y's
//     intra-chunk part, scores times X, X staged in shared memory.  (3) The
//     carried part C S_prev over N in steps of 32, scaled by exp(dA[l]).
//     Shared memory is 101 KB, so two blocks fit an SM.
//   * exp is expf (no --use_fast_math): deep decays reach exp(-90), below
//     fp32's smallest normal, and expf keeps the denormals the plain
//     version keeps.
//   * L is at most 128 (the chunk of both SSM configs); rows past L in the
//     128-row tiles are zero-filled and never stored.

#include "mma_core.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxL = 128;     // rows of a chunk
constexpr int kTileN = 128;    // chunk_state: state rows a block
constexpr int kSmallTileN = 16;  // chunk_state: state rows a block at N <= 16
constexpr int kTileP = 64;     // columns of P a block, both kernels
constexpr int kStepN = 32;     // chunk_scan: columns of N a step
constexpr int kRm = kMaxL / 16;   // output rows a thread (8)
constexpr int kCp = kTileP / 16;  // columns of P a thread (4)
constexpr int kCm = kMaxL / 16;   // chunk_scan: score columns a thread (8)
constexpr int kLdStep = kStepN + 1;  // padded: rows of a warp hit distinct banks
constexpr int kLdAtt = kMaxL + 1;

struct Strides4 {  // elements between batches, heads, chunks and rows
  long long b, h, c, l;
};
struct Strides3 {  // dA: batches, heads and chunks; its rows are contiguous
  long long b, h, c;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Rows [0, kMaxL) x columns [0, COLS) of a row-major matrix (row stride rs,
// columns contiguous) into shared memory as fp32 with leading dimension ld:
// element (r, c) is src[r * rs + c] when r < rows and c < cols, else 0.
template <int COLS, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long rs, int rows, int cols) {
  for (int i = threadIdx.x; i < kMaxL * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    dst[r * ld + c] = (r < rows && c < cols) ? to_f(src[r * rs + c]) : 0.f;
  }
}

// TILE_N state rows a block (kTileN, or kSmallTileN where N is that small)
template <typename T, int TILE_N>
__global__ void __launch_bounds__(kThreads, 2)
chunk_state_kernel(const T* __restrict__ bm, const T* __restrict__ x,
                   const float* __restrict__ da, float* __restrict__ out,
                   Strides4 bs, Strides4 xs, Strides3 ds, Strides4 os,
                   int heads, int nchunks, int len, int n_state, int p_dim) {
  constexpr int kRn = TILE_N / 16;  // state rows a thread
  const int c = blockIdx.x % nchunks;
  const int bh = blockIdx.x / nchunks;
  const int h = bh % heads, b = bh / heads;
  const int n0 = blockIdx.y * TILE_N, p0 = blockIdx.z * kTileP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  extern __shared__ float smem[];
  float* bsm = smem;                    // [kMaxL][TILE_N]: w_l * B[l, n0 + n]
  float* xsm = bsm + kMaxL * TILE_N;    // [kMaxL][kTileP]: X[l, p0 + p]
  float* w = xsm + kMaxL * kTileP;      // [kMaxL]: exp(dA[L-1] - dA[l])

  const float* dap = da + b * ds.b + h * ds.h + c * ds.c;
  for (int l = threadIdx.x; l < kMaxL; l += kThreads)
    w[l] = l < len ? expf(dap[len - 1] - dap[l]) : 0.f;
  stage<kTileP>(xsm, kTileP, x + b * xs.b + h * xs.h + c * xs.c + p0, xs.l,
                len, p_dim - p0);
  __syncthreads();
  const T* bp = bm + b * bs.b + h * bs.h + c * bs.c + n0;
  const int n_live = n_state - n0;
  for (int i = threadIdx.x; i < kMaxL * TILE_N; i += kThreads) {
    const int r = i / TILE_N, col = i % TILE_N;
    bsm[i] = (r < len && col < n_live) ? to_f(bp[r * bs.l + col]) * w[r] : 0.f;
  }
  __syncthreads();

  float acc[kRn][kCp];
#pragma unroll
  for (int i = 0; i < kRn; ++i)
#pragma unroll
    for (int j = 0; j < kCp; ++j) acc[i][j] = 0.f;
  for (int l = 0; l < len; ++l) {
    float a[kRn], v[kCp];
#pragma unroll
    for (int i = 0; i < kRn; ++i) a[i] = bsm[l * TILE_N + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kCp; ++j) v[j] = xsm[l * kTileP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRn; ++i)
#pragma unroll
      for (int j = 0; j < kCp; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
  }
  float* op = out + b * os.b + h * os.h + c * os.c;
#pragma unroll
  for (int i = 0; i < kRn; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= n_state) continue;
#pragma unroll
    for (int j = 0; j < kCp; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p < p_dim) op[n * os.l + p] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_scan_kernel(const T* __restrict__ cm, const T* __restrict__ bm,
                  const T* __restrict__ x, const float* __restrict__ da,
                  const float* __restrict__ prev, T* __restrict__ y,
                  Strides4 cs, Strides4 bs, Strides4 xs, Strides3 ds,
                  Strides4 ps, Strides4 ys, int heads, int nchunks, int len,
                  int n_state, int p_dim) {
  const int c = blockIdx.x % nchunks;
  const int bh = blockIdx.x / nchunks;
  const int h = bh % heads, b = bh / heads;
  const int p0 = blockIdx.y * kTileP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  extern __shared__ float smem[];
  float* att = smem;                       // [kMaxL][kLdAtt]: decayed scores
  float* region = att + kMaxL * kLdAtt;    // staged operands, reused by phase
  float* dsm = region + 2 * kMaxL * kLdStep;  // [kMaxL]: dA[l]
  float* csm = region;                     // [kMaxL][kLdStep]: C[:, n0:n0+32]
  float* bsm = region + kMaxL * kLdStep;   // [kMaxL][kLdStep]: B[:, n0:n0+32]
  float* ssm = region + kMaxL * kLdStep;   // [kStepN][kTileP]: S_prev rows
  float* xsm = region;                     // [kMaxL][kTileP]: X

  const T* cp = cm + b * cs.b + h * cs.h + c * cs.c;
  const T* bp = bm + b * bs.b + h * bs.h + c * bs.c;
  const float* dap = da + b * ds.b + h * ds.h + c * ds.c;
  for (int l = threadIdx.x; l < kMaxL; l += kThreads)
    dsm[l] = l < len ? dap[l] : 0.f;

  // (1) scores C B^T, (L, L), over N in steps of kStepN
  float acc[kRm][kCm];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < kCm; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < n_state; n0 += kStepN) {
    __syncthreads();  // the previous step's reads are done
    stage<kStepN>(csm, kLdStep, cp + n0, cs.l, len, n_state - n0);
    stage<kStepN>(bsm, kLdStep, bp + n0, bs.l, len, n_state - n0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStepN; ++k) {
      float a[kRm], v[kCm];
#pragma unroll
      for (int i = 0; i < kRm; ++i) a[i] = csm[(ty + 16 * i) * kLdStep + k];
#pragma unroll
      for (int j = 0; j < kCm; ++j) v[j] = bsm[(tx + 16 * j) * kLdStep + k];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kCm; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
  }
  // the causal decay, selected before the exp; then the tile to shared
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int l = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kCm; ++j) {
      const int m = tx + 16 * j;
      att[l * kLdAtt + m] =
          (m <= l && l < len) ? acc[i][j] * expf(dsm[l] - dsm[m]) : 0.f;
    }
  }
  __syncthreads();  // scores written; the staging region is free

  // (2) the intra-chunk part: scores x X
  stage<kTileP>(xsm, kTileP, x + b * xs.b + h * xs.h + c * xs.c + p0, xs.l,
                len, p_dim - p0);
  __syncthreads();
  float y_intra[kRm][kCp], y_inter[kRm][kCp];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < kCp; ++j) y_intra[i][j] = y_inter[i][j] = 0.f;
  for (int m = 0; m < len; ++m) {
    float a[kRm], v[kCp];
#pragma unroll
    for (int i = 0; i < kRm; ++i) a[i] = att[(ty + 16 * i) * kLdAtt + m];
#pragma unroll
    for (int j = 0; j < kCp; ++j) v[j] = xsm[m * kTileP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kCp; ++j)
        y_intra[i][j] = fmaf(a[i], v[j], y_intra[i][j]);
  }

  // (3) the carried part: C S_prev, over N in steps of kStepN
  const float* pp = prev + b * ps.b + h * ps.h + c * ps.c + p0;
  for (int n0 = 0; n0 < n_state; n0 += kStepN) {
    __syncthreads();  // X, or the previous step, is no longer read
    stage<kStepN>(csm, kLdStep, cp + n0, cs.l, len, n_state - n0);
    const int rows = min(kStepN, n_state - n0);
    for (int i = threadIdx.x; i < kStepN * kTileP; i += kThreads) {
      const int r = i / kTileP, col = i % kTileP;
      ssm[i] = (r < rows && col < p_dim - p0) ? pp[(n0 + r) * ps.l + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStepN; ++k) {
      float a[kRm], v[kCp];
#pragma unroll
      for (int i = 0; i < kRm; ++i) a[i] = csm[(ty + 16 * i) * kLdStep + k];
#pragma unroll
      for (int j = 0; j < kCp; ++j) v[j] = ssm[k * kTileP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kCp; ++j)
          y_inter[i][j] = fmaf(a[i], v[j], y_inter[i][j]);
    }
  }

  T* yp = y + b * ys.b + h * ys.h + c * ys.c;
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int l = ty + 16 * i;
    if (l >= len) continue;
    const float scale = expf(dsm[l]);
#pragma unroll
    for (int j = 0; j < kCp; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p < p_dim)
        yp[l * ys.l + p] = from_f<T>(y_inter[i][j] * scale + y_intra[i][j]);
    }
  }
}

// ---- chunk_scan on the tensor cores (bf16) ---------------------------------
//
// One block per (batch, chunk, group of heads) and tile of 64 columns of P,
// L / 16 warps, each holding one m-tile of 16 rows of the chunk:
//   * scores: S = C B^T accumulated in fp32 by mma.sync m16n8k16 from the
//     bf16 C and B staged in shared memory (the products are exact; only
//     the order of the fp32 sums differs from the plain version), only the
//     column tiles at or left of the warp's diagonal.  The warp keeps its
//     16 rows of S in registers (C accumulator layout = A fragment layout,
//     as P in attention), and where C and B have head stride 0 (a Mamba-2
//     layer's head-broadcast views) S serves every head of the group: it is
//     computed once a block, not once a head.
//   * per head, its X (L x 64, bf16) and carried state S_prev (N x 64,
//     fp32) and dA come by cp.async into one of two buffers while the
//     previous head is computed.  S_prev is split as it is staged into
//     three bf16 terms hi + mid + lo (each the rounding of what the ones
//     before leave: fp32's 24 significant bits), so C S_prev is three
//     tensor-core products, scaled by exp(dA_l) in fp32; then the decayed
//     scores S exp(dA_l - dA_m), the decay selected before the expf (m <=
//     l), go to the tensor cores as three terms too and multiply X, with
//     the tiles above the diagonal skipped.  Both operands carry signs, and
//     a row's sum of 128 products can cancel to far below its terms: one
//     bf16 rounding of the scores reads 4.6-14724 bf16 ulps from the plain
//     value (chip_smoke.py's bf16_scores control); the pair hi + lo that
//     serves attention's positive P fails the 2-ulp limit for either
//     operand in a plain-PyTorch rehearsal
//     (tests/test_torch_quant_prefill_ssd_tc.py) and read 14 ulps on the
//     card for S_prev at shallow decay; three terms pass.  Y is rounded
//     once to bf16 and stored from the fragments.
//   * expf as above (no fast math): the denormals of deep decays survive.
// Shared memory at L 128, N 128: C, B (its space then holds S_prev's three
// terms), two buffers of X, S_prev and dA: 193 KB, one block an SM; rows
// padded by 16 bytes, so the rows of a warp's ldmatrix fall on distinct
// banks.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int PT = 64;       // columns of P a block
constexpr int MAX_N = 128;   // state width the shared memory holds
constexpr int XST = PT + 8;  // bf16 between rows of X and of hi / lo
constexpr int SST = PT + 4;  // fp32 between rows of staged S_prev

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// x = hi + mid + lo for two neighbouring values, three bf16 terms (24
// significant bits, fp32's), each half a bf16 pair (the lower column in
// the low 16 bits, as mma's A fragment wants)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;  // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}
// x = hi + lo for two neighbouring values, a bf16 pair each (chunk_state's
// decayed X: 16 significant bits)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

struct Smem {
  bf16 *cs, *bs, *hi, *mid, *lo, *x0, *x1;
  float *s0, *s1, *d0, *d1;
  int cst;  // bf16 between rows of C and B

  __device__ Smem(void* base, int len, int n) : cst(n + 8) {
    cs = reinterpret_cast<bf16*>(base);
    bs = cs + len * cst;
    hi = bs;  // B is read only before the first head's split
    mid = hi + n * XST;
    lo = mid + n * XST;
    bf16* end = bs + region(len, n);
    x0 = end;
    x1 = x0 + len * XST;
    s0 = reinterpret_cast<float*>(x1 + len * XST);
    s1 = s0 + n * SST;
    d0 = s1 + n * SST;
    d1 = d0 + len;
  }
  // elements of B's place: B, then S_prev's three terms
  __host__ __device__ static int region(int len, int n) {
    return len * (n + 8) > 3 * n * XST ? len * (n + 8) : 3 * n * XST;
  }
  static size_t bytes(int len, int n) {
    return sizeof(bf16) * ((size_t)len * (n + 8) + region(len, n) + 2 * (size_t)len * XST) +
           sizeof(float) * (2 * (size_t)n * SST + 2 * (size_t)len);
  }
};

__global__ void __launch_bounds__(kMaxL * 2, 1)
chunk_scan_kernel_tc(const bf16* __restrict__ cm, const bf16* __restrict__ bm,
                     const bf16* __restrict__ x, const float* __restrict__ da,
                     const float* __restrict__ prev, bf16* __restrict__ y, Strides4 cs,
                     Strides4 bs, Strides4 xs, Strides3 ds, Strides4 ps, Strides4 ys,
                     int heads, int nchunks, int groups, int hg, int len, int n_state,
                     int p_dim) {
  const int gi = blockIdx.x % groups;
  const int bc = blockIdx.x / groups;
  const int c = bc % nchunks, b = bc / nchunks;
  const int h0 = gi * hg, nh = min(hg, heads - h0);
  const int p0 = blockIdx.y * PT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  // the warp's m-tile: warps w and w + 4 share a scheduler, so the second
  // half takes the m-tiles in reverse and each pair walks the same number
  // of score tiles left of its diagonals
  const int mt = warp < warps / 2 ? warp : warps + warps / 2 - 1 - warp;
  const int g = lane >> 2, t = lane & 3, l0 = mt * 16;
  extern __shared__ float4 smem4[];
  const Smem sm(smem4, len, n_state);

  // C and B of the group's first head: the head stride is 0 wherever the
  // group holds more than one head
  {
    const bf16* cp = cm + b * cs.b + h0 * cs.h + c * cs.c;
    const bf16* bp = bm + b * bs.b + h0 * bs.h + c * bs.c;
    const int vecs = n_state / 8;
    for (int i = threadIdx.x; i < len * vecs; i += blockDim.x) {
      const int r = i / vecs, k = (i % vecs) * 8;
      gc::cp_async<16>(sm.cs + r * sm.cst + k, cp + r * cs.l + k, true);
      gc::cp_async<16>(sm.bs + r * sm.cst + k, bp + r * bs.l + k, true);
    }
  }
  // head h0 + i's X, S_prev and dA into buffer `buf`; columns past P are
  // zero-filled
  auto load_head = [&](int i, int buf) {
    const int h = h0 + i;
    const bf16* xp = x + b * xs.b + h * xs.h + c * xs.c + p0;
    const float* sp = prev + b * ps.b + h * ps.h + c * ps.c + p0;
    const float* dp = da + b * ds.b + h * ds.h + c * ds.c;
    bf16* xd = buf ? sm.x1 : sm.x0;
    float* sd = buf ? sm.s1 : sm.s0;
    float* dd = buf ? sm.d1 : sm.d0;
    for (int k = threadIdx.x; k < len * (PT / 8); k += blockDim.x) {
      const int r = k / (PT / 8), col = (k % (PT / 8)) * 8;
      const bool live = p0 + col < p_dim;
      gc::cp_async<16>(xd + r * XST + col, live ? xp + r * xs.l + col : xp, live);
    }
    for (int k = threadIdx.x; k < n_state * (PT / 4); k += blockDim.x) {
      const int r = k / (PT / 4), col = (k % (PT / 4)) * 4;
      const bool live = p0 + col < p_dim;
      gc::cp_async<16>(sd + r * SST + col, live ? sp + r * ps.l + col : sp, live);
    }
    for (int k = threadIdx.x; k < len; k += blockDim.x) gc::cp_async<4>(dd + k, dp + k, true);
  };
  load_head(0, 0);
  gc::cp_async_commit();
  gc::cp_async_wait<0>();
  __syncthreads();

  // S = C B^T for the warp's rows, the column tiles up to its diagonal
  float s[kMaxL / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int kk = 0; kk < n_state / 16; ++kk) {
    uint32_t a[4];
    gc::ldmatrix_x4(a, sm.cs + (l0 + (lane & 15)) * sm.cst + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kMaxL / 8; j += 2) {
      if (j > 2 * mt) continue;  // right of the diagonal tile
      uint32_t bb[4];
      gc::ldmatrix_x4(bb, sm.bs + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * sm.cst + kk * 16 +
                              ((lane >> 3) & 1) * 8);
      gc::mma16816<bf16>(s[j], a, bb[0], bb[1]);
      gc::mma16816<bf16>(s[j + 1], a, bb[2], bb[3]);
    }
  }

  for (int i = 0; i < nh; ++i) {
    const int buf = i & 1;
    gc::cp_async_wait<0>();
    __syncthreads();  // head i landed for all; head i - 1 (and S's B) fully read
    if (i + 1 < nh) load_head(i + 1, buf ^ 1);
    gc::cp_async_commit();
    {  // S_prev as three bf16 terms
      const float* sd = buf ? sm.s1 : sm.s0;
      for (int k = threadIdx.x; k < n_state * (PT / 4); k += blockDim.x) {
        const int r = k / (PT / 4), col = (k % (PT / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(sd + r * SST + col);
        uint2 h2, m2, l2;
        split3(v.x, v.y, h2.x, m2.x, l2.x);
        split3(v.z, v.w, h2.y, m2.y, l2.y);
        *reinterpret_cast<uint2*>(sm.hi + r * XST + col) = h2;
        *reinterpret_cast<uint2*>(sm.mid + r * XST + col) = m2;
        *reinterpret_cast<uint2*>(sm.lo + r * XST + col) = l2;
      }
    }
    __syncthreads();
    const bf16* xd = buf ? sm.x1 : sm.x0;
    const float* dd = buf ? sm.d1 : sm.d0;
    const float dl[2] = {dd[l0 + g], dd[l0 + g + 8]};
    float acc[PT / 8][4];
#pragma unroll
    for (int j = 0; j < PT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // the carried part: C S_prev = C hi + C mid + C lo, then times exp(dA_l)
    for (int kk = 0; kk < n_state / 16; ++kk) {
      uint32_t a[4];
      gc::ldmatrix_x4(a, sm.cs + (l0 + (lane & 15)) * sm.cst + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < PT / 8; j += 2) {
        const int at = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XST + j * 8 +
                       (lane >> 4) * 8;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          uint32_t bt[4];
          gc::ldmatrix_x4_trans(bt, (term == 0 ? sm.hi : term == 1 ? sm.mid : sm.lo) + at);
          gc::mma16816<bf16>(acc[j], a, bt[0], bt[1]);
          gc::mma16816<bf16>(acc[j + 1], a, bt[2], bt[3]);
        }
      }
    }
    const float el[2] = {expf(dl[0]), expf(dl[1])};
#pragma unroll
    for (int j = 0; j < PT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= el[e >> 1];
    // the chunk's own part: the decayed scores (three terms) times X, the
    // column tiles at or left of the diagonal
#pragma unroll
    for (int kk = 0; kk < kMaxL / 16; ++kk) {
      if (kk > mt) continue;
      uint32_t ph[4], pm[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // n-tiles 2 kk and 2 kk + 1 of S
        const int j = 2 * kk + half, m = j * 8 + 2 * t;
        const float2 dm = *reinterpret_cast<const float2*>(dd + m);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = l0 + g + 8 * (e >> 1), mc = m + (e & 1);
          v[e] = mc <= l ? s[j][e] * expf(dl[e >> 1] - ((e & 1) ? dm.y : dm.x)) : 0.f;
        }
        split3(v[0], v[1], ph[2 * half], pm[2 * half], pl[2 * half]);
        split3(v[2], v[3], ph[2 * half + 1], pm[2 * half + 1], pl[2 * half + 1]);
      }
#pragma unroll
      for (int j = 0; j < PT / 8; j += 2) {
        uint32_t bx[4];
        gc::ldmatrix_x4_trans(bx, xd + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XST +
                                      j * 8 + (lane >> 4) * 8);
        gc::mma16816<bf16>(acc[j], ph, bx[0], bx[1]);
        gc::mma16816<bf16>(acc[j], pm, bx[0], bx[1]);
        gc::mma16816<bf16>(acc[j], pl, bx[0], bx[1]);
        gc::mma16816<bf16>(acc[j + 1], ph, bx[2], bx[3]);
        gc::mma16816<bf16>(acc[j + 1], pm, bx[2], bx[3]);
        gc::mma16816<bf16>(acc[j + 1], pl, bx[2], bx[3]);
      }
    }
    bf16* yp = y + b * ys.b + (h0 + i) * ys.h + c * ys.c + p0;
#pragma unroll
    for (int j = 0; j < PT / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (p0 + col >= p_dim) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        gc::store2(yp + (l0 + g + 8 * rr) * ys.l + col, acc[j][2 * rr], acc[j][2 * rr + 1]);
    }
  }
}

// ---- chunk_state on the tensor cores (bf16) --------------------------------
//
// One block per (batch, chunk, group of heads) and tile of 64 columns of P,
// N / 16 warps, each holding one m-tile of 16 state rows:
//   * S (N x P) = B^T Xd, Xd[l, p] = exp(dA[L-1] - dA[l]) X[l, p]: the decay
//     goes on X (formed in fp32 per head), not on B as the plain version
//     puts it, so one B serves every head of the group.  B (L x N, bf16) is
//     staged once a block, the group's heads share it where its head stride
//     is 0, and each warp holds its m-tile of B^T as A fragments in
//     registers for the whole walk (ldmatrix.trans of B's row-major tile).
//   * per head, its X (L x 64, bf16) and dA come by cp.async into one of two
//     buffers while the previous head is computed; Xd is split as it is
//     formed into the bf16 pair hi + lo (lo the rounding of what hi leaves),
//     so S is two tensor-core products, B^T hi + B^T lo, summed in fp32 by
//     mma.sync m16n8k16 over the chunk's rows.  The states are not rounded:
//     the limit is 1e-4 of max(1, max |plain|), and the pair reads 2.7e-6 -
//     3.7e-6 of it where Xd rounded once to bf16 reads 1.5e-3 - 2.1e-3 in a
//     plain-PyTorch rehearsal (tests/test_torch_quant_decode_state_tc.py).
//   * the fp32 states are stored straight from the accumulator fragments
//     (streaming stores); the exponent dA[L-1] - dA[l] is <= 0 and goes
//     through expf (no fast math), so the denormals of deep decays survive.
// Shared memory at L 128, N 128: B, two buffers of X and dA, and Xd's two
// terms: 107 KB, two blocks an SM; rows padded by 16 bytes, so the rows of a
// warp's ldmatrix fall on distinct banks.  At mamba2's training shape a
// block takes 20 heads (256 blocks), ~1.7x the launch's bound on the H100
// (PERF.md).  tools/chunk_state_ablation.py times the kernel with one part
// taken out: the stores, the terms' formation, the mma or the lo term each
// save a sixth to a tenth, so no one part sets the time; the per-head chain
// does (two barriers, and each of the 8 warps reads all of Xd's terms from
// shared memory: 256 KB a head a block).
struct StateSmem {
  bf16 *bs, *x0, *x1, *hi, *lo;
  float *d0, *d1;
  int bst;  // bf16 between rows of B

  __device__ StateSmem(void* base, int len, int n) : bst(n + 8) {
    bs = reinterpret_cast<bf16*>(base);
    x0 = bs + len * bst;
    x1 = x0 + len * XST;
    hi = x1 + len * XST;
    lo = hi + len * XST;
    d0 = reinterpret_cast<float*>(lo + len * XST);
    d1 = d0 + len;
  }
  static size_t bytes(int len, int n) {
    return sizeof(bf16) * ((size_t)len * (n + 8) + 4 * (size_t)len * XST) +
           sizeof(float) * 2 * (size_t)len;
  }
};

__global__ void __launch_bounds__(MAX_N * 2, 2)
chunk_state_kernel_tc(const bf16* __restrict__ bm, const bf16* __restrict__ x,
                      const float* __restrict__ da, float* __restrict__ out, Strides4 bs,
                      Strides4 xs, Strides3 ds, Strides4 os, int heads, int nchunks, int groups,
                      int hg, int len, int n_state, int p_dim) {
  const int gi = blockIdx.x % groups;
  const int bc = blockIdx.x / groups;
  const int c = bc % nchunks, b = bc / nchunks;
  const int h0 = gi * hg, nh = min(hg, heads - h0);
  const int p0 = blockIdx.y * PT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, n0 = warp * 16;
  extern __shared__ float4 smem4[];
  const StateSmem sm(smem4, len, n_state);

  // B of the group's first head: the head stride is 0 wherever the group
  // holds more than one head
  {
    const bf16* bp = bm + b * bs.b + h0 * bs.h + c * bs.c;
    const int vecs = n_state / 8;
    for (int i = threadIdx.x; i < len * vecs; i += blockDim.x) {
      const int r = i / vecs, k = (i % vecs) * 8;
      gc::cp_async<16>(sm.bs + r * sm.bst + k, bp + r * bs.l + k, true);
    }
  }
  // head h0 + i's X and dA into buffer `buf`; columns past P are zero-filled
  auto load_head = [&](int i, int buf) {
    const int h = h0 + i;
    const bf16* xp = x + b * xs.b + h * xs.h + c * xs.c + p0;
    const float* dp = da + b * ds.b + h * ds.h + c * ds.c;
    bf16* xd = buf ? sm.x1 : sm.x0;
    float* dd = buf ? sm.d1 : sm.d0;
    for (int k = threadIdx.x; k < len * (PT / 8); k += blockDim.x) {
      const int r = k / (PT / 8), col = (k % (PT / 8)) * 8;
      const bool live = p0 + col < p_dim;
      gc::cp_async<16>(xd + r * XST + col, live ? xp + r * xs.l + col : xp, live);
    }
    for (int k = threadIdx.x; k < len; k += blockDim.x) gc::cp_async<4>(dd + k, dp + k, true);
  };
  load_head(0, 0);
  gc::cp_async_commit();
  gc::cp_async_wait<0>();
  __syncthreads();

  // the warp's m-tile of B^T, every k-step of the chunk's rows
  uint32_t bt[kMaxL / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxL / 16; ++kk)
    if (kk < len / 16)
      gc::ldmatrix_x4_trans(bt[kk], sm.bs + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * sm.bst +
                                        n0 + ((lane >> 3) & 1) * 8);

  for (int i = 0; i < nh; ++i) {
    const int buf = i & 1;
    if (i > 0) {
      gc::cp_async_wait<0>();
      __syncthreads();  // head i landed for all; head i - 1's terms fully read
    }
    if (i + 1 < nh) load_head(i + 1, buf ^ 1);
    gc::cp_async_commit();
    {  // Xd = exp(dA[L-1] - dA[l]) X as the pair hi + lo, 8 columns a thread
      const bf16* xd = buf ? sm.x1 : sm.x0;
      const float* dd = buf ? sm.d1 : sm.d0;
      const float last = dd[len - 1];
      for (int k = threadIdx.x; k < len * (PT / 8); k += blockDim.x) {
        const int r = k / (PT / 8), col = (k % (PT / 8)) * 8;
        const float w = expf(last - dd[r]);
        const uint4 v = *reinterpret_cast<const uint4*>(xd + r * XST + col);
        uint4 h, l;
        auto decay = [&](uint32_t u, uint32_t& hu, uint32_t& lu) {  // a bf16 pair
          split2(__uint_as_float(u << 16) * w, __uint_as_float(u & 0xffff0000u) * w, hu, lu);
        };
        decay(v.x, h.x, l.x);
        decay(v.y, h.y, l.y);
        decay(v.z, h.z, l.z);
        decay(v.w, h.w, l.w);
        *reinterpret_cast<uint4*>(sm.hi + r * XST + col) = h;
        *reinterpret_cast<uint4*>(sm.lo + r * XST + col) = l;
      }
    }
    __syncthreads();
    float acc[PT / 8][4];
#pragma unroll
    for (int j = 0; j < PT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxL / 16; ++kk) {
      if (kk >= len / 16) continue;
#pragma unroll
      for (int j = 0; j < PT / 8; j += 2) {
        const int at = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XST + j * 8 +
                       (lane >> 4) * 8;
        uint32_t xh[4], xl[4];
        gc::ldmatrix_x4_trans(xh, sm.hi + at);
        gc::ldmatrix_x4_trans(xl, sm.lo + at);
        gc::mma16816<bf16>(acc[j], bt[kk], xh[0], xh[1]);
        gc::mma16816<bf16>(acc[j], bt[kk], xl[0], xl[1]);
        gc::mma16816<bf16>(acc[j + 1], bt[kk], xh[2], xh[3]);
        gc::mma16816<bf16>(acc[j + 1], bt[kk], xl[2], xl[3]);
      }
    }
    // streaming stores (evict first): the 168 MB of states at mamba2's
    // training shape pass L2 once (a few % faster than plain stores:
    // tools/chunk_state_ablation.py)
    float* op = out + b * os.b + (h0 + i) * os.h + c * os.c + p0;
#pragma unroll
    for (int j = 0; j < PT / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (p0 + col >= p_dim) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        __stcs(reinterpret_cast<float2*>(op + (n0 + g + 8 * rr) * os.l + col),
               make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]));
    }
  }
}

}  // namespace tc

bool shapes_ok(int batch, int heads, int nchunks, int len, int n_state,
               int p_dim) {
  const long long blocks = (long long)batch * heads * nchunks;
  return batch > 0 && heads > 0 && nchunks > 0 && len > 0 && len <= kMaxL &&
         n_state > 0 && p_dim > 0 && blocks < (1LL << 31) &&
         (n_state + kTileN - 1) / kTileN <= 65535 &&
         (p_dim + kTileP - 1) / kTileP <= 65535;
}

template <typename T>
int launch_state(const void* bm, const void* x, const void* da, void* out,
                 Strides4 bs, Strides4 xs, Strides3 ds, Strides4 os,
                 int batch, int heads, int nchunks, int len, int n_state,
                 int p_dim, cudaStream_t stream) {
  if (!shapes_ok(batch, heads, nchunks, len, n_state, p_dim))
    return (int)cudaErrorInvalidValue;
  const bool small = n_state <= kSmallTileN;
  const int tile_n = small ? kSmallTileN : kTileN;
  const size_t smem = (kMaxL * tile_n + kMaxL * kTileP + kMaxL) * sizeof(float);
  auto kernel = small ? &chunk_state_kernel<T, kSmallTileN> : &chunk_state_kernel<T, kTileN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * heads * nchunks, (n_state + tile_n - 1) / tile_n,
            (p_dim + kTileP - 1) / kTileP);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)bm, (const T*)x, (const float*)da, (float*)out, bs, xs, ds, os,
      heads, nchunks, len, n_state, p_dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scan(const void* cm, const void* bm, const void* x, const void* da,
                const void* prev, void* y, Strides4 cs, Strides4 bs,
                Strides4 xs, Strides3 ds, Strides4 ps, Strides4 ys, int batch,
                int heads, int nchunks, int len, int n_state, int p_dim,
                cudaStream_t stream) {
  if (!shapes_ok(batch, heads, nchunks, len, n_state, p_dim))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (kMaxL * kLdAtt + 2 * kMaxL * kLdStep + kMaxL) * sizeof(float);
  static_assert(kMaxL * kTileP <= 2 * kMaxL * kLdStep, "X fits the region");
  static_assert(kStepN * kTileP <= kMaxL * kLdStep, "S_prev fits the region");
  auto kernel = chunk_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * heads * nchunks, (p_dim + kTileP - 1) / kTileP);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)cm, (const T*)bm, (const T*)x, (const float*)da,
      (const float*)prev, (T*)y, cs, bs, xs, ds, ps, ys, heads, nchunks, len,
      n_state, p_dim);
  return (int)cudaGetLastError();
}

// Rows that 16-byte copies can read: the start and every stride a multiple
// of 16 bytes (elems elements).
bool rows16(const void* p, Strides4 st, int elems) {
  return (long long)(size_t)p % 16 == 0 && st.b % elems == 0 && st.h % elems == 0 &&
         st.c % elems == 0 && st.l % elems == 0;
}

// Whether the tensor-core kernels' grid takes these shapes (chunk_scan.py's
// tensor_core_path plus the grid's limits): L, N and P multiples of 16, L
// and N within shared memory, `groups` blocks of hg heads covering the
// heads.
bool tc_grid_ok(int batch, int heads, int nchunks, int groups, int hg, int len, int n_state,
                int p_dim) {
  const long long blocks = (long long)batch * nchunks * groups;
  return len % 16 == 0 && len > 0 && len <= kMaxL && n_state % 16 == 0 && n_state > 0 &&
         n_state <= tc::MAX_N && p_dim % 16 == 0 && p_dim > 0 && hg >= 1 && groups >= 1 &&
         (long long)hg * groups >= heads && (long long)hg * (groups - 1) < heads &&
         blocks < (1LL << 31) && (p_dim + tc::PT - 1) / tc::PT <= 65535;
}

// The tensor-core scan's rule: its grid's, C and B of head stride 0 unless
// a block takes one head, and rows its cp.async copies can read.
bool tc_shapes_ok(const void* cm, const void* bm, const void* x, const void* prev,
                  Strides4 cs, Strides4 bs, Strides4 xs, Strides4 ps, int batch, int heads,
                  int nchunks, int groups, int hg, int len, int n_state, int p_dim) {
  return tc_grid_ok(batch, heads, nchunks, groups, hg, len, n_state, p_dim) &&
         (hg == 1 || (cs.h == 0 && bs.h == 0)) && rows16(cm, cs, 8) && rows16(bm, bs, 8) &&
         rows16(x, xs, 8) && rows16(prev, ps, 4);
}

int launch_state_tc(const void* bm, const void* x, const void* da, void* out, Strides4 bs,
                    Strides4 xs, Strides3 ds, Strides4 os, int batch, int heads, int nchunks,
                    int hg, int len, int n_state, int p_dim, cudaStream_t stream) {
  const int groups = hg > 0 ? (heads + hg - 1) / hg : 0;
  if (!tc_grid_ok(batch, heads, nchunks, groups, hg, len, n_state, p_dim) ||
      (hg > 1 && bs.h != 0) || !rows16(bm, bs, 8) || !rows16(x, xs, 8) || !rows16(out, os, 4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc::StateSmem::bytes(len, n_state);
  auto kernel = tc::chunk_state_kernel_tc;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * nchunks * groups, (p_dim + tc::PT - 1) / tc::PT);
  kernel<<<grid, n_state * 2, smem, stream>>>((const tc::bf16*)bm, (const tc::bf16*)x,
                                              (const float*)da, (float*)out, bs, xs, ds, os,
                                              heads, nchunks, groups, hg, len, n_state, p_dim);
  return (int)cudaGetLastError();
}

int launch_scan_tc(const void* cm, const void* bm, const void* x, const void* da,
                   const void* prev, void* y, Strides4 cs, Strides4 bs, Strides4 xs,
                   Strides3 ds, Strides4 ps, Strides4 ys, int batch, int heads, int nchunks,
                   int hg, int len, int n_state, int p_dim, cudaStream_t stream) {
  const int groups = hg > 0 ? (heads + hg - 1) / hg : 0;
  if (!tc_shapes_ok(cm, bm, x, prev, cs, bs, xs, ps, batch, heads, nchunks, groups, hg, len,
                    n_state, p_dim))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc::Smem::bytes(len, n_state);
  auto kernel = tc::chunk_scan_kernel_tc;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * nchunks * groups, (p_dim + tc::PT - 1) / tc::PT);
  kernel<<<grid, len * 2, smem, stream>>>(
      (const tc::bf16*)cm, (const tc::bf16*)bm, (const tc::bf16*)x, (const float*)da,
      (const float*)prev, (tc::bf16*)y, cs, bs, xs, ds, ps, ys, heads, nchunks, groups, hg,
      len, n_state, p_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (B, C, X and Y); dA, the states and the
// carried states are float32.  Each tensor is (batch, heads, chunks, rows,
// cols) given by the element strides of its first four dimensions, its last
// dimension contiguous; dA is (batch, heads, chunks, rows) with contiguous
// rows.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes it does not take (a chunk longer than
// 128 rows, an empty dimension, a grid too large).
// tc 1 takes the tensor-core state (bfloat16; L, N and P multiples of 16, L
// and N at most 128; rows and strides of B, X and the states 16-byte
// aligned) with hg heads a block sharing one staged B, which needs B of
// head stride 0 unless hg is 1; tc 0 the CUDA-core kernel (hg unused).
extern "C" int chunk_state_launch(
    int dtype, int tc, int hg, const void* bm, const void* x, const void* da, void* out,
    long long bb, long long bh, long long bc, long long bl, long long xb,
    long long xh, long long xc, long long xl, long long db, long long dh,
    long long dc, long long ob, long long oh, long long oc, long long ol,
    int batch, int heads, int nchunks, int len, int n_state, int p_dim,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides4 bs{bb, bh, bc, bl}, xs{xb, xh, xc, xl}, os{ob, oh, oc, ol};
  const Strides3 ds{db, dh, dc};
  if (tc)
    return dtype == 1 ? launch_state_tc(bm, x, da, out, bs, xs, ds, os, batch, heads, nchunks,
                                        hg, len, n_state, p_dim, s)
                      : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_state<float>(bm, x, da, out, bs, xs, ds, os, batch, heads,
                               nchunks, len, n_state, p_dim, s);
  if (dtype == 1)
    return launch_state<__nv_bfloat16>(bm, x, da, out, bs, xs, ds, os, batch,
                                       heads, nchunks, len, n_state, p_dim, s);
  return (int)cudaErrorInvalidValue;
}

// tc 1 takes the tensor-core scan (bfloat16; L, N and P multiples of 16,
// L and N at most 128; rows and strides of C, B, X and the carried states
// 16-byte aligned) with hg heads a block sharing one C B^T, which needs C
// and B of head stride 0 unless hg is 1; tc 0 the CUDA-core kernel (hg
// unused).
extern "C" int chunk_scan_launch(
    int dtype, int tc, int hg, const void* cm, const void* bm, const void* x, const void* da,
    const void* prev, void* y, long long cb, long long ch, long long cc,
    long long cl, long long bb, long long bh, long long bc, long long bl,
    long long xb, long long xh, long long xc, long long xl, long long db,
    long long dh, long long dc, long long pb, long long ph, long long pc,
    long long pl, long long yb, long long yh, long long yc, long long yl,
    int batch, int heads, int nchunks, int len, int n_state, int p_dim,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides4 cs{cb, ch, cc, cl}, bs{bb, bh, bc, bl}, xs{xb, xh, xc, xl},
      ps{pb, ph, pc, pl}, ys{yb, yh, yc, yl};
  const Strides3 ds{db, dh, dc};
  if (tc)
    return dtype == 1 ? launch_scan_tc(cm, bm, x, da, prev, y, cs, bs, xs, ds, ps, ys, batch,
                                       heads, nchunks, hg, len, n_state, p_dim, s)
                      : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_scan<float>(cm, bm, x, da, prev, y, cs, bs, xs, ds, ps, ys,
                              batch, heads, nchunks, len, n_state, p_dim, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(cm, bm, x, da, prev, y, cs, bs, xs, ds,
                                      ps, ys, batch, heads, nchunks, len,
                                      n_state, p_dim, s);
  return (int)cudaErrorInvalidValue;
}
