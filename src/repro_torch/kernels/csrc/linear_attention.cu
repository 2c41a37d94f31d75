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
// bytes handed over, the expanded B and C once).  This first version does
// its products on CUDA cores in fp32 (67 TFLOP/s at the card's peak, not
// the tensor cores' 989), so its arithmetic, not its bytes, sets its time.
//
// Design (256 threads a block, as 16 x 16; each thread owns rows ty + 16 i
// and columns tx + 16 j of an output tile, so a warp's shared-memory reads
// are one broadcast and one run of 16 consecutive words):
//   * chunk_state: one block per (batch, head, chunk) and tile of 128 state
//     rows by 64 columns of P.  B (scaled by its row's decay) and X are
//     staged in shared memory as fp32 ([L][128] and [L][64], 97 KB at L
//     128); the (N, P) tile accumulates in registers (8 x 4 a thread) over
//     the chunk's rows.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxL = 128;     // rows of a chunk
constexpr int kTileN = 128;    // chunk_state: state rows a block
constexpr int kTileP = 64;     // columns of P a block, both kernels
constexpr int kStepN = 32;     // chunk_scan: columns of N a step
constexpr int kRm = kMaxL / 16;   // output rows a thread (8)
constexpr int kRn = kTileN / 16;  // chunk_state: state rows a thread (8)
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chunk_state_kernel(const T* __restrict__ bm, const T* __restrict__ x,
                   const float* __restrict__ da, float* __restrict__ out,
                   Strides4 bs, Strides4 xs, Strides3 ds, Strides4 os,
                   int heads, int nchunks, int len, int n_state, int p_dim) {
  const int c = blockIdx.x % nchunks;
  const int bh = blockIdx.x / nchunks;
  const int h = bh % heads, b = bh / heads;
  const int n0 = blockIdx.y * kTileN, p0 = blockIdx.z * kTileP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  extern __shared__ float smem[];
  float* bsm = smem;                    // [kMaxL][kTileN]: w_l * B[l, n0 + n]
  float* xsm = bsm + kMaxL * kTileN;    // [kMaxL][kTileP]: X[l, p0 + p]
  float* w = xsm + kMaxL * kTileP;      // [kMaxL]: exp(dA[L-1] - dA[l])

  const float* dap = da + b * ds.b + h * ds.h + c * ds.c;
  for (int l = threadIdx.x; l < kMaxL; l += kThreads)
    w[l] = l < len ? expf(dap[len - 1] - dap[l]) : 0.f;
  stage<kTileP>(xsm, kTileP, x + b * xs.b + h * xs.h + c * xs.c + p0, xs.l,
                len, p_dim - p0);
  __syncthreads();
  const T* bp = bm + b * bs.b + h * bs.h + c * bs.c + n0;
  const int n_live = n_state - n0;
  for (int i = threadIdx.x; i < kMaxL * kTileN; i += kThreads) {
    const int r = i / kTileN, col = i % kTileN;
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
    for (int i = 0; i < kRn; ++i) a[i] = bsm[l * kTileN + ty + 16 * i];
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
  const size_t smem = (kMaxL * kTileN + kMaxL * kTileP + kMaxL) * sizeof(float);
  auto kernel = chunk_state_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * heads * nchunks, (n_state + kTileN - 1) / kTileN,
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (B, C, X and Y); dA, the states and the
// carried states are float32.  Each tensor is (batch, heads, chunks, rows,
// cols) given by the element strides of its first four dimensions, its last
// dimension contiguous; dA is (batch, heads, chunks, rows) with contiguous
// rows.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes it does not take (a chunk longer than
// 128 rows, an empty dimension, a grid too large).
extern "C" int chunk_state_launch(
    int dtype, const void* bm, const void* x, const void* da, void* out,
    long long bb, long long bh, long long bc, long long bl, long long xb,
    long long xh, long long xc, long long xl, long long db, long long dh,
    long long dc, long long ob, long long oh, long long oc, long long ol,
    int batch, int heads, int nchunks, int len, int n_state, int p_dim,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides4 bs{bb, bh, bc, bl}, xs{xb, xh, xc, xl}, os{ob, oh, oc, ol};
  const Strides3 ds{db, dh, dc};
  if (dtype == 0)
    return launch_state<float>(bm, x, da, out, bs, xs, ds, os, batch, heads,
                               nchunks, len, n_state, p_dim, s);
  if (dtype == 1)
    return launch_state<__nv_bfloat16>(bm, x, da, out, bs, xs, ds, os, batch,
                                       heads, nchunks, len, n_state, p_dim, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int chunk_scan_launch(
    int dtype, const void* cm, const void* bm, const void* x, const void* da,
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
  if (dtype == 0)
    return launch_scan<float>(cm, bm, x, da, prev, y, cs, bs, xs, ds, ps, ys,
                              batch, heads, nchunks, len, n_state, p_dim, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(cm, bm, x, da, prev, y, cs, bs, xs, ds,
                                      ps, ys, batch, heads, nchunks, len,
                                      n_state, p_dim, s);
  return (int)cudaErrorInvalidValue;
}
