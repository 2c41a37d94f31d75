// Split-KV decode: the partial softmax states a split block leaves behind,
// and the pass that merges them.  Shared by the GQA decode
// (paged_attention.cu) and the MLA decode (mla_paged.cu).
//
// A split block scores its slot's keys [s * split_keys, (s + 1) *
// split_keys) that are live and leaves, for each of its query rows, the
// unnormalised output O (fp32), the running max m (log2 domain, clamped at
// NEG_CLAMP) and the row sum l.  A split with no live key reads nothing and
// leaves m = NEG_CLAMP, l = 0, which the merge weighs 0 (its O is not read).
// The merge rescales the splits to their common max, sums them, applies
// safe_div and rounds once to the output type: the arithmetic of an online
// softmax's rescale, across blocks.

#pragma once

#include "attention_core.cuh"

namespace sk {

constexpr int MERGE_THREADS = 128;

// Where split blocks leave their partial states (fp32 scratch the wrapper
// allocates): O (slots, heads, splits, d) unnormalised, m and l (slots,
// heads, splits).
struct Partials {
  float *o, *m, *l;
  int heads, splits;
  __device__ long row(int b, int qh, int s) const { return ((long)b * heads + qh) * splits + s; }
  // A split with no live key: weighed 0 by the merge, O left unwritten.
  __device__ void empty(int b, int qh0, int rows, int s) const {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      m[row(b, qh0 + r, s)] = ac::NEG_CLAMP;
      l[row(b, qh0 + r, s)] = 0.f;
    }
  }
  // The CUDA-core body's state (attention_core.cuh's Smem: `rows` rows of
  // the accumulator, d wide) as query heads qh0.. of slot b, split s.
  __device__ void store(const ac::Smem& sm, int b, int qh0, int rows, int s, int d) const {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      o[row(b, qh0 + r, s) * d + c] = sm.acc[i];
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      m[row(b, qh0 + r, s)] = fmaxf(sm.m[r], ac::NEG_CLAMP);
      l[row(b, qh0 + r, s)] = sm.l[r];
    }
  }
};

// Block (slot, query head): out = sum_s w_s O_s / max(sum_s w_s l_s, 1e-30)
// with w_s = exp2(m_s - max_s m_s), every m clamped at NEG_CLAMP (so a slot
// whose splits all saw nothing emits 0), rounded once to T.  A split with
// l == 0 saw no key: its weight is 0 and its O (never written) is not
// used.  The weights land in shared memory once a block; a thread then
// sums four neighbouring columns over the splits with one 16-byte load a
// split, the loads of several splits in flight together: a chain that
// reads each split's weight from device memory in every step costs ~4x as
// much at the MLA decode's R 512 (H100 80GB HBM3 at 700 W).
template <typename T>
__global__ void merge_kernel(Partials part, int d, T* __restrict__ out) {
  extern __shared__ float sw[];  // the splits' m, then their weights; their l
  const int n = part.splits;
  const long r0 = (long)blockIdx.x * n;  // the row's first split
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    sw[s] = part.m[r0 + s];
    sw[n + s] = part.l[r0 + s];
  }
  __syncthreads();
  float mx = ac::NEG_CLAMP;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, sw[s]);
  __syncthreads();  // every thread has its max before m becomes the weights
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    sw[s] = sw[n + s] != 0.f ? exp2f(sw[s] - mx) : 0.f;
  __syncthreads();
  float den = 0.f;
  for (int s = 0; s < n; ++s) den += sw[s] * sw[n + s];
  den = fmaxf(den, 1e-30f);
  const float4* o = reinterpret_cast<const float4*>(part.o) + r0 * (d / 4);
  for (int c = threadIdx.x; c < d / 4; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float4 x = o[(long)s * (d / 4) + c];
      const float w = sw[s];
      if (w != 0.f) {
        acc.x += w * x.x;
        acc.y += w * x.y;
        acc.z += w * x.z;
        acc.w += w * x.w;
      }
    }
    T* dst = out + (long)blockIdx.x * d + 4 * c;
    dst[0] = ac::from_float<T>(acc.x / den);
    dst[1] = ac::from_float<T>(acc.y / den);
    dst[2] = ac::from_float<T>(acc.z / den);
    dst[3] = ac::from_float<T>(acc.w / den);
  }
}

// The merge of `slots` x part.heads rows of width d (a multiple of 4) into
// out.
template <typename T>
int merge(const Partials& part, int slots, int d, void* out, cudaStream_t stream) {
  if (d % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * part.splits;
  merge_kernel<T><<<slots * part.heads, min(d / 4, MERGE_THREADS), smem, stream>>>(part, d,
                                                                                  (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace sk
