// Shared pieces of the two paged attention kernels (paged_decode.cu,
// paged_prefill.cu): element conversions, warp reductions, the shared-
// memory layout of one thread block, and the step that folds one tile of
// up to 32 keys into a block's fp32 online-softmax state.
//
// A thread block owns ROWS query rows (the GQA heads that share one kv
// head, times some query positions) and walks its keys tile by tile:
//   1. the tile's K and V rows are loaded to shared memory as fp32 (each
//      key row's element offset is resolved by the caller, through the
//      block table for pool keys);
//   2. scores s = q . k for every (row, key) of the tile, -1e30 where the
//      caller's mask says the key is not visible;
//   3. one warp per row updates the running max m and denominator l and
//      turns the scores into exp(s - m);
//   4. every thread rescales its share of the (ROWS, D) accumulator and
//      adds p @ V.
// This loop replaces the sequential innermost grid axis and VMEM scratch
// of the TPU kernels: here nothing carries from one thread block to
// another.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;
constexpr int kTileKeys = 32;  // keys per tile: one per lane of a warp

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch does
}

// Two neighbouring elements as fp32 (one 4-byte load for bf16, one 8-byte
// load for fp32; rows are at least that aligned since D is even).
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory of one block, in floats.  K and V rows use an odd
// stride (D + 1): the 32 lanes of a warp read column d of 32 different key
// rows, and an odd stride puts those reads in 32 different banks.
template <int D, int ROWS>
struct TileSmem {
  static constexpr int kStride = D + 1;
  static constexpr size_t kFloats =
      size_t(ROWS) * D + 2 * size_t(kTileKeys) * kStride +
      size_t(ROWS) * kTileKeys + 3 * size_t(ROWS);
  float* q;     // [ROWS][D]  queries, pre-scaled by 1/sqrt(D)
  float* k;     // [kTileKeys][kStride]
  float* v;     // [kTileKeys][kStride]
  float* p;     // [ROWS][kTileKeys]  scores, then exp(s - m)
  float* m;     // [ROWS]  running max
  float* l;     // [ROWS]  running denominator
  float* corr;  // [ROWS]  exp(m_old - m_new) of the current tile
  __device__ explicit TileSmem(float* base)
      : q(base),
        k(q + ROWS * D),
        v(k + kTileKeys * kStride),
        p(v + kTileKeys * kStride),
        m(p + ROWS * kTileKeys),
        l(m + ROWS),
        corr(l + ROWS) {}
};

// Fold one tile of `nk` keys into the block's softmax state.  `row_off[t]`
// is the element offset of key t's D-vector in kbase/vbase.  `visible(r,
// t)` masks (row, key) pairs.  `acc` holds this thread's elements e = tid
// + i * NT of the row-major (ROWS, D) accumulator.  Starts by reading
// row_off (written by the caller before a __syncthreads) and ends with a
// __syncthreads, so the caller may overwrite row_off right after.
template <int D, int ROWS, int NT, typename KT, typename Visible>
__device__ __forceinline__ void attend_tile(const TileSmem<D, ROWS>& sm,
                                            const KT* __restrict__ kbase,
                                            const KT* __restrict__ vbase,
                                            const long long* row_off, int nk,
                                            int rows, Visible visible,
                                            float (&acc)[ROWS * D / NT]) {
  constexpr int kStride = TileSmem<D, ROWS>::kStride;
  constexpr int kPairs = D / 2;
  const int tid = threadIdx.x;

  // 1. K/V rows of the tile -> shared memory (fp32).
  for (int e = tid; e < nk * kPairs; e += NT) {
    const int t = e / kPairs, c = 2 * (e % kPairs);
    const long long off = row_off[t] + c;
    const float2 kk = load_pair(kbase + off);
    const float2 vv = load_pair(vbase + off);
    sm.k[t * kStride + c] = kk.x;
    sm.k[t * kStride + c + 1] = kk.y;
    sm.v[t * kStride + c] = vv.x;
    sm.v[t * kStride + c + 1] = vv.y;
  }
  __syncthreads();

  // 2. Scores.
  for (int e = tid; e < rows * kTileKeys; e += NT) {
    const int r = e / kTileKeys, t = e % kTileKeys;
    float s = kNegInf;
    if (t < nk && visible(r, t)) {
      const float* qr = sm.q + r * D;
      const float* kr = sm.k + t * kStride;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
      s = a;
    }
    sm.p[r * kTileKeys + t] = s;
  }
  __syncthreads();

  // 3. Online softmax: one warp per row, one lane per key.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    const float s = sm.p[r * kTileKeys + lane];
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, warp_max(s));
    const float pr = expf(s - m_new);
    const float sum = warp_sum(pr);
    sm.p[r * kTileKeys + lane] = pr;
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      sm.corr[r] = c;
      sm.l[r] = sm.l[r] * c + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();

  // 4. acc = acc * corr + p @ V.
#pragma unroll
  for (int i = 0; i < ROWS * D / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / D, d = e % D;
    if (r < rows) {
      const float* pr = sm.p + r * kTileKeys;
      float a = acc[i] * sm.corr[r];
      for (int t = 0; t < nk; ++t) a = fmaf(pr[t], sm.v[t * kStride + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
}

// Set the dynamic shared-memory ceiling of `kernel` once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace repro_torch

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
