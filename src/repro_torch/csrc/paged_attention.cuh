// Shared pieces of the attention kernels: element conversions, the SCLAD
// payload codecs and the 8-element row quantize / dequantize of the
// tensor-core bodies, warp reductions and the pool codes (also used by the
// decode kernels' body, decode_attention.cuh, for paged_decode.cu and
// dense_decode.cu, and by paged_prefill.cu's tensor-core body and
// scatter), and, for the exact-fp32 bodies of paged_prefill.cu and
// flash_attention.cu, the shared-memory layout of one thread block, the
// tile loaders, and the step that folds one tile of up to 32 keys into a
// block's fp32 online-softmax state.
//
// A thread block owns ROWS query rows (the GQA heads that share one kv
// head, times some query positions) and walks its keys tile by tile:
//   1. a loader puts the tile's K and V rows in shared memory as fp32 (each
//      key row's element offset is resolved by the caller, through the
//      block table for pool keys): exact values of a bf16/fp32 source, a
//      SCLAD payload dequantized as models/kv_quant.py does, or a chunk's
//      own rows fake-quantized;
//   2. scores s = q . k for every (row, key) of the tile, -1e30 where the
//      caller's mask says the key is not visible;
//   3. one warp per row updates the running max m and denominator l and
//      turns the scores into exp(s - m);
//   4. every thread rescales its share of the (ROWS, D) accumulator and
//      adds p @ V.
// This loop replaces the sequential innermost grid axis and VMEM scratch
// of the TPU kernels: here nothing carries from one thread block to
// another.
//
// The SCLAD arithmetic must match models/kv_quant.py bit for bit, so the
// build keeps IEEE division (no --use_fast_math), int8 rounds with rintf
// (half to even, as torch.round) and fp8 converts with round to nearest
// even, saturating (|x / scale| never reaches 464, where torch's cast
// would give NaN, so the two agree).
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace repro_torch {

constexpr float kNegInf = -1e30f;
constexpr int kTileKeys = 32;  // keys per tile: one per lane of a warp

using fp8_e4m3 = __nv_fp8_e4m3;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(fp8_e4m3 x) {
  return static_cast<float>(x);  // exact: every e4m3 value is a half
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch does
}

// `x` rounded to the compute type T and widened back: the cast chain of
// kv_quant.dequantize(..., dtype=T).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// SCLAD payload codecs (kv_quant.quantize): the payload type, its qmax,
// and the encoding of an already scaled value.
template <typename P>
struct Codec;
template <>
struct Codec<int8_t> {
  static constexpr double kQmax = 127.0;
  __device__ static int8_t encode(float q) {
    return static_cast<int8_t>(rintf(q));  // |q| <= 127.00002: no clip
  }
};
template <>
struct Codec<fp8_e4m3> {
  static constexpr double kQmax = 448.0;
  __device__ static fp8_e4m3 encode(float q) {
    fp8_e4m3 r;
    r.__x = __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
    return r;
  }
};

template <typename P>
constexpr bool kQuantized =
    std::is_same<P, int8_t>::value || std::is_same<P, fp8_e4m3>::value;

// amax * float32(1 / qmax), or 1 for an all-zero row: kv_quant.quantize's
// scale, bit for bit (a multiply by the rounded constant, not a division).
template <typename P>
__device__ __forceinline__ float row_scale(float amax) {
  constexpr float kInv = static_cast<float>(1.0 / Codec<P>::kQmax);
  return amax > 0.f ? amax * kInv : 1.f;
}

// Two neighbouring elements as fp32 (one 4-byte load for bf16, one 8-byte
// load for fp32; rows are at least that aligned since D is even).
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// One payload byte as fp32 (exact).
template <typename P>
__device__ __forceinline__ float byte_to_float(uint32_t byte);
template <>
__device__ __forceinline__ float byte_to_float<int8_t>(uint32_t byte) {
  return static_cast<float>(static_cast<int8_t>(byte & 0xffu));
}
template <>
__device__ __forceinline__ float byte_to_float<fp8_e4m3>(uint32_t byte) {
  fp8_e4m3 x;
  x.__x = static_cast<__nv_fp8_storage_t>(byte & 0xffu);
  return to_float(x);
}
// Four neighbouring one-byte payload elements as fp32 (one 4-byte load;
// D is a multiple of 4, so rows are 4-byte aligned).
template <typename P>
__device__ __forceinline__ float4 load_quad(const P* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float4(byte_to_float<P>(w), byte_to_float<P>(w >> 8),
                     byte_to_float<P>(w >> 16), byte_to_float<P>(w >> 24));
}

// kv_quant.quantize's scale of a row held by kLanes neighbouring lanes,
// 8 elements each: the row's amax over D by shuffles among those lanes,
// then row_scale.  Every lane of the warp calls it (kLanes divides 32).
template <typename P, int kLanes>
__device__ __forceinline__ float lanes_row_scale(const float (&x)[8]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return row_scale<P>(amax);
}

// Eight elements of a row encoded with its scale (kv_quant.quantize:
// IEEE division, then the codec): eight payload bytes, the first in the
// lowest byte.
template <typename P>
__device__ __forceinline__ uint2 encode8(const float (&x)[8], float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const P y = Codec<P>::encode(x[j] / scale);
    w[j / 4] |= uint32_t(*reinterpret_cast<const uint8_t*>(&y))
                << (8 * (j % 4));
  }
  return make_uint2(w[0], w[1]);
}

// Eight payload bytes dequantized: payload * scale in fp32, each rounded
// to bf16 (kv_quant.dequantize(..., bfloat16)), packed as eight bf16.
template <typename P>
__device__ __forceinline__ uint4 dequant8(uint2 w, float s) {
  uint4 y;
  y.x = mma::pack_bf16x2(byte_to_float<P>(w.x) * s,
                         byte_to_float<P>(w.x >> 8) * s);
  y.y = mma::pack_bf16x2(byte_to_float<P>(w.x >> 16) * s,
                         byte_to_float<P>(w.x >> 24) * s);
  y.z = mma::pack_bf16x2(byte_to_float<P>(w.y) * s,
                         byte_to_float<P>(w.y >> 8) * s);
  y.w = mma::pack_bf16x2(byte_to_float<P>(w.y >> 16) * s,
                         byte_to_float<P>(w.y >> 24) * s);
  return y;
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

// ---- Tile loaders: K/V rows t < nk of a tile into sm.k / sm.v (fp32).
// `row_off[t]` is the element offset of key t's D-vector in the source.

// bf16 or fp32 rows, exact.
template <int D, int ROWS, int NT, typename KT>
__device__ __forceinline__ void load_tile(const TileSmem<D, ROWS>& sm,
                                          const KT* __restrict__ kbase,
                                          const KT* __restrict__ vbase,
                                          const long long* row_off, int nk) {
  constexpr int kStride = TileSmem<D, ROWS>::kStride;
  constexpr int kPairs = D / 2;
  for (int e = threadIdx.x; e < nk * kPairs; e += NT) {
    const int t = e / kPairs, c = 2 * (e % kPairs);
    const long long off = row_off[t] + c;
    const float2 kk = load_pair(kbase + off);
    const float2 vv = load_pair(vbase + off);
    sm.k[t * kStride + c] = kk.x;
    sm.k[t * kStride + c + 1] = kk.y;
    sm.v[t * kStride + c] = vv.x;
    sm.v[t * kStride + c + 1] = vv.y;
  }
}

// SCLAD pool rows: payload * scale in fp32, rounded to the compute type CT
// (kv_quant.dequantize(payload, scale, CT)).  The (N, bs, Hk) scales share
// the pool's row index, so row t's scale sits at row_off[t] / D.
template <int D, int ROWS, int NT, typename CT, typename P>
__device__ __forceinline__ void load_tile_dequant(
    const TileSmem<D, ROWS>& sm, const P* __restrict__ kbase,
    const P* __restrict__ vbase, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const long long* row_off, int nk) {
  constexpr int kStride = TileSmem<D, ROWS>::kStride;
  constexpr int kQuads = D / 4;
  for (int e = threadIdx.x; e < nk * kQuads; e += NT) {
    const int t = e / kQuads, c = 4 * (e % kQuads);
    const long long row = row_off[t];
    const float ks = kscale[row / D], vs = vscale[row / D];
    const float4 kk = load_quad(kbase + row + c);
    const float4 vv = load_quad(vbase + row + c);
    float* kd = sm.k + t * kStride + c;
    float* vd = sm.v + t * kStride + c;
    kd[0] = round_to<CT>(kk.x * ks);
    kd[1] = round_to<CT>(kk.y * ks);
    kd[2] = round_to<CT>(kk.z * ks);
    kd[3] = round_to<CT>(kk.w * ks);
    vd[0] = round_to<CT>(vv.x * vs);
    vd[1] = round_to<CT>(vv.y * vs);
    vd[2] = round_to<CT>(vv.z * vs);
    vd[3] = round_to<CT>(vv.w * vs);
  }
}

// Fake-quantize rows t < nk of the tile in place (kv_quant.fake_quant in
// the compute type CT): one warp per row, amax over D by a warp reduction.
// The caller has loaded the tile and synchronized.
template <int D, int ROWS, int NT, typename CT, typename P>
__device__ __forceinline__ void fake_quant_tile(const TileSmem<D, ROWS>& sm,
                                                int nk) {
  constexpr int kStride = TileSmem<D, ROWS>::kStride;
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < 2 * nk; t += NT / 32) {
    float* row = (t < nk ? sm.k + t * kStride : sm.v + (t - nk) * kStride);
    float x[kPer];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      x[i] = row[lane + 32 * i];
      amax = fmaxf(amax, fabsf(x[i]));
    }
    const float scale = row_scale<P>(warp_max(amax));
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      row[lane + 32 * i] =
          round_to<CT>(to_float(Codec<P>::encode(x[i] / scale)) * scale);
  }
}

// Fold one tile of `nk` keys into the block's softmax state.  `load()`
// fills sm.k / sm.v for keys t < nk (it may synchronize inside, and reads
// whatever offsets the caller wrote before its __syncthreads).
// `visible(r, t)` masks (row, key) pairs.  `acc` holds this thread's
// elements e = tid + i * NT of the row-major (ROWS, D) accumulator.  Ends
// with a __syncthreads, so the caller may overwrite its offsets right
// after.
template <int D, int ROWS, int NT, typename Load, typename Visible>
__device__ __forceinline__ void attend_tile(const TileSmem<D, ROWS>& sm,
                                            Load load, int nk, int rows,
                                            Visible visible,
                                            float (&acc)[ROWS * D / NT]) {
  constexpr int kStride = TileSmem<D, ROWS>::kStride;
  const int tid = threadIdx.x;

  // 1. K/V rows of the tile -> shared memory (fp32).
  load();
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

// Pool payload codes of the C entry points.
enum KvKind : int { kKvBf16 = 0, kKvInt8 = 1, kKvFp8 = 2 };

}  // namespace repro_torch

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
