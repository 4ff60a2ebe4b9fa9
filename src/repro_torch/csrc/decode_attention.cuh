// One decode-attention body for Hopper (sm_90a), shared by the paged
// flash-decode kernel (paged_decode.cu: keys reached through a block
// table, bf16 or SCLAD int8/fp8 pool) and the dense flash-decode kernel
// (dense_decode.cu: keys in per-row bf16 stripes).
//
// Replaces the bodies of the TPU kernels `_paged_decode_kernel` and
// `_decode_kernel` of src/repro/kernels/flash_decode/flash_decode.py: one
// new query token per row attends over its cached positions [0, n), n =
// min(lengths[b], width), width = T * bs (paged) or S (dense), with an
// fp32 online softmax.  The templates take a row-address policy
// (PagedRows / DenseRows: position -> pool row), the payload type (bf16,
// int8 or fp8 e4m3 with fp32 scales) and D (64 or 128); q's type picks
// the body.
//
// Bound on this card.  The work reads each live K/V row once (2 * n * Hk
// rows of D payload elements, plus a 4-byte scale on a SCLAD pool) and
// does 4 * H * D operations per position: ~2-8 operations a byte, far
// below the card's ~295, so device-memory bandwidth bounds it.
//
// Design.  Two kernels per call, launched by one C entry point:
//  1. the split pass, grid (n_split, Hk, B): block (s, h, b) walks
//     positions [s * kSplit, (s + 1) * kSplit) of row b for kv head h and
//     its rep = H / Hk query heads (GQA: each K/V byte is read once per
//     step).  n_split = ceil(width / kSplit) comes from shapes only, so
//     the host never reads `lengths`; a block whose range starts at or
//     past n exits at once.  Since the split length is fixed, a row's
//     result depends only on its own keys and length, not on B, the other
//     rows or the table width.  Inside a block each of the 4 warps owns 32
//     positions: it resolves their pool rows (one per lane, through the
//     table), puts their K/V rows in shared memory with 16-byte cp.async
//     in two commit groups of 16 keys (both in flight at once), keeps its
//     own m, l and accumulator in registers, with no block barrier in the
//     key walk.  The warps merge through shared memory once per 16 query
//     rows (log-sum-exp rescale, warp order), and the block writes its
//     (m, l, acc[rep, D]) partial to an fp32 workspace the wrapper
//     allocates;
//  2. the combine pass: one warp per (row, query head) merges the row's
//     live splits in split order (log-sum-exp rescale) and divides by l.
//     No float atomics, so the output is bitwise equal launch to launch; a
//     row with n <= 0 gets zeros (the TPU kernel's `upper = 0`).
// bf16 q (decode_tc_kernel) runs on the tensor cores, as the TPU body's
// `q @ k.T` and `p.astype(v.dtype) @ v` on the MXU: the rep query heads
// are the A rows of mma.sync m16n8k16 (padded to 16 with zero rows, one
// m tile per 16 heads), K through ldmatrix, S in fp32, scaled by
// log2(e) / sqrt(D) in fp32 inside exp2 (as flash_attention.cu), P
// rounded to bf16 in registers as the A operand of P @ V (V through
// ldmatrix.trans), l summing the fp32 p.  A SCLAD payload is dequantized
// in shared memory first, payload * scale in fp32 rounded to bf16: the
// cast chain of kv_quant.dequantize(..., q.dtype) and of
// paged_attention.cuh's load_tile_dequant.  fp32 q (decode_exact_kernel)
// keeps exact fp32 arithmetic on the CUDA cores (one lane per key for the
// scores, one lane per column for P @ V) through the same staging, split
// and combine.
//
// Predicted time at chip_smoke.py's shapes (8 rows, tinyllama's 32 / 4
// heads of 64, lengths up to 1024: ~26 live splits x 4 kv heads, ~100
// busy blocks): 0.008-0.020 ms a call on a bf16 pool or stripes,
// 0.010-0.025 ms on an int8/fp8 pool, the two launches' fixed cost
// included; the bytes bound (~0.0006 ms) is out of reach at this size.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace decode {

using bf16 = __nv_bfloat16;

constexpr int kSplit = 128;                 // positions per split block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kSplit / kWarps;  // 32: one per lane
constexpr int kStageKeys = 16;              // keys per cp.async group
constexpr int kRowTile = 16;                // query rows per m tile
constexpr int kMaxRep = 32;                 // query heads per kv head

// Row-address policies: n(b) is row b's live positions, row(b, h, pos) the
// (N * bs * Hk or B * S * Hk) row index of position pos of kv head h; its
// D-vector starts at element row * D, a SCLAD scale sits at index row.
struct PagedRows {
  const int* lengths;
  const int* tables;  // (B, T)
  int T, bs, Hk;
  __device__ int n(int b) const { return min(lengths[b], T * bs); }
  __device__ long long row(int b, int h, int pos) const {
    const long long blk = tables[static_cast<long long>(b) * T + pos / bs];
    return (blk * bs + pos % bs) * Hk + h;
  }
};
struct DenseRows {
  const int* lengths;
  int S, Hk;
  __device__ int n(int b) const { return min(lengths[b], S); }
  __device__ long long row(int b, int h, int pos) const {
    return (static_cast<long long>(b) * S + pos) * Hk + h;
  }
};

// Dynamic shared memory of a split block, in bytes.  Rows of bf16 tiles
// are padded by 16 bytes so ldmatrix reads them without bank conflicts.
template <typename T, int D, typename P>
struct Layout {
  static constexpr bool kTc = std::is_same<T, bf16>::value;
  static constexpr bool kQuant = kQuantized<P>;
  static constexpr int kStride = D + 8;  // bf16 elements of a padded row
  // A staged pool row: a padded bf16 row, or D payload bytes + 16.
  static constexpr int kRowBytes = kQuant ? D + 16 : kStride * 2;
  static constexpr int kStage = kWarpKeys * kRowBytes;        // K or V
  // bf16 q on a SCLAD pool: the dequantized bf16 K and V of the warp.
  static constexpr int kConv = kTc && kQuant ? kWarpKeys * kStride * 2 : 0;
  static constexpr int kScales = kQuant ? kWarpKeys * 4 : 0;
  static constexpr int kQ = kTc ? kMaxRep * kStride * 2 : kMaxRep * D * 4;
  static constexpr int kPerWarp = 2 * (kStage + kConv + kScales);
  static constexpr int kMergeO = kWarps * kRowTile * D * 4;
  static constexpr int kMergeML = 2 * kWarps * kRowTile * 4;
  static constexpr size_t kBytes =
      size_t(kQ) + size_t(kWarps) * kPerWarp + kMergeO + kMergeML;
};

// This warp's pieces of the split block's shared memory.
template <typename T, int D, typename P>
struct WarpSmem {
  using L = Layout<T, D, P>;
  unsigned char* q;          // [kMaxRep][kStride] bf16, or [kMaxRep][D] fp32
  unsigned char* stage[2];   // K, V: [kWarpKeys][kRowBytes]
  bf16* conv[2];             // K, V: [kWarpKeys][kStride] (bf16 q, SCLAD)
  float* scale[2];           // K, V: [kWarpKeys]          (SCLAD)
  float* mo;                 // [kWarps][kRowTile][D] merge: accumulators
  float* mm;                 // [kWarps][kRowTile]    merge: m (log2 units)
  float* ml;                 // [kWarps][kRowTile]    merge: l
  __device__ WarpSmem(unsigned char* base, int warp) {
    q = base;
    unsigned char* w = base + L::kQ + warp * L::kPerWarp;
    stage[0] = w;
    stage[1] = w + L::kStage;
    conv[0] = reinterpret_cast<bf16*>(w + 2 * L::kStage);
    conv[1] = reinterpret_cast<bf16*>(w + 2 * L::kStage + L::kConv);
    scale[0] = reinterpret_cast<float*>(w + 2 * (L::kStage + L::kConv));
    scale[1] = scale[0] + L::kScales / 4;
    mo = reinterpret_cast<float*>(base + L::kQ + kWarps * L::kPerWarp);
    mm = mo + kWarps * kRowTile * D;
    ml = mm + kWarps * kRowTile;
  }
};

// Put this warp's keys p0 .. p0 + 31 (those below n; the rest zero-filled)
// in shared memory: two cp.async commit groups of 16 keys, both left in
// flight; a SCLAD pool's scales by plain loads (0 for keys past n).
template <typename T, int D, typename P, typename Rows>
__device__ __forceinline__ void stage_keys(const WarpSmem<T, D, P>& sm,
                                           const Rows& rows, int b, int h,
                                           int p0, int n, const P* k,
                                           const P* v, const float* ks,
                                           const float* vs, int lane) {
  using L = Layout<T, D, P>;
  constexpr int kPieces = D * int(sizeof(P)) / 16;  // 16-byte pieces a row
  constexpr int kElems = 16 / int(sizeof(P));
  const bool live = p0 + lane < n;
  const long long row = live ? rows.row(b, h, p0 + lane) : 0;
  if constexpr (L::kQuant) {
    sm.scale[0][lane] = live ? ks[row] : 0.f;
    sm.scale[1][lane] = live ? vs[row] : 0.f;
  }
#pragma unroll
  for (int st = 0; st < kWarpKeys / kStageKeys; ++st) {
#pragma unroll
    for (int i = 0; i < kStageKeys * kPieces / 32; ++i) {
      const int e = lane + 32 * i;
      const int t = st * kStageKeys + e / kPieces, c = e % kPieces;
      const long long r = __shfl_sync(0xffffffffu, row, t);
      const bool in = p0 + t < n;
      const long long off = r * D + c * kElems;
      mma::cp_async16(sm.stage[0] + t * L::kRowBytes + c * 16,
                      in ? k + off : k, in);
      mma::cp_async16(sm.stage[1] + t * L::kRowBytes + c * 16,
                      in ? v + off : v, in);
    }
    mma::cp_async_commit();
  }
}

// q rows h * rep .. h * rep + rep - 1 of row b into shared memory, in q's
// type, zero rows up to the last m tile.
template <typename T, int D, typename P>
__device__ __forceinline__ void stage_q(const WarpSmem<T, D, P>& sm,
                                        const T* q, long long q_base,
                                        int rep) {
  constexpr int kStride = Layout<T, D, P>::kStride;
  const int rows = (rep + kRowTile - 1) / kRowTile * kRowTile;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const T x = r < rep ? q[q_base + e] : from_float<T>(0.f);
    if constexpr (Layout<T, D, P>::kTc)
      reinterpret_cast<T*>(sm.q)[r * kStride + d] = x;
    else
      reinterpret_cast<T*>(sm.q)[r * D + d] = x;
  }
}

// Merge the 4 warps' partials of query rows mt * 16 .. (in sm.mo/mm/ml)
// into the block's (acc, m, l) partial in the workspace: accumulators at
// ws[(grow * n_split + split) * D + d], (m, l) at ws_ml[... * 2].  The
// caller has synchronized the block.
template <typename T, int D, typename P>
__device__ __forceinline__ void merge_warps(const WarpSmem<T, D, P>& sm,
                                            float* __restrict__ ws,
                                            float* __restrict__ ws_ml,
                                            long long grow0, int rows,
                                            int split, int n_split) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm.mm[w * kRowTile + r]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm.mm[w * kRowTile + r];
      const float c = mw == -INFINITY ? 0.f : exp2f(mw - m);
      o = fmaf(c, sm.mo[(w * kRowTile + r) * D + d], o);
      l = fmaf(c, sm.ml[w * kRowTile + r], l);
    }
    const long long slot = (grow0 + r) * n_split + split;
    ws[slot * D + d] = o;
    if (d == 0) {
      ws_ml[2 * slot] = m;
      ws_ml[2 * slot + 1] = l;
    }
  }
}

// 2^x on the special-function unit (ex2.approx.ftz: 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// SCLAD keys t of stage st, payload * scale in fp32 rounded to bf16, into
// the warp's bf16 tiles (8 elements a lane a step).
template <int D, typename P>
__device__ __forceinline__ void dequant_stage(
    const WarpSmem<bf16, D, P>& sm, int st, int lane) {
  using L = Layout<bf16, D, P>;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kStageKeys * kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int t = st * kStageKeys + e / kChunks, c = e % kChunks;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const uint2 w = *reinterpret_cast<const uint2*>(
          sm.stage[kv] + t * L::kRowBytes + c * 8);
      const float s = sm.scale[kv][t];
      uint4 o;
      o.x = mma::pack_bf16x2(byte_to_float<P>(w.x) * s,
                             byte_to_float<P>(w.x >> 8) * s);
      o.y = mma::pack_bf16x2(byte_to_float<P>(w.x >> 16) * s,
                             byte_to_float<P>(w.x >> 24) * s);
      o.z = mma::pack_bf16x2(byte_to_float<P>(w.y) * s,
                             byte_to_float<P>(w.y >> 8) * s);
      o.w = mma::pack_bf16x2(byte_to_float<P>(w.y >> 16) * s,
                             byte_to_float<P>(w.y >> 24) * s);
      *reinterpret_cast<uint4*>(sm.conv[kv] + t * L::kStride + c * 8) = o;
    }
  }
}

// ---- bf16 q: the tensor-core body of the split pass.
template <int D, typename P, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_tc_kernel(const bf16* __restrict__ q, const P* __restrict__ k,
                     const P* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, Rows rows,
                     float* __restrict__ ws, int H, float scale_log2) {
  using L = Layout<bf16, D, P>;
  constexpr int kS = L::kStride;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = rows.n(b);
  if (split * kSplit >= n) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = H / gridDim.y, n_split = gridDim.x;
  const int p0 = split * kSplit + warp * kWarpKeys;
  const WarpSmem<bf16, D, P> sm(dec_smem, warp);
  const long long grow0 = static_cast<long long>(b) * H + h * rep;

  stage_keys(sm, rows, b, h, p0, n, k, v, k_scale, v_scale, lane);
  stage_q(sm, q, grow0 * D, rep);
  __syncthreads();

  const bf16* kt = L::kQuant ? sm.conv[0]
                             : reinterpret_cast<const bf16*>(sm.stage[0]);
  const bf16* vt = L::kQuant ? sm.conv[1]
                             : reinterpret_cast<const bf16*>(sm.stage[1]);
  const bf16* qs = reinterpret_cast<const bf16*>(sm.q);
  float* ws_ml = ws + static_cast<long long>(gridDim.z) * H * n_split * D;
  for (int mt = 0; mt * kRowTile < rep; ++mt) {
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      mma::ldmatrix_x4(qf[kd], qs + (mt * kRowTile + lane % 16) * kS +
                                   kd * 16 + (lane / 16) * 8);
    // S = Q K^T over the warp's 32 keys: 4 column tiles of 8 keys; the
    // first m tile waits for each stage as it needs it.
    float s[kWarpKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kWarpKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kWarpKeys / kStageKeys; ++st) {
      if (mt == 0) {
        if (st == 0)
          mma::cp_async_wait<1>();
        else
          mma::cp_async_wait<0>();
        __syncwarp();
        if constexpr (L::kQuant) {
          dequant_stage(sm, st, lane);
          __syncwarp();
        }
      }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t r[4];
        mma::ldmatrix_x4(r, kt + (st * 16 + lane % 8 + (lane / 16) * 8) * kS +
                                kd * 16 + ((lane / 8) % 2) * 8);
        mma::mma_bf16(s[2 * st], qf[kd], r[0], r[1]);
        mma::mma_bf16(s[2 * st + 1], qf[kd], r[2], r[3]);
      }
    }

    // Softmax of rows g and g + 8 over the warp's keys (keys past n
    // masked), scores scaled in fp32 inside the exponent.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kWarpKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (p0 + j * 8 + 2 * (lane % 4) + (e % 2) >= n) s[j][e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float m_scaled[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_scaled[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < kWarpKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], scale_log2, -m_scaled[e / 2]));
        s[j][e] = p;
        l[e / 2] += p;
      }

    // O = bf16(P) @ V, 16 keys at a time.
    float o[D / 8][4];
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kWarpKeys / 16; ++kk) {
      const uint32_t a[4] = {
          mma::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          mma::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          mma::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          mma::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kS +
                   n2 * 16 + (lane / 16) * 8);
        mma::mma_bf16(o[2 * n2], a, r[0], r[1]);
        mma::mma_bf16(o[2 * n2 + 1], a, r[2], r[3]);
      }
    }

    // The warp's partial -> shared memory; then the block merges.
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = warp * kRowTile + g + 8 * i;
      if (t4 == 0) {
        sm.mm[r] = mx[i] == -INFINITY ? -INFINITY : m_scaled[i];
        sm.ml[r] = l[i];
      }
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        sm.mo[r * D + nn * 8 + 2 * t4] = o[nn][2 * i];
        sm.mo[r * D + nn * 8 + 2 * t4 + 1] = o[nn][2 * i + 1];
      }
    }
    __syncthreads();
    merge_warps(sm, ws, ws_ml, grow0 + mt * kRowTile,
                min(kRowTile, rep - mt * kRowTile), split, n_split);
    __syncthreads();
  }
}

// One element pair (d, d + 1) / one element d of a staged row, as fp32:
// bf16 exactly, a SCLAD payload times its scale (no rounding: fp32 q).
template <typename P>
__device__ __forceinline__ float2 staged_pair(const unsigned char* row,
                                              int d, float s) {
  if constexpr (kQuantized<P>) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + d);
    return make_float2(byte_to_float<P>(w) * s, byte_to_float<P>(w >> 8) * s);
  } else {
    return load_pair(reinterpret_cast<const bf16*>(row) + d);
  }
}
template <typename P>
__device__ __forceinline__ float staged_elem(const unsigned char* row, int d,
                                             float s) {
  if constexpr (kQuantized<P>)
    return byte_to_float<P>(row[d]) * s;
  else
    return to_float(reinterpret_cast<const bf16*>(row)[d]);
}

// ---- fp32 q: the exact-fp32 body of the split pass.  Lane t scores key
// t against 16 query rows (fp32 FMAs, q broadcast from shared memory);
// for P @ V lane c owns columns c, c + 32, ...
template <int D, typename P, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_exact_kernel(const float* __restrict__ q, const P* __restrict__ k,
                        const P* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, Rows rows,
                        float* __restrict__ ws, int H, float scale_log2) {
  using L = Layout<float, D, P>;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = rows.n(b);
  if (split * kSplit >= n) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = H / gridDim.y, n_split = gridDim.x;
  const int p0 = split * kSplit + warp * kWarpKeys;
  const WarpSmem<float, D, P> sm(dec_smem, warp);
  const long long grow0 = static_cast<long long>(b) * H + h * rep;

  stage_keys(sm, rows, b, h, p0, n, k, v, k_scale, v_scale, lane);
  stage_q(sm, q, grow0 * D, rep);
  mma::cp_async_wait<0>();
  __syncthreads();

  const float* qs = reinterpret_cast<const float*>(sm.q);
  const unsigned char* krow = sm.stage[0] + lane * L::kRowBytes;
  const float ks = L::kQuant ? sm.scale[0][lane] : 1.f;
  const bool live = p0 + lane < n;
  const int nk = min(kWarpKeys, max(n - p0, 0));  // live keys of the warp
  float* ws_ml = ws + static_cast<long long>(gridDim.z) * H * n_split * D;
  for (int mt = 0; mt * kRowTile < rep; ++mt) {
    const float* qt = qs + mt * kRowTile * D;
    float p[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) p[r] = 0.f;
    for (int d = 0; d < D; d += 2) {
      const float2 kk = staged_pair<P>(krow, d, ks);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        p[r] = fmaf(qt[r * D + d], kk.x, p[r]);
        p[r] = fmaf(qt[r * D + d + 1], kk.y, p[r]);
      }
    }
    float m_scaled[kRowTile], l[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      const float s = live ? p[r] : -INFINITY;
      const float m = warp_max(s);
      m_scaled[r] = m == -INFINITY ? -INFINITY : m * scale_log2;
      p[r] = live ? exp2f(fmaf(s, scale_log2, -m_scaled[r])) : 0.f;
      l[r] = warp_sum(p[r]);
    }
    float acc[kRowTile][D / 32];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const unsigned char* vrow = sm.stage[1] + t * L::kRowBytes;
      const float vsc = L::kQuant ? sm.scale[1][t] : 1.f;
      float vv[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i)
        vv[i] = staged_elem<P>(vrow, lane + 32 * i, vsc);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float pr = __shfl_sync(0xffffffffu, p[r], t);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      const int rr = warp * kRowTile + r;
      if (lane == 0) {
        sm.mm[rr] = m_scaled[r];
        sm.ml[rr] = l[r];
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) sm.mo[rr * D + lane + 32 * i] = acc[r][i];
    }
    __syncthreads();
    merge_warps(sm, ws, ws_ml, grow0 + mt * kRowTile,
                min(kRowTile, rep - mt * kRowTile), split, n_split);
    __syncthreads();
  }
}

// ---- The combine pass: one warp per (row, query head) merges the live
// splits' partials in split order and writes the output in q's type.
template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ ws, Rows rows,
                          T* __restrict__ out, int B, int H, int n_split) {
  const long long grow = static_cast<long long>(blockIdx.x) * kWarps +
                         threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (grow >= static_cast<long long>(B) * H) return;
  const int n = rows.n(static_cast<int>(grow / H));
  const int live = n > 0 ? (n + kSplit - 1) / kSplit : 0;
  const float* wo = ws + grow * n_split * D;
  const float* wml = ws + static_cast<long long>(B) * H * n_split * D +
                     grow * n_split * 2;
  float m = -INFINITY;
  for (int s = lane; s < live; s += 32) m = fmaxf(m, wml[2 * s]);
  m = warp_max(m);
  float l = 0.f, o[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) o[i] = 0.f;
  for (int s = 0; s < live; ++s) {
    const float c = exp2f(wml[2 * s] - m);
    l = fmaf(c, wml[2 * s + 1], l);
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      o[i] = fmaf(c, wo[s * D + lane + 32 * i], o[i]);
  }
#pragma unroll
  for (int i = 0; i < D / 32; ++i)
    out[grow * D + lane + 32 * i] = from_float<T>(live ? o[i] / l : 0.f);
}

// The split pass's body for q of type T.
template <typename T, int D, typename P, typename Rows>
auto split_kernel() {
  if constexpr (std::is_same<T, bf16>::value)
    return decode_tc_kernel<D, P, Rows>;
  else
    return decode_exact_kernel<D, P, Rows>;
}

// The split pass then the combine pass on `stream`; q, out (B, H, D) in
// T; ws: B * H * n_split * (D + 2) fp32.  Returns a cudaError_t code.
template <typename T, int D, typename P, typename Rows>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, Rows rows, float* ws, void* out, int B, int H,
           int Hk, int n_split, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = Layout<T, D, P>::kBytes;
  const auto kernel = split_kernel<T, D, P, Rows>();
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  kernel<<<dim3(n_split, Hk, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), ks, vs, rows, ws, H, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = static_cast<long long>(B) * H;
  decode_combine_kernel<T, D, Rows>
      <<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(ws, rows, static_cast<T*>(out), B, H, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
}  // namespace repro_torch
