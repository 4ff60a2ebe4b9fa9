// One key tile of the FlashAttention-2 form on Hopper's tensor cores,
// shared by the bf16 bodies of flash_attention.cu and paged_prefill.cu.
//
// A warp holds 16 query rows: their Q fragments in registers (the A
// operand of mma.sync m16n8k16), the online-softmax state of rows g and
// g + 8 of the fragment layout (lane = 4 g + t; mma.cuh), and their
// (16, D) fp32 output accumulator.  One call folds a tile of kBK keys whose
// bf16 K and V rows sit in shared memory, kS elements apart:
//   1. S = Q K^T by mma.sync (K rows through ldmatrix as the column-major
//      B operand), fp32 sums;
//   2. `hide(c, i)` true -> column c of the tile is -inf for the lane's
//      row g + 8 i (the caller's mask; a constant false compiles away);
//   3. the online softmax in registers: m the running max of the raw
//      scores (over the 4 lanes of a quad by __shfl_xor_sync), the scores
//      scaled in fp32 inside the exponent, p = 2^(s * scale_log2 - m *
//      scale_log2) = exp((s - m) * scale) with scale_log2 = log2(e) *
//      scale, l_part this lane's share of the row sum of the fp32 p;
//   4. O = O * corr + bf16(P) @ V, P rounded to bf16 in registers as the A
//      operand (the TPU bodies' `p.astype(v.dtype) @ v`), V through
//      ldmatrix.trans.
// A row with no visible key yet keeps p = 0 (2^-inf), not NaN.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>

#include "mma.cuh"

namespace repro_torch {

template <int D, int kBK, int kS, typename Hide>
__device__ __forceinline__ void flash_tile(const uint32_t (&qf)[D / 16][4],
                                           const __nv_bfloat16* kt,
                                           const __nv_bfloat16* vt,
                                           float scale_log2, Hide hide,
                                           float (&o)[D / 8][4],
                                           float (&m_run)[2],
                                           float (&l_part)[2]) {
  const int lane = threadIdx.x % 32;

  // S = Q K^T over the tile's keys: kBK / 8 column tiles of 8 keys.
  float s[kBK / 8][4];
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
#pragma unroll
    for (int j2 = 0; j2 < kBK / 16; ++j2) {
      uint32_t r[4];
      mma::ldmatrix_x4(r, kt + (j2 * 16 + lane % 8 + (lane / 16) * 8) * kS +
                              kd * 16 + ((lane / 8) % 2) * 8);
      mma::mma_bf16(s[2 * j2], qf[kd], r[0], r[1]);
      mma::mma_bf16(s[2 * j2 + 1], qf[kd], r[2], r[3]);
    }

  // Mask, then fold the tile into the running max and sum.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (hide(j * 8 + 2 * (lane % 4) + (e % 2), e / 2)) s[j][e] = -INFINITY;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  float corr[2], m_scaled[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    m_scaled[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    corr[i] = mma::fast_exp2(m_run[i] * scale_log2 - m_scaled[i]);
    m_run[i] = m_new;
    l_part[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          mma::fast_exp2(fmaf(s[j][e], scale_log2, -m_scaled[e / 2]));
      s[j][e] = p;
      l_part[e / 2] += p;
    }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }

  // O += bf16(P) @ V, 16 keys at a time; P's fragments are the score
  // registers of two neighbouring 8-key tiles.
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {
        mma::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
        mma::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
        mma::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        mma::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(
          r, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kS + n2 * 16 +
                 (lane / 16) * 8);
      mma::mma_bf16(o[2 * n2], a, r[0], r[1]);
      mma::mma_bf16(o[2 * n2 + 1], a, r[2], r[3]);
    }
  }
}

}  // namespace repro_torch
