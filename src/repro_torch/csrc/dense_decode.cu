// Dense flash-decode for Hopper (sm_90a): decode attention over per-row
// K/V stripes.
//
// Replaces the TPU kernel `flash_decode` (body `_decode_kernel`) of
// src/repro/kernels/flash_decode/flash_decode.py: one new query token per
// row attends over positions [0, lengths[b]) of that row's bf16 stripes
// k_cache/v_cache (B, S, Hk, D), with an fp32 online softmax.  Output
// (B, H, D) in q's type.  This is the wave path's decode read (the dense
// (L, B, max_len, Hk, D) cache that model.prefill builds).
//
// Design.  The paged decode kernel's, with the table walk replaced by
// direct row offsets ((b * S + pos) * Hk + h) * D: one thread block per
// (row, kv head) holding the rep = H / Hk query heads that share the kv
// head, 32-key tiles folded into the block's fp32 online-softmax state by
// the shared tile step (paged_attention.cuh).  The walk stops at
// min(lengths[b], S); the TPU kernel's `block_k` grid axis and its VMEM
// accumulator become this in-block loop.
//
// Bound on this card.  The work reads 2 * sum_b(min(len_b, S)) * Hk * D * 2
// bytes of K/V and does about 4 * H * D operations per position read: far
// below the card's ~295 operations per byte, so device-memory bandwidth
// bounds it.  With one or a few rows per wave the grid is only B * Hk
// blocks, so this simple version runs far under that bound; splitting the
// walk across blocks is the fix, as for the paged kernel.
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // the most query heads one kv head may serve

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dense_decode_kernel(const T* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_cache,
                        const __nv_bfloat16* __restrict__ v_cache,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int H, int Hk, float scale) {
  extern __shared__ float smem[];
  __shared__ long long row_off[kTileKeys];
  const TileSmem<D, kRows> sm(smem);
  const int h = blockIdx.x, b = blockIdx.y;
  const int rep = H / Hk;
  const long long q_base = (static_cast<long long>(b) * H + h * rep) * D;

  for (int e = threadIdx.x; e < rep * D; e += kThreads)
    sm.q[e] = to_float(q[q_base + e]) * scale;
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  float acc[kRows * D / kThreads];
#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) acc[i] = 0.f;

  const int n = min(lengths[b], S);
  for (int p0 = 0; p0 < n; p0 += kTileKeys) {
    const int nk = min(kTileKeys, n - p0);
    if (threadIdx.x < nk)
      row_off[threadIdx.x] =
          ((static_cast<long long>(b) * S + p0 + threadIdx.x) * Hk + h) * D;
    __syncthreads();
    attend_tile<D, kRows, kThreads>(
        sm,
        [&]() {
          load_tile<D, kRows, kThreads>(sm, k_cache, v_cache, row_off, nk);
        },
        nk, rep, [](int, int) { return true; }, acc);
  }
  if (n <= 0) __syncthreads();  // m/l initialisation visible to all

#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / D;
    if (r < rep) out[q_base + e] = from_float<T>(acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* lengths, void* out, int B, int S, int H, int Hk,
           cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TileSmem<D, kRows>::kFloats * sizeof(float);
  cudaError_t err = allow_smem(dense_decode_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  dense_decode_kernel<T, D><<<dim3(Hk, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), lengths,
      static_cast<T*>(out), S, H, Hk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, H, D) bf16 (q_bf16 = 1) or fp32; k_cache, v_cache:
// (B, S, Hk, D) bf16; lengths: (B,) int32.  Returns a cudaError_t code.
extern "C" int repro_dense_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const int* lengths,
                                  void* out, int B, int S, int H, int Hk,
                                  int D, int q_bf16, void* stream) {
  using namespace repro_torch;
  if (Hk <= 0 || H % Hk != 0 || H / Hk > kRows || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && q_bf16)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, lengths, out, B, S, H, Hk, s);
  if (D == 128 && q_bf16)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, lengths, out, B, S, H, Hk, s);
  if (D == 64 && !q_bf16)
    return launch<float, 64>(q, k_cache, v_cache, lengths, out, B, S, H, Hk, s);
  if (D == 128 && !q_bf16)
    return launch<float, 128>(q, k_cache, v_cache, lengths, out, B, S, H, Hk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
