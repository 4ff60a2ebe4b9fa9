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
// Bound on this card.  The work reads 2 * sum_b(min(len_b, S)) * Hk * D * 2
// bytes of K/V and does about 4 * H * D operations per position read: far
// below the card's ~295 operations per byte, so device-memory bandwidth
// bounds it.
//
// Design: the paged decode kernel's (decode_attention.cuh), with the
// DenseRows address policy, position pos of row b at row (b * S + pos) *
// Hk + h.  The walk is split across blocks at a fixed 128 positions, grid
// (ceil(S / 128), Hk, B) from shapes alone, and stops at min(lengths[b],
// S): the one-row waves of the wave engine, which gave the old kernel 4
// blocks, now spread a long row over up to S / 128 * Hk blocks.  bf16 q
// on the tensor cores, fp32 q exact; a second kernel merges the splits in
// a fixed order.  A call is two device launches.
//
// Predicted at chip_smoke.py's shapes (8 rows of (1024, 4, 64) stripes,
// lengths 0-1024): 0.008-0.020 ms, against 0.144 ms for the kernel it
// replaces.
#include "decode_attention.cuh"

// q, out: (B, H, D) bf16 (q_bf16 = 1) or fp32; k_cache, v_cache:
// (B, S, Hk, D) bf16, 16-byte aligned; lengths: (B,) int32; ws:
// B * H * n_split * (D + 2) fp32 scratch, n_split = ceil(S / 128).
// Launches the split pass and the combine pass on `stream`.  Returns a
// cudaError_t code.
extern "C" int repro_dense_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const int* lengths,
                                  void* ws, void* out, int B, int S, int H,
                                  int Hk, int D, int n_split, int q_bf16,
                                  void* stream) {
  using namespace repro_torch;
  using decode::launch;
  using bf16 = __nv_bfloat16;
  if (B <= 0 || B > 65535 || Hk <= 0 || Hk > 65535 || H % Hk != 0 ||
      H / Hk > decode::kMaxRep || S <= 0 ||
      n_split != (S + decode::kSplit - 1) / decode::kSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode::DenseRows rows{lengths, S, Hk};
  float* w = static_cast<float*>(ws);
  if (D == 64 && q_bf16)
    return launch<bf16, 64, bf16>(q, k_cache, v_cache, nullptr, nullptr, rows, w, out, B, H, Hk, n_split, s);
  if (D == 128 && q_bf16)
    return launch<bf16, 128, bf16>(q, k_cache, v_cache, nullptr, nullptr, rows, w, out, B, H, Hk, n_split, s);
  if (D == 64 && !q_bf16)
    return launch<float, 64, bf16>(q, k_cache, v_cache, nullptr, nullptr, rows, w, out, B, H, Hk, n_split, s);
  if (D == 128 && !q_bf16)
    return launch<float, 128, bf16>(q, k_cache, v_cache, nullptr, nullptr, rows, w, out, B, H, Hk, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
