// Dense flash-decode for Hopper (sm_90a): decode attention over per-row
// bf16 or f8 K/V stripes.
//
// Replaces the TPU kernel `flash_decode` (body `_decode_kernel`) of
// src/repro/kernels/flash_decode/flash_decode.py: one new query token per
// row attends over positions [0, lengths[b]) of that row's stripes
// k_cache/v_cache (B, S, Hk, D), with an fp32 online softmax.  Output
// (B, H, D) in q's type.  This is the wave path's decode read (the dense
// (L, B, max_len, Hk, D) cache that model.prefill builds).
//
// Stripe encodings.  bf16, or f8 (kv_dtype "f8": float8_e4m3fn, no
// scales) read one byte an element and widened to bf16 on load, exactly.
// The reference casts its f8 stripes to the compute dtype before its
// kernel (src/repro/models/layers.py attention_decode); reading them as
// they are gives the same values from half the bytes.
//
// Bound on this card.  The work reads 2 * sum_b(min(len_b, S)) * Hk * D * e
// bytes of K/V (e = 2 for bf16, 1 for f8) and does about 4 * H * D
// operations per position read: far
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
// Head dims 64, 128 and 112 (zamba2-7b's shared attention, 3584 / 32):
// the body's lanes hold ceil(D / 32) columns each, so a D that is a
// multiple of 16 but not of 32 loses no column.
//
// Predicted at chip_smoke.py's shapes (8 rows of (1024, 4, 64) stripes,
// lengths 0-1024): 0.008-0.020 ms, against 0.144 ms for the kernel it
// replaces.
#include "decode_attention.cuh"

namespace repro_torch {
namespace {

// The split and combine passes for q of type T at head dim D, on bf16
// (kv_kind 0) or f8 (3) stripes.
template <typename T, int D>
int launch_kv(int kv_kind, const void* q, const void* k_cache,
              const void* v_cache, decode::DenseRows rows, float* ws,
              void* out, int B, int H, int Hk, int n_split, cudaStream_t s) {
  switch (kv_kind) {
    case kKvBf16:
      return decode::launch<T, D, __nv_bfloat16>(q, k_cache, v_cache, nullptr,
                                                 nullptr, rows, ws, out, B, H,
                                                 Hk, n_split, s);
    case kKvF8:
      return decode::launch<T, D, f8_e4m3>(q, k_cache, v_cache, nullptr,
                                           nullptr, rows, ws, out, B, H, Hk,
                                           n_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, H, D) bf16 (q_bf16 = 1) or fp32; k_cache, v_cache:
// (B, S, Hk, D) bf16 (kv_kind 0) or f8 e4m3 (3), 16-byte aligned;
// lengths: (B,) int32; ws: B * H * n_split * (D + 2) fp32 scratch,
// n_split = ceil(S / 128).  Launches the split pass and the combine pass
// on `stream`.  Returns a cudaError_t code.
extern "C" int repro_dense_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const int* lengths,
                                  void* ws, void* out, int B, int S, int H,
                                  int Hk, int D, int n_split, int q_bf16,
                                  int kv_kind, void* stream) {
  using namespace repro_torch;
  using bf16 = __nv_bfloat16;
  if (B <= 0 || B > 65535 || Hk <= 0 || Hk > 65535 || H % Hk != 0 ||
      H / Hk > decode::kMaxRep || S <= 0 ||
      n_split != (S + decode::kSplit - 1) / decode::kSplit ||
      (kv_kind != kKvBf16 && kv_kind != kKvF8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode::DenseRows rows{lengths, S, Hk};
  float* w = static_cast<float*>(ws);
  if (D == 64 && q_bf16)
    return launch_kv<bf16, 64>(kv_kind, q, k_cache, v_cache, rows, w, out, B, H, Hk, n_split, s);
  if (D == 112 && q_bf16)
    return launch_kv<bf16, 112>(kv_kind, q, k_cache, v_cache, rows, w, out, B, H, Hk, n_split, s);
  if (D == 128 && q_bf16)
    return launch_kv<bf16, 128>(kv_kind, q, k_cache, v_cache, rows, w, out, B, H, Hk, n_split, s);
  if (D == 64 && !q_bf16)
    return launch_kv<float, 64>(kv_kind, q, k_cache, v_cache, rows, w, out, B, H, Hk, n_split, s);
  if (D == 112 && !q_bf16)
    return launch_kv<float, 112>(kv_kind, q, k_cache, v_cache, rows, w, out, B, H, Hk, n_split, s);
  if (D == 128 && !q_bf16)
    return launch_kv<float, 128>(kv_kind, q, k_cache, v_cache, rows, w, out, B, H, Hk, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
