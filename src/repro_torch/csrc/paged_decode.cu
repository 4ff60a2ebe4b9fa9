// Paged flash-decode for Hopper (sm_90a), bf16, f8 or SCLAD (int8/fp8)
// pool.
//
// Replaces the TPU kernel `paged_flash_decode` (body `_paged_decode_kernel`,
// fp and `quantized` branches) of src/repro/kernels/flash_decode/
// flash_decode.py: one new query token per row attends over that row's
// cached positions [0, lengths[b]), read straight out of the shared
// (N, bs, Hk, D) block pool through the row's (B, T) block table, with an
// fp32 online softmax.  Output (B, H, D).
//
// Pool encodings.  A bf16 pool is read as it is.  An f8 pool (kv_dtype
// "f8": float8_e4m3fn, no scales) is read one byte an element and widened
// to bf16 on load, exactly: the values the reference's fp route scores
// after its cast of the pool, with probs @ V in bf16 as its `_pv_dtype`
// has it for f8.  A SCLAD pool holds an
// int8 or fp8 (e4m3) payload and fp32 scales (N, bs, Hk) read through the
// same table walk; on load each element becomes payload * scale in fp32,
// rounded to q's type (the cast chain of kv_quant.dequantize(..., q.dtype)),
// so the kernel scores the values its plain version scores.
//
// Bound on this card.  The work reads the live K/V bytes, per layer
// 2 * sum_b(len_b) * Hk * (D * payload_bytes + scale_bytes) (payload 2
// bytes and no scale for bf16; 1 byte and no scale for f8; 1 byte and a
// 4-byte scale for int8/fp8),
// and does about 4 * H * D operations per cached position: far below the
// card's ~295 operations per byte, so device-memory bandwidth bounds it.
//
// Design (decode_attention.cuh, with the PagedRows address policy: a
// position's pool row is (table[pos / bs] * bs + pos % bs) * Hk + h).  The
// table walk is split across blocks at a fixed 128 positions, grid
// (ceil(T * bs / 128), Hk, B) from shapes alone; the walk stops at
// min(lengths[b], T * bs), so dead lanes (all-trash tables, stale lengths)
// read only the trash block and never past the table.  Four warps of a
// block each take 32 positions through 16-byte cp.async, bf16 q runs
// Q K^T and P V on the tensor cores (mma.sync), fp32 q stays exact fp32;
// a second kernel merges the splits in a fixed order from the fp32
// workspace the wrapper allocates.  A call is two device launches.  bs is
// a runtime argument; D is a template argument (64 or 128).
//
// Predicted at chip_smoke.py's shapes (8 lanes, 64-entry tables of
// 16-token blocks, lengths 1-1024, tinyllama's 32 / 4 heads of 64):
// 0.008-0.020 ms on a bf16 pool, 0.010-0.025 ms on an int8/fp8 pool,
// against 0.148 / 0.133 ms for the one-block-per-(row, kv head) kernel it
// replaces.
#include "decode_attention.cuh"

namespace repro_torch {
namespace {

template <typename T, int D>
int launch_kv(int kv_kind, const void* q, const void* k_pool,
              const void* v_pool, const float* k_scale, const float* v_scale,
              decode::PagedRows rows, float* ws, void* out, int B, int H,
              int Hk, int n_split, cudaStream_t s) {
  switch (kv_kind) {
    case kKvBf16:
      return decode::launch<T, D, __nv_bfloat16>(
          q, k_pool, v_pool, nullptr, nullptr, rows, ws, out, B, H, Hk,
          n_split, s);
    case kKvInt8:
      return decode::launch<T, D, int8_t>(q, k_pool, v_pool, k_scale,
                                          v_scale, rows, ws, out, B, H, Hk,
                                          n_split, s);
    case kKvFp8:
      return decode::launch<T, D, fp8_e4m3>(q, k_pool, v_pool, k_scale,
                                            v_scale, rows, ws, out, B, H, Hk,
                                            n_split, s);
    case kKvF8:
      return decode::launch<T, D, f8_e4m3>(q, k_pool, v_pool, nullptr,
                                           nullptr, rows, ws, out, B, H, Hk,
                                           n_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, H, D) bf16 (q_bf16 = 1) or fp32; pools: (N, bs, Hk, D) bf16
// (kv_kind 0), int8 (1), fp8 e4m3 with scales (2) or f8 e4m3 without (3),
// 16-byte aligned; k_scale, v_scale: (N, bs, Hk) fp32 for kv_kind 1-2,
// else null; lengths: (B,)
// int32; tables: (B, T) int32; ws: B * H * n_split * (D + 2) fp32 scratch,
// n_split = ceil(T * bs / 128).  Launches the split pass and the combine
// pass on `stream`.  Returns a cudaError_t code.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const float* k_scale,
                                  const float* v_scale, const int* lengths,
                                  const int* tables, void* ws, void* out,
                                  int B, int H, int Hk, int D, int bs, int T,
                                  int n_split, int q_bf16, int kv_kind,
                                  void* stream) {
  using namespace repro_torch;
  if (B <= 0 || B > 65535 || Hk <= 0 || Hk > 65535 || H % Hk != 0 ||
      H / Hk > decode::kMaxRep || bs <= 0 || T <= 0 ||
      n_split != (T * bs + decode::kSplit - 1) / decode::kSplit ||
      ((kv_kind == kKvInt8 || kv_kind == kKvFp8) &&
       (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decode::PagedRows rows{lengths, tables, T, bs, Hk};
  float* w = static_cast<float*>(ws);
  if (D == 64 && q_bf16)
    return launch_kv<__nv_bfloat16, 64>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, rows, w, out, B, H, Hk, n_split, s);
  if (D == 128 && q_bf16)
    return launch_kv<__nv_bfloat16, 128>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, rows, w, out, B, H, Hk, n_split, s);
  if (D == 64 && !q_bf16)
    return launch_kv<float, 64>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, rows, w, out, B, H, Hk, n_split, s);
  if (D == 128 && !q_bf16)
    return launch_kv<float, 128>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, rows, w, out, B, H, Hk, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
