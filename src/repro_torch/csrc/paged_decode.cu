// Paged flash-decode for Hopper (sm_90a), bf16 or SCLAD (int8/fp8) pool.
//
// Replaces the TPU kernel `paged_flash_decode` (body `_paged_decode_kernel`,
// fp and `quantized` branches) of src/repro/kernels/flash_decode/
// flash_decode.py: one new query token per row attends over that row's
// cached positions [0, lengths[b]), read straight out of the shared
// (N, bs, Hk, D) block pool through the row's (B, T) block table, with an
// fp32 online softmax.  Output (B, H, D).
//
// Pool encodings.  A bf16 pool is read as it is.  A SCLAD pool holds an
// int8 or fp8 (e4m3) payload and fp32 scales (N, bs, Hk) read through the
// same table walk; on load each element becomes payload * scale in fp32,
// rounded to q's type (the cast chain of kv_quant.dequantize(..., q.dtype)),
// so the kernel scores the values its plain version scores.
//
// Design.  One thread block per (row, kv head): it holds the rep = H / Hk
// query heads that share the kv head (GQA), so each cached K/V byte is read
// from device memory once per step, never once per query head.  The block
// walks the positions in tiles of 32 keys (paged_attention.cuh), resolving
// each key's pool block through the table; this in-block loop replaces the
// TPU grid's sequential table axis and its VMEM accumulator.  The loop
// stops at min(lengths[b], T * bs): dead lanes carry all-trash tables and
// stale lengths, so they read only the trash block and never past the
// table.  bs is a runtime argument; D is a template argument (64 or 128).
//
// Bound on this card.  The work reads the live K/V bytes, per layer
// 2 * sum_b(len_b) * Hk * (D * payload_bytes + scale_bytes) (payload 2
// bytes and no scale for bf16; 1 byte and a 4-byte scale for int8/fp8),
// and does about 4 * H * D operations per cached position: far below the
// card's ~295 operations per byte, so device-memory bandwidth bounds it.
// At the main path's shapes (B = 8 rows, Hk = 4) the grid is only
// B * Hk = 32 blocks on 132 SMs, so most SMs sit idle and the kernel runs
// well under that bound; splitting the table walk across blocks (with a
// combine pass) is the fix, left to a later change along with TMA loads
// and wgmma.
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // the most query heads one kv head may serve

template <typename T, int D, typename P>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ lengths,
                        const int* __restrict__ tables, T* __restrict__ out,
                        int H, int Hk, int bs, int T_, float scale) {
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

  const int* table = tables + static_cast<long long>(b) * T_;
  const int n = min(lengths[b], T_ * bs);
  for (int p0 = 0; p0 < n; p0 += kTileKeys) {
    const int nk = min(kTileKeys, n - p0);
    if (threadIdx.x < nk) {
      const int pos = p0 + threadIdx.x;
      const long long blk = table[pos / bs];
      row_off[threadIdx.x] = ((blk * bs + pos % bs) * Hk + h) * D;
    }
    __syncthreads();
    auto load = [&]() {
      if constexpr (kQuantized<P>)
        load_tile_dequant<D, kRows, kThreads, T>(sm, k_pool, v_pool, k_scale,
                                                 v_scale, row_off, nk);
      else
        load_tile<D, kRows, kThreads>(sm, k_pool, v_pool, row_off, nk);
    };
    attend_tile<D, kRows, kThreads>(sm, load, nk, rep,
                                    [](int, int) { return true; }, acc);
  }
  if (n <= 0) __syncthreads();  // m/l initialisation visible to all

#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / D;
    if (r < rep) out[q_base + e] = from_float<T>(acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <typename T, int D, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* lengths,
           const int* tables, void* out, int B, int H, int Hk, int bs, int T_,
           cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TileSmem<D, kRows>::kFloats * sizeof(float);
  cudaError_t err = allow_smem(paged_decode_kernel<T, D, P>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  paged_decode_kernel<T, D, P><<<dim3(Hk, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, lengths, tables,
      static_cast<T*>(out), H, Hk, bs, T_, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_kv(int kv_kind, const void* q, const void* k_pool,
              const void* v_pool, const float* k_scale, const float* v_scale,
              const int* lengths, const int* tables, void* out, int B, int H,
              int Hk, int bs, int T_, cudaStream_t s) {
  switch (kv_kind) {
    case kKvBf16:
      return launch<T, D, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                         lengths, tables, out, B, H, Hk, bs,
                                         T_, s);
    case kKvInt8:
      return launch<T, D, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                  lengths, tables, out, B, H, Hk, bs, T_, s);
    case kKvFp8:
      return launch<T, D, fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale,
                                    lengths, tables, out, B, H, Hk, bs, T_, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, H, D) bf16 (q_bf16 = 1) or fp32; pools: (N, bs, Hk, D) bf16
// (kv_kind 0), int8 (1) or fp8 e4m3 (2); k_scale, v_scale: (N, bs, Hk)
// fp32 for kv_kind 1-2, else null; lengths: (B,) int32; tables: (B, T)
// int32.  Returns a cudaError_t code.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const float* k_scale,
                                  const float* v_scale, const int* lengths,
                                  const int* tables, void* out, int B, int H,
                                  int Hk, int D, int bs, int T, int q_bf16,
                                  int kv_kind, void* stream) {
  using namespace repro_torch;
  if (Hk <= 0 || H % Hk != 0 || H / Hk > kRows || bs <= 0 || T <= 0 ||
      (kv_kind != kKvBf16 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && q_bf16)
    return launch_kv<__nv_bfloat16, 64>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, lengths, tables, out, B, H, Hk, bs, T, s);
  if (D == 128 && q_bf16)
    return launch_kv<__nv_bfloat16, 128>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, lengths, tables, out, B, H, Hk, bs, T, s);
  if (D == 64 && !q_bf16)
    return launch_kv<float, 64>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, lengths, tables, out, B, H, Hk, bs, T, s);
  if (D == 128 && !q_bf16)
    return launch_kv<float, 128>(kv_kind, q, k_pool, v_pool, k_scale, v_scale, lengths, tables, out, B, H, Hk, bs, T, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
