// Paged flash-prefill for Hopper (sm_90a), with the chunk's K/V scatter,
// bf16 or SCLAD (int8/fp8) pool.
//
// Replaces the TPU kernel `paged_flash_prefill` (body `_prefill_kernel`,
// fp and `kv_dtype` branches) of src/repro/kernels/flash_prefill/
// flash_prefill.py.  One prompt chunk per row: queries (B, S, H, D), the
// chunk's own K/V (B, S, Hk, D), S = prefix + P with the P prompt tokens
// LEFT-padded, lengths[b] real tokens, start[b] positions already cached.
//
// Phase 1, attention (fp32 online softmax, paged_attention.cuh): the
// cached context [0, start[b]) is read through the row's block table, then
// the chunk itself, causal on padded column indices with the left-pad keys
// dropped and the patch-prefix keys always visible — the mask is derived
// here from start, lengths and prefix, the same rule as the TPU kernel's.
// Output (B, S, H * D); rows of pad positions are junk, as there.
//
// Phase 2, the scatter: position start + j takes padded chunk row j (patch
// prefix) or j + pad (prompt tokens), for j < prefix + lengths[b], stored
// directly through the table, one warp per (row, kv head) D-vector.  The
// TPU kernel's one-hot (bs, S) placement matmul and its read-then-write
// grid order are TPU devices; here the stores are plain indexed stores,
// and the pool bytes equal the plain version's bit for bit.  The blocks of
// query tile 0 do the stores.  There is no race: the stores touch only
// positions >= start, every read of the pool is of a position < start,
// and the engine's copy-on-write barrier makes every block a row writes
// exclusive to that row.  Rows past the chunk's length are not stored, so
// they keep their old payload and their old scale.
//
// SCLAD pool (int8 or fp8 payload + fp32 (N, bs, Hk) scales).  Context
// rows are dequantized on load (payload * scale in fp32, rounded to q's
// type).  The chunk's own K/V tile is fake-quantized in shared memory
// right after it is loaded — one warp per key row computes the row's amax
// over D and round-trips it through the codec — so a key scores the same
// in-chunk as it will when a later chunk or decode step reads it from the
// pool.  Every query tile of a row redoes this for the chunk keys it
// reads (cheap next to the scores).  The scatter quantizes each stored row
// the same way and writes its payload and, from lane 0, its scale.  All of
// it is kv_quant.quantize / fake_quant operation for operation.
//
// Design.  One thread block per (query tile, kv head, row).  A tile holds
// 64 query rows: 64 / rep query positions times the rep query heads that
// share the kv head, so each K/V tile loaded serves all of them.  A first
// chunk passes no start (the context phase is skipped).
//
// Bound on this card.  The work must read the context K/V,
// 2 * sum_b(start_b) * Hk * (D * payload_bytes + scale_bytes) bytes, plus
// the chunk's q, K, V and the output, and write the new K/V (and scales);
// it does 4 * H * D operations per visible (query, key) pair.  At the main
// path's shapes (chunks of 128 tokens over a few hundred cached positions)
// that is ~10-100 operations per byte: bandwidth-bound on paper.  This
// version re-reads the context once per query tile (from L2) and multiplies
// on the CUDA cores in fp32; tensor cores (wgmma) and TMA loads are later
// work.
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // query rows per block: positions * rep

template <typename T, int D, typename P>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, P* __restrict__ k_pool,
                         P* __restrict__ v_pool, float* __restrict__ k_scale,
                         float* __restrict__ v_scale,
                         const int* __restrict__ lengths,
                         const int* __restrict__ starts,
                         const int* __restrict__ tables, T* __restrict__ out,
                         int S, int H, int Hk, int bs, int T_, int prefix,
                         float scale) {
  extern __shared__ float smem[];
  __shared__ long long row_off[kTileKeys];
  const TileSmem<D, kRows> sm(smem);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hk;
  const int qpos = kRows / rep;  // query positions per tile
  const int q0 = qt * qpos;
  const int nq = min(qpos, S - q0);
  const int rows = nq * rep;
  const int length = lengths[b];
  const int pad = S - prefix - length;
  const int start = starts ? starts[b] : 0;
  const int* table = tables + static_cast<long long>(b) * T_;

  // Query row lr = position (q0 + lr / rep), head (h * rep + lr % rep).
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int lr = e / D, d = e % D;
    const long long src =
        ((static_cast<long long>(b) * S + q0 + lr / rep) * H + h * rep + lr % rep) * D + d;
    sm.q[e] = to_float(q[src]) * scale;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  float acc[kRows * D / kThreads];
#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) acc[i] = 0.f;
  __syncthreads();

  // Phase 1a: cached context [0, start), visible to every query.
  const int n_ctx = min(start, T_ * bs);
  for (int p0 = 0; p0 < n_ctx; p0 += kTileKeys) {
    const int nk = min(kTileKeys, n_ctx - p0);
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
    attend_tile<D, kRows, kThreads>(sm, load, nk, rows,
                                    [](int, int) { return true; }, acc);
  }

  // Phase 1b: the chunk, causal on padded indices, pad keys dropped.  Keys
  // past the tile's last query position are never visible.
  const int k_end = q0 + nq;
  for (int k0 = 0; k0 < k_end; k0 += kTileKeys) {
    const int nk = min(kTileKeys, k_end - k0);
    if (threadIdx.x < nk)
      row_off[threadIdx.x] =
          ((static_cast<long long>(b) * S + k0 + threadIdx.x) * Hk + h) * D;
    __syncthreads();
    auto load = [&]() {
      load_tile<D, kRows, kThreads>(sm, k_new, v_new, row_off, nk);
      if constexpr (kQuantized<P>) {
        __syncthreads();
        fake_quant_tile<D, kRows, kThreads, T, P>(sm, nk);
      }
    };
    attend_tile<D, kRows, kThreads>(
        sm, load, nk, rows,
        [=](int r, int t) {
          const int kj = k0 + t, qi = q0 + r / rep;
          return kj <= qi && (kj < prefix || kj >= prefix + pad);
        },
        acc);
  }

#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int lr = e / D, d = e % D;
    if (lr < rows) {
      const long long dst =
          ((static_cast<long long>(b) * S + q0 + lr / rep) * H + h * rep + lr % rep) * D + d;
      out[dst] = from_float<T>(acc[i] / fmaxf(sm.l[lr], 1e-30f));
    }
  }

  // Phase 2: the chunk's left-compacted K/V into the pool, a warp a row.
  if (qt == 0) {
    const int n_w = prefix + length;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int j = warp; j < n_w; j += kThreads / 32) {
      const int src_row = j < prefix ? j : j + pad;
      const int dest = start + j;
      const long long blk = table[min(dest / bs, T_ - 1)];
      const long long dst = (blk * bs + dest % bs) * Hk + h;  // (N, bs, Hk) row
      const long long src =
          ((static_cast<long long>(b) * S + src_row) * Hk + h) * D;
      store_row<D>(k_pool + dst * D, k_scale ? k_scale + dst : nullptr,
                   k_new + src, lane);
      store_row<D>(v_pool + dst * D, v_scale ? v_scale + dst : nullptr,
                   v_new + src, lane);
    }
  }
}

template <typename T, int D, typename P>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, float* k_scale, float* v_scale, const int* lengths,
           const int* starts, const int* tables, void* out, int B, int S,
           int H, int Hk, int bs, int T_, int prefix, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TileSmem<D, kRows>::kFloats * sizeof(float);
  cudaError_t err = allow_smem(paged_prefill_kernel<T, D, P>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const int qpos = kRows / (H / Hk);
  const dim3 grid((S + qpos - 1) / qpos, Hk, B);
  paged_prefill_kernel<T, D, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<P*>(k_pool),
      static_cast<P*>(v_pool), k_scale, v_scale, lengths, starts, tables,
      static_cast<T*>(out), S, H, Hk, bs, T_, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_kv(int kv_kind, const void* q, const void* k_new,
              const void* v_new, void* k_pool, void* v_pool, float* k_scale,
              float* v_scale, const int* lengths, const int* starts,
              const int* tables, void* out, int B, int S, int H, int Hk,
              int bs, int T_, int prefix, cudaStream_t s) {
  switch (kv_kind) {
    case kKvBf16:
      return launch<T, D, __nv_bfloat16>(q, k_new, v_new, k_pool, v_pool,
                                         nullptr, nullptr, lengths, starts,
                                         tables, out, B, S, H, Hk, bs, T_,
                                         prefix, s);
    case kKvInt8:
      return launch<T, D, int8_t>(q, k_new, v_new, k_pool, v_pool, k_scale,
                                  v_scale, lengths, starts, tables, out, B, S,
                                  H, Hk, bs, T_, prefix, s);
    case kKvFp8:
      return launch<T, D, fp8_e4m3>(q, k_new, v_new, k_pool, v_pool, k_scale,
                                    v_scale, lengths, starts, tables, out, B,
                                    S, H, Hk, bs, T_, prefix, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q: (B, S, H, D); k_new, v_new: (B, S, Hk, D), all bf16 (q_bf16 = 1) or
// fp32; pools: (N, bs, Hk, D) bf16 (kv_kind 0), int8 (1) or fp8 e4m3 (2),
// updated in place; k_scale, v_scale: (N, bs, Hk) fp32, updated in place,
// for kv_kind 1-2, else null; lengths: (B,) int32; starts: (B,) int32, or
// null for a first chunk; tables: (B, T) int32; out: (B, S, H * D) in q's
// type.  Returns a cudaError_t code.
extern "C" int repro_paged_prefill(const void* q, const void* k_new,
                                   const void* v_new, void* k_pool,
                                   void* v_pool, float* k_scale,
                                   float* v_scale, const int* lengths,
                                   const int* starts, const int* tables,
                                   void* out, int B, int S, int H, int Hk,
                                   int D, int bs, int T, int prefix,
                                   int q_bf16, int kv_kind, void* stream) {
  using namespace repro_torch;
  if (Hk <= 0 || H % Hk != 0 || kRows % (H / Hk) != 0 || bs <= 0 || T <= 0 ||
      S <= 0 || prefix < 0 || prefix > S ||
      (kv_kind != kKvBf16 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && q_bf16)
    return launch_kv<__nv_bfloat16, 64>(kv_kind, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, lengths, starts, tables, out, B, S, H, Hk, bs, T, prefix, s);
  if (D == 128 && q_bf16)
    return launch_kv<__nv_bfloat16, 128>(kv_kind, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, lengths, starts, tables, out, B, S, H, Hk, bs, T, prefix, s);
  if (D == 64 && !q_bf16)
    return launch_kv<float, 64>(kv_kind, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, lengths, starts, tables, out, B, S, H, Hk, bs, T, prefix, s);
  if (D == 128 && !q_bf16)
    return launch_kv<float, 128>(kv_kind, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, lengths, starts, tables, out, B, S, H, Hk, bs, T, prefix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
