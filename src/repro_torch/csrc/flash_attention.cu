// Blocked flash attention for Hopper (sm_90a): GQA, causal or not.
//
// Replaces the TPU kernel `flash_attention` (body `_attn_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py.  q (B, Sq, H, D),
// k and v (B, Sk, Hk, D), all fp32 or all bf16; output (B, Sq, H, D) in q's
// type.  Query head h reads kv head h / (H / Hk).  The causal mask is
// aligned bottom-right, as the plain version (ref.attention_ref) has it:
// query i sees keys j <= i + Sk - Sq.  The TPU body aligns it top-left
// (q_pos >= k_pos); the two agree at Sq == Sk, the only causal shape the
// JAX package's tests use.  The wrapper refuses causal with Sq > Sk, where
// rows would see no key.
//
// Design.  One thread block per (64-row query tile, query head, batch row).
// The keys are walked in 32-key tiles by the shared tile step of the paged
// kernels (paged_attention.cuh: K/V rows to shared memory as fp32, scores,
// fp32 online softmax, p @ V into register accumulators), with direct row
// offsets ((b * Sk + j) * Hk + kv head) * D in place of a block table.  A
// causal tile's walk ends at the last key its last row can see — the TPU's
// `upper`, so fully masked key tiles are never loaded.  The TPU's per-head
// grid axis and VMEM accumulator become this in-block loop.
//
// Bound on this card.  The work reads q, k, v and writes the output once,
// and does 4 * D operations per visible (query, key) pair and head.  At the
// attention check's shapes (S = 2048, 32 heads, D = 64, causal) that is ~900
// operations per byte: the card's bf16 tensor-core peak bounds it.  This
// version multiplies on the CUDA cores in fp32 out of shared memory and
// re-reads K/V once per query tile (from L2); tensor cores (wgmma) and TMA
// loads are the later work.
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // query rows per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int H, int Hk, int causal,
                           float scale) {
  extern __shared__ float smem[];
  __shared__ long long row_off[kTileKeys];
  const TileSmem<D, kRows> sm(smem);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q0 = qt * kRows;
  const int nq = min(kRows, Sq - q0);
  const int shift = Sk - Sq;  // causal: query i sees keys j <= i + shift

  // Query row r = position q0 + r of head h.
  for (int e = threadIdx.x; e < nq * D; e += kThreads) {
    const int r = e / D, d = e % D;
    sm.q[e] = to_float(q[((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + d]) * scale;
  }
  for (int r = threadIdx.x; r < nq; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  float acc[kRows * D / kThreads];
#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) acc[i] = 0.f;
  __syncthreads();

  const int k_end = causal ? min(Sk, q0 + nq + shift) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTileKeys) {
    const int nk = min(kTileKeys, k_end - k0);
    if (threadIdx.x < nk)
      row_off[threadIdx.x] =
          ((static_cast<long long>(b) * Sk + k0 + threadIdx.x) * Hk + hk) * D;
    __syncthreads();
    attend_tile<D, kRows, kThreads>(
        sm, [&]() { load_tile<D, kRows, kThreads>(sm, k, v, row_off, nk); },
        nk, nq,
        [=](int r, int t) { return !causal || k0 + t <= q0 + r + shift; },
        acc);
  }

#pragma unroll
  for (int i = 0; i < kRows * D / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / D, d = e % D;
    if (r < nq)
      out[((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D + d] =
          from_float<T>(acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hk, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TileSmem<D, kRows>::kFloats * sizeof(float);
  cudaError_t err = allow_smem(flash_attention_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hk, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, out: (B, Sq, H, D); k, v: (B, Sk, Hk, D); all bf16 (bf16 = 1) or fp32;
// D 64 or 128; causal needs Sq <= Sk.  Returns a cudaError_t code.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int Hk, int D, int causal,
                                     int bf16, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || H <= 0 || H > 65535 ||
      Hk <= 0 || H % Hk != 0 || (causal && Sq > Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && bf16)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  if (D == 128 && bf16)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  if (D == 64 && !bf16)
    return launch<float, 64>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  if (D == 128 && !bf16)
    return launch<float, 128>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
