// Block-SCLD matmul for Hopper (sm_90a): y = x @ decode(vals, rows).
//
// Replaces the TPU kernel `sclad_matmul` (body `_sclad_kernel`) of
// src/repro/kernels/sclad_matmul/sclad_matmul.py.  The weight W (K, N) is
// stored as compressed (128, 128) tiles: each keeps C of its 16 (8, 128)
// row-units, `vals` (K/128, N/128, C, 8, 128) fp32 or bf16, with the units'
// row indices `rows` (K/128, N/128, C) int32.  x (M, K) and y (M, N) are fp32
// or bf16 (y in x's type).
//
// Design.  One thread block per (64-row M tile, 128-column N tile); a loop
// over the K tiles inside the block takes the place of the TPU's sequential
// K/128 grid axis and its VMEM accumulator (the fp32 sums stay in
// registers).  Per K tile the block decodes the stored units into a dense
// 128 x 128 tile in shared memory, zero wherever no unit is stored
// (load-as-dense, the paper's contract: the multiply that follows does not
// know the sparsity), and loads x's 64 x 128 tile beside it.  Each decoded
// weight is rounded to x's type before its product, as the TPU body's
// `w_scratch.astype(x.dtype)` does; products accumulate in fp32.  Each
// thread owns a 4 x 8 block of outputs.  The two tiles take 96 KB of
// dynamic shared memory.
//
// Bound on this card.  The work reads x, the stored units (C/16 of the dense
// weight's bytes), the rows and writes y, and does 2 * M * K * N dense
// operations.  At the SCLD check's shapes (M = 128, tinyllama-1.1b's MLP
// widths) that is ~280 operations per byte at C = 6: near the card's bf16
// ridge.  This version multiplies on the CUDA cores in fp32 (~1/15 of the
// bf16 tensor cores' peak), and its tile loads and multiply take turns
// (one buffer, 88 or 32 blocks at those widths): on the card its time
// falls with the units loaded a tile, not with the operations.  Tensor
// cores (wgmma), loads in flight during the multiply (TMA or cp.async into
// a ring of tiles) and a split of the K loop are the later work.
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 128;              // tile edge, along K and N
constexpr int kUnitRows = 8;            // rows of one stored unit
constexpr int kUnits = kTile / kUnitRows;  // 16 units a tile
constexpr int kUnitElems = kUnitRows * kTile;
constexpr int kBM = 64;                 // rows of x per block
constexpr int kThreads = 256;
// w [kTile][kTile] (k, n), then xs [kTile][kBM] (k, m): x's tile transposed.
constexpr size_t kSmemBytes = (size_t(kTile) * kTile + size_t(kTile) * kBM) *
                              sizeof(float);

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    sclad_matmul_kernel(const T* __restrict__ x, const V* __restrict__ vals,
                        const int* __restrict__ rows, T* __restrict__ y,
                        int M, int nk, int nn, int C) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int unit_of[kUnits];  // stored unit c at tile row-unit u, or -1
  float* w = smem;
  float* xs = smem + kTile * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, jn = blockIdx.y;
  const long long K = static_cast<long long>(nk) * kTile;
  const long long N = static_cast<long long>(nn) * kTile;

  // Thread (ty, tx) owns rows m0 + ty * 4 + i and columns jn * 128 +
  // tx * 4 + j, jn * 128 + 64 + tx * 4 + j (i, j < 4).
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const long long tile = static_cast<long long>(kt) * nn + jn;
    const int* r = rows + tile * C;
    const V* src = vals + tile * C * kUnitElems;
    if (tid < kUnits) {
      int c_of = -1;
      for (int c = 0; c < C; ++c)
        if (r[c] == tid) c_of = c;
      unit_of[tid] = c_of;
    }
    __syncthreads();  // unit map ready; the previous tile's reads are done

    // Decode: the dense tile, zero where no unit is stored.
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int c = unit_of[e / kUnitElems];
      w[e] = c < 0 ? 0.f
                   : round_to<T>(to_float(src[c * kUnitElems + e % kUnitElems]));
    }
    // x's tile, transposed; rows past M read as zero.
    for (int e = tid; e < kBM * kTile; e += kThreads) {
      const int m = e % kBM, k = e / kBM;
      xs[k * kBM + m] =
          m0 + m < M ? to_float(x[(m0 + m) * K + kt * kTile + k]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xs + k * kBM + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(w + k * kTile + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(w + k * kTile + 64 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // w, xs and unit_of are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    T* yr = y + m * N + jn * kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yr[tx * 4 + j] = from_float<T>(acc[i][j]);
      yr[64 + tx * 4 + j] = from_float<T>(acc[i][4 + j]);
    }
  }
}

template <typename T, typename V>
int launch(const void* x, const void* vals, const int* rows, void* y, int M,
           int nk, int nn, int C, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t err =
      allow_smem(sclad_matmul_kernel<T, V>, kSmemBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, nn);
  sclad_matmul_kernel<T, V><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const V*>(vals), rows,
      static_cast<T*>(y), M, nk, nn, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x: (M, nk * 128) fp32 (x_bf16 = 0) or bf16; vals: (nk, nn, C, 8, 128) fp32
// (vals_bf16 = 0) or bf16; rows: (nk, nn, C) int32, distinct within a tile,
// in [0, 16) (an index outside it stores nothing); y: (M, nn * 128) in x's
// type.  Returns a cudaError_t code.
extern "C" int repro_sclad_matmul(const void* x, const void* vals,
                                  const int* rows, void* y, int M, int nk,
                                  int nn, int C, int x_bf16, int vals_bf16,
                                  void* stream) {
  using namespace repro_torch;
  if (M <= 0 || nk <= 0 || nn <= 0 || nn > 65535 || C < 1 || C > kUnits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && vals_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, vals, rows, y, M, nk, nn, C, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, vals, rows, y, M, nk, nn, C, s);
  if (vals_bf16)
    return launch<float, __nv_bfloat16>(x, vals, rows, y, M, nk, nn, C, s);
  return launch<float, float>(x, vals, rows, y, M, nk, nn, C, s);
}
