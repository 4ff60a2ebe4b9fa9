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
// Bound on this card.  The work reads q, k, v and writes the output once,
// and does 4 * D operations per visible (query, key) pair and head.  At the
// attention check's shapes (tinyllama-1.1b's 32 heads over 4 kv heads,
// D = 64, bf16) causal over 2048 positions is 17.2 GFLOP against 19 MB
// (~900 operations a byte, 17.4 us on the bf16 tensor cores' peak); 512 x
// 2048 causal 7.5 us, 128 x 2048 not causal 2.2 us: operations bound all
// three.
//
// bf16: tensor cores, in the FlashAttention-2 form.  One block per (query
// tile, query head, batch row), 16 query rows a warp: 8 warps (128 rows)
// at D = 64, 4 warps (64 rows) at D = 128, where the fp32 accumulators take
// twice the registers.  Causal query tiles are launched last tile first,
// so the longest key walks start first.  The Q tile is copied in once and
// its fragments stay in registers.  K/V tiles of 64 keys stream through a
// 3-stage cp.async ring (the next two tiles' copies in flight while this
// one is multiplied); key rows past Sk are zero-filled and masked to -inf.
// S = Q K^T by mma.sync m16n8k16 (K rows through ldmatrix as the column-
// major B operand); the scores are scaled in fp32 (1/sqrt(D), with log2(e)
// folded in, inside the exponent's fused multiply-add) and the online
// softmax runs in registers, the row max over the 4 lanes of a quad by
// __shfl_xor_sync.  P is rounded to bf16 in registers and fed straight
// back as the A operand of P @ V (V through ldmatrix.trans), as the TPU
// body's `p.astype(v.dtype) @ v`; the denominator l sums the fp32 p, as
// there.  A causal tile's key walk ends at the last key its last row sees
// (the TPU's `upper`), and only the tiles that cross the diagonal or Sk
// are masked element by element: the walk runs in two loops, unmasked
// tiles first.  Rows of the shared-memory tiles are padded by 16 bytes, so
// ldmatrix reads without bank conflicts.  On an H100 (80GB HBM3, 700 W,
// chip_smoke.py) causal 2048 runs at ~170 TFLOP/s, ~1.8x the time of
// PyTorch's SDPA: per 64-key tile a warp issues several times more other
// instructions than mma.sync (the softmax's exp2, max and rescaling,
// addresses, the ring's waits and barrier), and mma.sync does not reach
// the tensor cores' full rate; wgmma from shared memory with a producer
// warp feeding the ring is the next step.
//
// fp32: the exact-fp32 body of the first port, kept so that fp32 inputs
// keep fp32 products and probabilities (ATTN_TOL[float32] = 2e-5; TF32 or
// bf16 P would break it): one block per (64 query rows, head, batch row)
// walks 32-key tiles through the paged kernels' shared tile step
// (paged_attention.cuh: K/V rows as fp32 in shared memory, fp32 FMAs).  The
// dtype of q picks the body.
#include "mma.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

// ---- fp32: the exact-fp32 body.
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

// ---- bf16: the tensor-core body.
using bf16 = __nv_bfloat16;
constexpr int kBK = 64;          // keys per K/V tile

// 2^x on the special-function unit (ex2.approx.ftz: 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A warp owns 16 query rows.  At D = 64 a block has 8 warps (128 query
// rows share each K/V tile copied in, halving the L2 reads of 64-row
// blocks) and two blocks fit an SM at <= 128 registers a thread; at
// D = 128 the (16, D) fp32 accumulator and Q fragments take twice the
// registers, so a block has 4 warps.
template <int D>
struct TcShape {
  static constexpr int kWarps = D == 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // per SM
  static constexpr int kBQ = 16 * kWarps;    // query rows per block
  static constexpr int kStages = 3;          // K/V tiles in the ring
  static constexpr int kStride = D + 8;      // bf16 elements a smem row
  static constexpr int kTile = kBK * kStride;
  static constexpr size_t kBytes =
      size_t(kBQ * kStride + 2 * kStages * kTile) * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(TcShape<D>::kThreads,
                                  TcShape<D>::kMinBlocks)
    flash_attention_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ out, int Sq, int Sk, int H,
                              int Hk, int causal, float scale_log2) {
  using Sh = TcShape<D>;
  constexpr int kBQ = Sh::kBQ, kS = Sh::kStride, kNT = Sh::kThreads;
  constexpr int kStages = Sh::kStages;
  constexpr int kPieces = D / 8;            // 16-byte pieces a row
  constexpr int kRowStep = kNT / kPieces;   // rows one pass of the block copies
  extern __shared__ __align__(16) bf16 fa_smem[];
  bf16* qs = fa_smem;                    // [kBQ][kS]
  bf16* ks = qs + kBQ * kS;              // [kStages][kBK][kS]
  bf16* vs = ks + kStages * Sh::kTile;   // [kStages][kBK][kS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q0 = qt * kBQ;
  const int shift = Sk - Sq;  // causal: query i sees keys j <= i + shift
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + shift + 1) : Sk;
  const int ntiles = (k_end + kBK - 1) / kBK;
  // Tiles before n_plain need no mask: all their keys are below Sk and
  // visible to the block's first row.
  const int n_plain =
      min(ntiles, causal ? min(Sk / kBK, (q0 + shift + 1) / kBK) : Sk / kBK);
  const long long q_row = static_cast<long long>(H) * D;   // row strides
  const long long kv_row = static_cast<long long>(Hk) * D;

  // Copy roles: thread tid copies piece tid % kPieces of rows tid / kPieces
  // + i * kRowStep; rows past Sq or Sk are zero-filled.
  const int lr = tid / kPieces, lc = (tid % kPieces) * 8;
  const bf16* qp = q + (static_cast<long long>(b) * Sq + q0 + lr) * q_row +
                   h * D + lc;
  const long long kv_off =
      (static_cast<long long>(b) * Sk + lr) * kv_row + hk * D + lc;
#pragma unroll
  for (int i = 0; i < kBQ / kRowStep; ++i) {
    const bool in = q0 + lr + i * kRowStep < Sq;
    mma::cp_async16(qs + (lr + i * kRowStep) * kS + lc,
                    in ? qp + i * kRowStep * q_row : q, in);
  }
  auto load_kv = [&](int t) {
    const int slot = (t % kStages) * Sh::kTile + lr * kS + lc;
    const long long off = kv_off + static_cast<long long>(t) * kBK * kv_row;
#pragma unroll
    for (int i = 0; i < kBK / kRowStep; ++i) {
      const bool in = t * kBK + lr + i * kRowStep < Sk;
      const long long o = off + i * kRowStep * kv_row;
      mma::cp_async16(ks + slot + i * kRowStep * kS, in ? k + o : k, in);
      mma::cp_async16(vs + slot + i * kRowStep * kS, in ? v + o : v, in);
    }
  };
  // Tiles 0 .. kStages - 2 in flight (the Q tile with tile 0).
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_kv(t);
    mma::cp_async_commit();
  }

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // Rows g and g + 8 of the warp: running max of the raw scores, and this
  // lane's share of l.
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + lane / 4;  // query position of row g

  // One key tile; kMask only on the tiles that cross the diagonal or Sk.
  auto step = [&](int t, auto masked) {
    constexpr bool kMask = decltype(masked)::value;
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t (at t = 0 the Q tile too) is in, and every
                      // warp is done with tile t - 1, whose slot refills
    if (t + kStages - 1 < ntiles) load_kv(t + kStages - 1);
    mma::cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        mma::ldmatrix_x4(qf[kd], qs + (warp * 16 + lane % 16) * kS + kd * 16 +
                                     (lane / 16) * 8);
    }
    const bf16* kt = ks + (t % kStages) * Sh::kTile;
    const bf16* vt = vs + (t % kStages) * Sh::kTile;

    // S = Q K^T over the tile's 64 keys: 8 column tiles of 8 keys.
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

    // Mask, then fold the tile into the running max and sum.  The scores
    // are scaled in fp32 inside the exponent: p = 2^(s * scale_log2 -
    // m * scale_log2) = exp((s - m) / sqrt(D)).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kMask) {
          const int key = t * kBK + j * 8 + 2 * (lane % 4) + (e % 2);
          const int row = row0 + 8 * (e / 2);
          if (key >= Sk || (causal && key > row + shift)) s[j][e] = -INFINITY;
        }
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], m_scaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // A row with no visible key yet keeps p = 0 (2^-inf), not NaN.
      m_scaled[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      corr[i] = fast_exp2(m_run[i] * scale_log2 - m_scaled[i]);
      m_run[i] = m_new;
      l_part[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], scale_log2, -m_scaled[e / 2]));
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
            r, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kS +
                   n2 * 16 + (lane / 16) * 8);
        mma::mma_bf16(o[2 * n2], a, r[0], r[1]);
        mma::mma_bf16(o[2 * n2 + 1], a, r[2], r[3]);
      }
    }
  };
  for (int t = 0; t < n_plain; ++t) step(t, std::false_type{});
  for (int t = n_plain; t < ntiles; ++t) step(t, std::true_type{});
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    bf16* dst = out + (static_cast<long long>(b) * Sq + row) * q_row + h * D +
                2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          mma::pack_bf16x2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int Hk, int causal, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TcShape<D>::kBytes;
  cudaError_t err = allow_smem(flash_attention_tc_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  constexpr int kBQ = TcShape<D>::kBQ;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_tc_kernel<D><<<grid, TcShape<D>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, Hk,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
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

// q, out: (B, Sq, H, D); k, v: (B, Sk, Hk, D); all bf16 (bf16 = 1: the
// tensor-core body) or fp32 (the exact-fp32 body); D 64 or 128; causal
// needs Sq <= Sk; pointers 16-byte aligned.  Returns a cudaError_t code.
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
    return launch_tc<64>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  if (D == 128 && bf16)
    return launch_tc<128>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  if (D == 64 && !bf16)
    return launch<float, 64>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  if (D == 128 && !bf16)
    return launch<float, 128>(q, k, v, out, B, Sq, Sk, H, Hk, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
