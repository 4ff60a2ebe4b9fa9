// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan/ssd_scan.py:66.  Inputs, pre-scaled by the
// caller: xdt (BH, S, P), a (BH, S), b and c (BH / hpg, S, N), all fp32 or
// all bf16; row bh reads b and c row bh / hpg, its group's (hpg = 1: the
// reference's per-row b and c).  Outputs: y (BH, S, P) in the inputs' type
// and the final state (BH, P, N) fp32.  Per chunk of Q positions, with cum
// the inclusive cumsum of a over the chunk:
//   y     = ((C B^T) . L) xdt + exp(cum) . (C h_in^T),  L_ij = exp(cum_i - cum_j), i >= j
//   h_out = exp(cum_last) h_in + (xdt . exp(cum_last - cum))^T B
//
// Bound on this card.  The work reads xdt, a, each group's b and c, and
// writes y and the state once; the chunked form does, a chunk, the causal
// half of C B^T once a group (Q (Q + 1) / 2 * 2N), and a head the causal
// half of its product with xdt and the state's (Q (Q + 1) / 2 * 2P +
// 2QPN), and C h_in^T (2QPN) in every chunk after the first.  The served
// shape (mamba2-1.3b's prefill: 8 rows x 64 heads of P = 64, one group of
// N = 128, 512 positions, chunk 256, fp32) moves 156 MB and does 10.9
// GFLOP: 0.047 ms at 3.35 TB/s, 0.066 ms at the 3xTF32 rate (495 / 3
// TFLOP/s), operations-bound (chip_smoke.py's check_ssd_model).
//
// Design: the SSD paper's chunked algorithm (arXiv:2405.21060 §6) in
// passes, in place of the TPU's sequential chunk axis and its VMEM state.
// A chunk's own contribution to the state depends only on its inputs, so
// only a short scan over chunks is serial.  The wrapper allocates an fp32
// workspace (ssd_scan.ssd_plan, Args): chunk states (BH, nc, P, N), cum
// (BH, S), then for bf16 inputs h_in (BH, nc, P, N) in bf16, for fp32 ones
// the causal 64 x 64 tiles of C B^T a (group row, chunk).
//   1. Chunk states, one block per (bh, chunk): cum by a block scan in
//      fp32, written to the workspace (pass 3 reads it and never
//      recomputes it); s_c = (xdt . exp(cum_last - cum))^T B, a (P x Q)
//      (Q x N) product, into the chunk states.
//   2. State pass, one thread per 4 state entries of a bh: walks the
//      chunks in order, h_in[c] = h, h = exp(cum_last[c]) h + s_c, in fp32
//      FMAs with no atomics; the last h is the final state.
//   3. Chunk outputs, one block per (bh, chunk, 64-row query tile), each
//      chunk's heaviest query tile first: the key tiles j0 <= i0 of
//      ((C B^T) . L) xdt, and exp(cum_i) (C h_in^T) for chunks after the
//      first.  L is taken only where i >= j, so exp never sees a positive
//      argument, and element by element only on the diagonal tile.
//
// fp32 inputs (what the model hands the kernel) keep fp32 accuracy on the
// tensor cores: every product is 3xTF32 (mma.cuh: each operand split into
// a TF32 high part and a TF32 residual, hi.hi + hi.lo + lo.hi summed in
// fp32 by mma.sync m16n8k8; the split's residual and the dropped lo.lo are
// below 2^-22 of the product).  One TF32 product alone would not meet the
// 1e-5 per-head limit the checks hold fp32 to.  With one group for many
// heads (both Mamba-2 configs) C B^T is the same for every head of a batch
// row; only L differs.  So the score pass forms each causal tile of C B^T
// once a (group row, chunk) and pass 3 reads it from the workspace (4 MB
// at the served shape, in L2) in place of the N-deep product a head, and
// b and c are read once a group, never repeated a head.  Pass 1 and the
// score pass share one launch; with one chunk (prompts up to 256
// positions) pass 1 writes the final state itself and the state pass is
// not launched: two launches.  Tiles reach shared memory by 16-byte
// cp.async (2-stage rings in passes 1 and 3), cum, the decays, the chunk
// states, h_in and the final state stay fp32, and no operand is rounded to
// bf16.  A pass-3 tile's scores are decayed by the head's own L as their
// fragments are formed; chunk 0 skips C h_in^T, whose h_in is zero.
//
// bf16 inputs (b and c a head: the wrapper repeats grouped ones; no model hands
// the kernel bf16) run passes 1 and 3 on the tensor cores (mma.cuh: mma.sync
// m16n8k16, fp32 sums), their tiles fed by a 2-stage 16-byte cp.async ring and
// read through ldmatrix (rows padded by 16 bytes: no bank conflicts).  A pass-3
// block holds its C tile's fragments in registers for the whole key walk; the C
// tile arrives in the ring's second slot before the second key tile does, and
// h_in arrives as the walk's last entry, in the slot after the last key tile,
// so its copy overlaps that tile's products and needs no shared memory of its
// own (4 blocks an SM at the widths above).  Rounding points, each once to
// nearest-even bf16: the decayed xdt of pass 1 (xdt . exp(cum_last - cum) in
// fp32, rounded in shared memory before the product); h_in, which pass 2 writes
// in bf16 beside the fp32 chain so that pass 3 multiplies C h_in^T on the
// tensor cores; the decayed, masked scores, fed back from registers as the A
// operand of scores @ xdt.  The chunk states, the carried h and the final state
// stay fp32.  Pass 3 takes exp in base 2 on the special-function unit, cum
// scaled by log2(e) once.  Measured by chip_smoke.py on an H100 (80GB HBM3,
// 700 W) at mamba2-1.3b's widths over 2048 positions (bf16, chunk 256):
// 0.1149 ms, 3.7x its bytes bound (PERF.md, row 4); pass 3 is ~2/3 of it.
#include <cmath>

#include "mma.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;       // query rows of a pass-3 block; rows of a key tile
constexpr int kMaxPN = 128;     // P and N at most
constexpr int kMaxChunk = 256;
constexpr int kStages = 2;      // tiles in the cp.async ring of passes 1 and 3
constexpr int kChunkThreads = 256;  // pass 1 (one thread a chunk position)
constexpr int kStateThreads = 256;  // pass 2
constexpr float kLog2e = 1.4426950408889634f;

// ---- shared by both bodies.

// cum[0, Q) = inclusive cumsum of a[r0 .. r0 + Q) in fp32: a warp scan by
// shuffles, then the warp totals.  Called by all kChunkThreads threads;
// synchronizes inside; `wsum` holds 8 floats.
template <typename T>
__device__ __forceinline__ void chunk_cum(const T* __restrict__ a,
                                          long long r0, int Q, float* cum,
                                          float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float v = tid < Q ? to_float(a[r0 + tid]) : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  if (tid < Q) cum[tid] = v;
  __syncthreads();
}

// Pass 2: h_in[c] = h, h = exp(cum_last[c]) h + s_c over the chunks of
// one bh, 4 entries a thread; H = float writes h_in over the chunk states
// in place (each thread reads s_c before it writes h_in[c] at the same
// address; `states` is not __restrict__ for that), H = bf16 writes it
// rounded into its own buffer.
__device__ __forceinline__ void put_h(float4* dst, float4 h) { *dst = h; }
__device__ __forceinline__ void put_h(uint2* dst, float4 h) {
  *dst = make_uint2(mma::pack_bf16x2(h.x, h.y), mma::pack_bf16x2(h.z, h.w));
}

template <typename H>  // float4 or uint2 (4 bf16)
__global__ void __launch_bounds__(kStateThreads)
    ssd_state_pass_kernel(const float4* states, H* h_in,
                          const float* __restrict__ cum,
                          float4* __restrict__ state_out, int S, int pn4,
                          int Q, int nc, int nblk) {
  const int bh = blockIdx.x / nblk;
  const int e = (blockIdx.x % nblk) * kStateThreads + threadIdx.x;
  if (e >= pn4) return;
  const long long base = static_cast<long long>(bh) * nc * pn4 + e;
  const float* cl = cum + static_cast<long long>(bh) * S + Q - 1;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 s[4];
    float g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < nc) {
        s[u] = states[base + static_cast<long long>(c0 + u) * pn4];
        g[u] = expf(cl[static_cast<long long>(c0 + u) * Q]);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < nc) {
        put_h(h_in + base + static_cast<long long>(c0 + u) * pn4, h);
        h = make_float4(fmaf(g[u], h.x, s[u].x), fmaf(g[u], h.y, s[u].y),
                        fmaf(g[u], h.z, s[u].z), fmaf(g[u], h.w, s[u].w));
      }
  }
  state_out[static_cast<long long>(bh) * pn4 + e] = h;
}

// ---- bf16: the tensor-core bodies of passes 1 and 3.  b and c one row a
// head (hpg = 1; the wrapper repeats grouped ones).

// `rows` rows of `width` elements (16-byte pieces: 8 bf16 or 4 fp32) from
// global row `row0` of `src` into `dst` (row stride `stride`) by cp.async;
// rows at or past `valid` are zero-filled.
template <int kThreads, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int stride,
                                          const T* __restrict__ src,
                                          long long row0, int width, int rows,
                                          int valid) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = width / kPer;
  for (int e = threadIdx.x; e < rows * pieces; e += kThreads) {
    const int r = e / pieces, k = (e % pieces) * kPer;
    const bool in = r < valid;
    mma::cp_async16(dst + r * stride + k,
                    in ? src + (row0 + r) * width + k : src, in);
  }
}

// copy_rows of the first `width` columns of rows `src_stride` elements
// long.
template <int kThreads, typename T>
__device__ __forceinline__ void copy_cols(T* dst, int stride,
                                          const T* __restrict__ src,
                                          long long row0, int src_stride,
                                          int width, int rows, int valid) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = width / kPer;
  for (int e = threadIdx.x; e < rows * pieces; e += kThreads) {
    const int r = e / pieces, k = (e % pieces) * kPer;
    const bool in = r < valid;
    mma::cp_async16(dst + r * stride + k,
                    in ? src + (row0 + r) * src_stride + k : src, in);
  }
}

// Pass 1.  Eight warps; warp w owns m tile w % (kP / 16) of P and a
// kN / (128 / kP)-column range of N of the (P, N) chunk state.  A operand:
// the decayed xdt tile [q][p] through ldmatrix.trans; B operand: the B
// tile [q][n] through ldmatrix.trans.
template <int kP, int kN>
struct StateShape {
  static constexpr int kWarpsM = kP / 16;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kCols = kN / kWarpsN;  // N columns of a warp
  static size_t bytes(int P, int N) {
    return 2 * kMaxChunk * sizeof(float) + 8 * sizeof(float) +
           kStages * size_t(kTile) * (P + 8 + N + 8) * sizeof(bf16);
  }
};

template <int kP, int kN>
__global__ void __launch_bounds__(kChunkThreads)
    ssd_chunk_state_tc_kernel(const bf16* __restrict__ xdt,
                              const bf16* __restrict__ a,
                              const bf16* __restrict__ b,
                              float* __restrict__ cum_out,
                              float* __restrict__ states, int S, int P, int N,
                              int Q, int nc) {
  using Sh = StateShape<kP, kN>;
  extern __shared__ __align__(16) unsigned char st_smem[];
  float* cum = reinterpret_cast<float*>(st_smem);  // [kMaxChunk]
  float* dec = cum + kMaxChunk;                     // [kMaxChunk]
  float* wsum = dec + kMaxChunk;                    // [8]
  const int PS = P + 8, NS = N + 8;
  // kStages x {x [kTile][PS], b [kTile][NS]}
  bf16* ring = reinterpret_cast<bf16*>(wsum + 8);
  const int slot = kTile * (PS + NS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = blockIdx.x % nc, bh = blockIdx.x / nc;
  const long long r0 = static_cast<long long>(bh) * S +
                       static_cast<long long>(ch) * Q;
  const int ntiles = (Q + kTile - 1) / kTile;
  auto load = [&](int t) {
    if (t >= ntiles) return;
    bf16* xs = ring + (t % kStages) * slot;
    const int j0 = t * kTile, valid = min(kTile, Q - j0);
    copy_rows<kChunkThreads>(xs, PS, xdt, r0 + j0, P, kTile, valid);
    copy_rows<kChunkThreads>(xs + kTile * PS, NS, b, r0 + j0, N, kTile,
                             valid);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    load(t);
    mma::cp_async_commit();
  }

  chunk_cum(a, r0, Q, cum, wsum);
  if (tid < Q) cum_out[r0 + tid] = cum[tid];
  dec[tid] = tid < Q ? expf(cum[Q - 1] - cum[tid]) : 0.f;

  const int mi = warp % Sh::kWarpsM;
  const int n_base = (warp / Sh::kWarpsM) * Sh::kCols;
  const bool active = mi < P / 16;
  float acc[Sh::kCols / 8][4];
#pragma unroll
  for (int j = 0; j < Sh::kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in (and dec written); the slot of tile
                      // t - 1 is free
    load(t + kStages - 1);
    mma::cp_async_commit();
    // Decay the xdt rows in place: fp32 product, one rounding to bf16.
    bf16* xs = ring + (t % kStages) * slot;
    const bf16* bs = xs + kTile * PS;
    const int pieces = P / 8, j0 = t * kTile;
    for (int e = tid; e < kTile * pieces; e += kChunkThreads) {
      const int r = e / pieces, k = (e % pieces) * 8;
      if (j0 + r >= Q) continue;
      uint4* p = reinterpret_cast<uint4*>(xs + r * PS + k);
      uint4 v = *p;
      const float d = dec[j0 + r];
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        w[i] = mma::pack_bf16x2(f.x * d, f.y * d);
      }
      *p = v;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      if (j0 + ks * 16 >= Q) break;  // zero-filled rows
      uint32_t af[4];
      mma::ldmatrix_x4_trans(af, xs + (ks * 16 + lane % 8 + (lane / 16) * 8) *
                                          PS + mi * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < Sh::kCols / 16; ++j) {
        if (n_base + 16 * j >= N) break;
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, bs + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * NS + n_base +
                   16 * j + (lane / 16) * 8);
        mma::mma_bf16(acc[2 * j], af, r[0], r[1]);
        mma::mma_bf16(acc[2 * j + 1], af, r[2], r[3]);
      }
    }
  }
  mma::cp_async_wait<0>();
  if (!active) return;
  float* dst = states + ((static_cast<long long>(bh) * nc + ch) * P + mi * 16 +
                         lane / 4) * N + n_base + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < Sh::kCols / 8; ++j) {
    if (n_base + 8 * j >= N) break;
    *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(dst + 8 * N + 8 * j) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// Pass 3.  Four warps of 16 query rows; the (16, N) C fragments stay in
// registers, the (16, P) output accumulates in fp32.  The ring holds
// kStages slots of one key tile each; the C tile arrives in the last
// slot (read into registers before the key walk refills it), and h_in
// arrives as the walk's last "tile", in the slot after the last key tile,
// so that its copy overlaps the last tile's products.
constexpr int kOutThreads = 128;

inline size_t out_tc_bytes(int P, int N) {
  return kMaxChunk * sizeof(float) +
         kStages * size_t(kTile) * (N + 8 + P + 8) * sizeof(bf16);
}

template <int kP, int kN>
__global__ void __launch_bounds__(kOutThreads)
    ssd_chunk_out_tc_kernel(const bf16* __restrict__ xdt,
                            const bf16* __restrict__ b,
                            const bf16* __restrict__ c,
                            const float* __restrict__ cum,
                            const bf16* __restrict__ h_in,
                            bf16* __restrict__ y, int S, int P, int N, int Q,
                            int nqt, int nc) {
  extern __shared__ __align__(16) unsigned char out_smem[];
  float* cl = reinterpret_cast<float*>(out_smem);  // [kMaxChunk] cum * log2(e)
  const int NS = N + 8, PS = P + 8;
  // kStages x {b [64][NS], x [64][PS]}; h_in [P][NS] fits one slot
  // (P <= 64, or P = 128 >= N).
  bf16* ring = reinterpret_cast<bf16*>(cl + kMaxChunk);
  const int slot = kTile * (NS + PS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int rest = blockIdx.x / nqt;
  const int ch = rest % nc, bh = rest / nc;
  const int i0 = qt * kTile;
  const long long r0 = static_cast<long long>(bh) * S +
                       static_cast<long long>(ch) * Q;
  const int ntiles = qt + 1;  // key tiles 0 .. qt; tile qt is the diagonal
  // Ring entry u: key tile u for u < ntiles, then h_in.
  auto fetch = [&](int u) {
    bf16* bs = ring + (u % kStages) * slot;
    if (u < ntiles) {
      const int j0 = u * kTile, valid = min(kTile, Q - j0);
      copy_rows<kOutThreads>(bs, NS, b, r0 + j0, N, kTile, valid);
      copy_rows<kOutThreads>(bs + kTile * NS, PS, xdt, r0 + j0, P, kTile,
                             valid);
    } else if (u == ntiles) {
      copy_rows<kOutThreads>(
          bs, NS, h_in, (static_cast<long long>(bh) * nc + ch) * P, N, P, P);
    }
  };
  bf16* cs = ring + (kStages - 1) * slot;
  copy_rows<kOutThreads>(cs, NS, c, r0 + i0, N, kTile, Q - i0);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    fetch(u);
    mma::cp_async_commit();
  }
  for (int i = tid; i < i0 + kTile; i += kOutThreads)
    cl[i] = i < Q ? cum[r0 + i] * kLog2e : -INFINITY;
  mma::cp_async_wait<kStages - 2>();
  __syncthreads();

  uint32_t cf[kN / 16][4];
#pragma unroll
  for (int kd = 0; kd < kN / 16; ++kd)
    if (kd < N / 16)
      mma::ldmatrix_x4(cf[kd], cs + (warp * 16 + lane % 16) * NS + kd * 16 +
                                   (lane / 16) * 8);
  const int rg = warp * 16 + lane / 4;  // tile row of d[0..1]; d[2..3] + 8
  const float clr[2] = {cl[i0 + rg], cl[i0 + rg + 8]};

  float o[kP / 8][4];
#pragma unroll
  for (int n = 0; n < kP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0) mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with the slot that
                      // entry t + kStages - 1 fills (tile t - 1, or at
                      // t = 0 the C tile)
    fetch(t + kStages - 1);
    mma::cp_async_commit();
    const bf16* bs = ring + (t % kStages) * slot;
    const bf16* xs = bs + kTile * NS;

    // S = C B^T over the tile's 64 keys.
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < kN / 16; ++kd) {
      if (kd >= N / 16) break;
#pragma unroll
      for (int j2 = 0; j2 < kTile / 16; ++j2) {
        uint32_t r[4];
        mma::ldmatrix_x4(r, bs + (j2 * 16 + lane % 8 + (lane / 16) * 8) * NS +
                                kd * 16 + ((lane / 8) % 2) * 8);
        mma::mma_bf16(s[2 * j2], cf[kd], r[0], r[1]);
        mma::mma_bf16(s[2 * j2 + 1], cf[kd], r[2], r[3]);
      }
    }

    // Decay, and on the diagonal tile the causal mask (rows past the chunk
    // too: their cl is -inf).
    const int key0 = t * kTile;
    const bool diag = t == qt;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * (lane % 4) + (e % 2);
        const int row = i0 + rg + 8 * (e / 2);
        const float d = mma::fast_exp2(clr[e / 2] - cl[key]);
        s[j][e] = diag && (key > row || row >= Q) ? 0.f : s[j][e] * d;
      }

    // o += bf16(S) @ xdt: the score registers of two 8-key tiles are the A
    // fragments, xdt rows through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t af[4] = {mma::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kP / 16; ++n2) {
        if (n2 >= P / 16) break;
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            r, xs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * PS + n2 * 16 +
                   (lane / 16) * 8);
        mma::mma_bf16(o[2 * n2], af, r[0], r[1]);
        mma::mma_bf16(o[2 * n2 + 1], af, r[2], r[3]);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // h_in is in

  // Inter-chunk: o += exp(cum_i) (C h_in^T); h_in rows are the B
  // operand's columns, read as K rows are in flash_tile.cuh.
  const bf16* hs = ring + (ntiles % kStages) * slot;
  const float g0 = mma::fast_exp2(clr[0]), g1 = mma::fast_exp2(clr[1]);
#pragma unroll
  for (int j2 = 0; j2 < kP / 16; ++j2) {
    if (j2 >= P / 16) break;
    float oi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kd = 0; kd < kN / 16; ++kd) {
      if (kd >= N / 16) break;
      uint32_t r[4];
      mma::ldmatrix_x4(r, hs + (j2 * 16 + lane % 8 + (lane / 16) * 8) * NS +
                              kd * 16 + ((lane / 8) % 2) * 8);
      mma::mma_bf16(oi[0], cf[kd], r[0], r[1]);
      mma::mma_bf16(oi[1], cf[kd], r[2], r[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[2 * j2 + h][0] = fmaf(g0, oi[h][0], o[2 * j2 + h][0]);
      o[2 * j2 + h][1] = fmaf(g0, oi[h][1], o[2 * j2 + h][1]);
      o[2 * j2 + h][2] = fmaf(g1, oi[h][2], o[2 * j2 + h][2]);
      o[2 * j2 + h][3] = fmaf(g1, oi[h][3], o[2 * j2 + h][3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + rg + 8 * i;
    if (row >= Q) continue;
    bf16* dst = y + (r0 + row) * P + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kP / 8; ++n) {
      if (n >= P / 8) break;
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          mma::pack_bf16x2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}


// ---- fp32: 3xTF32 bodies of pass 1, the score pass and pass 3.
//
// Every product of an fp32 call runs on the tensor cores in 3xTF32
// (mma.cuh): a warp holds the split A fragments of a slice of its rows,
// and each 8-column output tile sums its slice's products in registers of
// its own before they are added to the warp's fp32 sums, so the tensor
// cores' chained sums stay at most 24 products deep.  Operands reach the
// fragments from shared memory by 32-bit loads (pass 3's scores from L2,
// stored in fragment order): a tile stored with its contraction index
// along the row (C, B and h_in rows) takes a row stride of 4 mod 32
// floats, one stored with it down the columns (xdt, B in pass 1) a stride
// of 8 mod 32; both read without bank conflicts.  An operand that every
// warp reads (the xdt tile of pass 3, the B tile of pass 1) is split once
// a block into its high parts and a plane of residuals.
constexpr int kStateKeys = 32;  // key rows of a pass-1 tile
constexpr int kStateStages = 3;  // pass 1's ring: two tiles in flight

// The split A fragments of one 16 x 8 slice, and the two B values of one
// 8 x 8 output tile of a slice ((k t, n g) and (k t + 4, n g)).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1,
                                        float a2, float a3) {
  mma::split_tf32(a0, f.hi[0], f.lo[0]);
  mma::split_tf32(a1, f.hi[1], f.lo[1]);
  mma::split_tf32(a2, f.hi[2], f.lo[2]);
  mma::split_tf32(a3, f.hi[3], f.lo[3]);
}

// A fragments of `kSteps` slices of 8 columns of a 16-row operand whose
// element (m, k) is `elem(m, k)`, m < 16, k < 8 kSteps.
template <int kSteps, typename Elem>
__device__ __forceinline__ void load_a(FragA (&f)[kSteps], Elem elem) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    split_a(f[s], elem(g, 8 * s + t), elem(g + 8, 8 * s + t),
            elem(g, 8 * s + t + 4), elem(g + 8, 8 * s + t + 4));
}

// B values of a slice pre-split in shared memory: the high parts over the
// tile, the residuals in a plane of the same layout; element (k, n) at
// k * stride + n of each.
struct SplitB {
  const float* hi;
  const float* lo;
  int stride;
  __device__ __forceinline__ void operator()(int k, int n, FragB& b) const {
    const int lane = threadIdx.x % 32;
    const int i0 = (k + lane % 4) * stride + n + lane / 4;
    const int i1 = i0 + 4 * stride;
    b.hi[0] = __float_as_uint(hi[i0]);
    b.hi[1] = __float_as_uint(hi[i1]);
    b.lo[0] = __float_as_uint(lo[i0]);
    b.lo[1] = __float_as_uint(lo[i1]);
  }
};

// o[j] += A @ B[:, 8j, 8j + 8) for the output tiles j < `tiles` (of
// kTiles), A the 16 x 8 kSteps operand of `a`; `load_b(k0, n0, b)` gives
// the B values of the slice at depth k0 and tile column n0.  Four tiles at
// a time (more cost pass 1 its second block an SM), each summed over the
// slices in registers of its own (the tensor cores' chained sums stay 3
// kSteps products deep), then added to o[j]; a slice's three products are
// issued tile after tile, so that consecutive mma are independent.
template <int kSteps, int kTiles, typename LoadB>
__device__ __forceinline__ void product_3xtf32(float (&o)[kTiles][4],
                                               const FragA (&a)[kSteps],
                                               int tiles, LoadB load_b) {
  constexpr int kGroup = kTiles < 4 ? kTiles : 4;
#pragma unroll
  for (int j0 = 0; j0 < kTiles; j0 += kGroup) {
    if (j0 >= tiles) break;
    float d[kGroup][4];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      FragB b[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j0 + j < tiles) load_b(8 * s, 8 * (j0 + j), b[j]);
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j0 + j < tiles) mma::mma_tf32(d[j], a[s].lo, b[j].hi[0], b[j].hi[1]);
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j0 + j < tiles) mma::mma_tf32(d[j], a[s].hi, b[j].lo[0], b[j].lo[1]);
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j0 + j < tiles) mma::mma_tf32(d[j], a[s].hi, b[j].hi[0], b[j].hi[1]);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (j0 + j < tiles)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j0 + j][e] += d[j][e];
  }
}

// Split `rows` x `width` fp32 of `tile` (row stride `stride`, 16-byte
// aligned) in place into their high parts, the residuals into `lo` (same
// layout), 4 elements a thread at a time.
template <int kThreads>
__device__ __forceinline__ void split_tile(float* tile, float* lo, int stride,
                                           int rows, int width) {
  const int pieces = width / 4;
  for (int e = threadIdx.x; e < rows * pieces; e += kThreads) {
    const int at = (e / pieces) * stride + (e % pieces) * 4;
    float4 v = *reinterpret_cast<float4*>(tile + at);
    uint32_t h[4], l[4];
    mma::split_tf32(v.x, h[0], l[0]);
    mma::split_tf32(v.y, h[1], l[1]);
    mma::split_tf32(v.z, h[2], l[2]);
    mma::split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(tile + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Pass 1 and the score pass share one launch.  A pass-1 block (bh, chunk)
// has eight warps; warp w owns m tile w % (kP / 16) of P and a
// kN / (128 / kP)-column range of N of the (P, N) chunk state, summed over
// kStateKeys-row key tiles of a 3-stage cp.async ring (the chunk's xdt
// comes from device memory: two tiles stay in flight); each arriving B
// tile is split once for every warp.  A score block (group row, chunk,
// tile pair qt >= kt) forms the 64 x 64 tile of C B^T; warp w owns its
// rows 16 (w % 4).. and key columns 32 (w / 4)...
template <int kP, int kN>
struct Tf32StateShape {
  static constexpr int kWarpsM = kP / 16;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kCols = kN / kWarpsN;
  static size_t bytes(int P, int N) {
    // cum, dec [kMaxChunk], wsum [8], kStateStages x {x [32][P + 8],
    // b [32][N + 8]}, b's residuals [32][N + 8]; a score block's c and b
    // [64][N + 4].
    const size_t state = 2 * kMaxChunk + 8 +
                         size_t(kStateStages) * kStateKeys * (P + 8 + N + 8) +
                         size_t(kStateKeys) * (N + 8);
    const size_t score = 2 * size_t(kTile) * (N + 4);
    return (state > score ? state : score) * sizeof(float);
  }
};

// The score pass's block `blk`: tile pair p = qt (qt + 1) / 2 + kt of
// chunk ch of group row gr, written at tile p of that (gr, ch)'s scores in
// the fragment order pass 3 reads: element (r, c) of the tile at
// ((r / 16) * 8 + c / 8) * 128 + 4 lane + e, lane = 4 (r % 8) + c % 4,
// e = (r % 16) / 8 + 2 ((c % 8) / 4) (mma.cuh's A layout).
__device__ __forceinline__ void score_tile(const float* __restrict__ b,
                                           const float* __restrict__ c,
                                           float* __restrict__ scores,
                                           float* smem, int S, int N, int Q,
                                           int nc, int nqt, int blk) {
  const int npairs = nqt * (nqt + 1) / 2;
  const int pair = blk % npairs, rest = blk / npairs;
  const int ch = rest % nc, gr = rest / nc;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pair) ++qt;
  const int kt = pair - qt * (qt + 1) / 2;
  const int NS = N + 4;
  float* cs = smem;
  float* bs = cs + kTile * NS;
  const long long r0 = static_cast<long long>(gr) * S +
                       static_cast<long long>(ch) * Q;
  copy_rows<kChunkThreads>(cs, NS, c, r0 + qt * kTile, N, kTile,
                           Q - qt * kTile);
  copy_rows<kChunkThreads>(bs, NS, b, r0 + kt * kTile, N, kTile,
                           Q - kt * kTile);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const float* cw = cs + (warp % 4) * 16 * NS;
  const float* bw = bs + (warp / 4) * 32 * NS;
  float o[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += 16) {
    FragA f[2];
    load_a<2>(f, [&](int m, int k) { return cw[m * NS + k0 + k]; });
    product_3xtf32<2, 4>(o, f, 4, [&](int k, int n, FragB& v) {
      const float* p = bw + (n + g) * NS + k0 + k + t;
      mma::split_tf32(p[0], v.hi[0], v.lo[0]);
      mma::split_tf32(p[4], v.hi[1], v.lo[1]);
    });
  }
  float* dst = scores +
               ((static_cast<long long>(gr) * nc + ch) * npairs + pair) *
                   kTile * kTile +
               ((warp % 4) * 8 + (warp / 4) * 4) * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 2 * t + (e & 1);  // column within the 8-column step
      dst[j * 128 + 4 * (4 * g + kk % 4) + e / 2 + 2 * (kk / 4)] = o[j][e];
    }
}

// Blocks [0, n_state) are pass 1's (bh, chunk); the rest the score pass's.
// With one chunk `states` is the final state itself.  Two blocks an SM
// (the registers capped at 128).
template <int kP, int kN>
__global__ void __launch_bounds__(kChunkThreads, 2)
    ssd_chunk_state_tf32_kernel(const float* __restrict__ xdt,
                                const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ c,
                                float* __restrict__ cum_out,
                                float* __restrict__ states,
                                float* __restrict__ scores, int S, int P,
                                int N, int Q, int nc, int nqt, int hpg,
                                int n_state) {
  using Sh = Tf32StateShape<kP, kN>;
  extern __shared__ __align__(16) float sf_smem[];
  if (static_cast<int>(blockIdx.x) >= n_state) {
    score_tile(b, c, scores, sf_smem, S, N, Q, nc, nqt,
               blockIdx.x - n_state);
    return;
  }
  float* cum = sf_smem;             // [kMaxChunk]
  float* dec = cum + kMaxChunk;     // [kMaxChunk]
  float* wsum = dec + kMaxChunk;    // [8]
  float* ring = wsum + 8;  // kStateStages x {x [32][PS], b [32][NS]}
  const int PS = P + 8, NS = N + 8;
  const int slot = kStateKeys * (PS + NS);
  float* b_lo = ring + kStateStages * slot;  // [32][NS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = blockIdx.x % nc, bh = blockIdx.x / nc;
  const long long r0 = static_cast<long long>(bh) * S +
                       static_cast<long long>(ch) * Q;
  const long long rb = static_cast<long long>(bh / hpg) * S +
                       static_cast<long long>(ch) * Q;
  const int ntiles = (Q + kStateKeys - 1) / kStateKeys;
  auto load = [&](int t) {
    if (t >= ntiles) return;
    float* xs = ring + (t % kStateStages) * slot;
    const int j0 = t * kStateKeys, valid = min(kStateKeys, Q - j0);
    copy_rows<kChunkThreads>(xs, PS, xdt, r0 + j0, P, kStateKeys, valid);
    copy_rows<kChunkThreads>(xs + kStateKeys * PS, NS, b, rb + j0, N,
                             kStateKeys, valid);
  };
#pragma unroll
  for (int t = 0; t < kStateStages - 1; ++t) {
    load(t);
    mma::cp_async_commit();
  }

  chunk_cum(a, r0, Q, cum, wsum);
  if (tid < Q) cum_out[r0 + tid] = cum[tid];
  dec[tid] = tid < Q ? expf(cum[Q - 1] - cum[tid]) : 0.f;

  const int mi = warp % Sh::kWarpsM;
  const int n_base = (warp / Sh::kWarpsM) * Sh::kCols;
  const bool active = mi < P / 16 && n_base < N;
  const int tiles = min(Sh::kCols, N - n_base) / 8;
  float acc[Sh::kCols / 8][4];
#pragma unroll
  for (int j = 0; j < Sh::kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    mma::cp_async_wait<kStateStages - 2>();
    __syncthreads();  // tile t is in (and dec written); tile t - 1's slot
                      // and b_lo are free
    load(t + kStateStages - 1);
    mma::cp_async_commit();
    float* xs = ring + (t % kStateStages) * slot;
    float* bs = xs + kStateKeys * PS;
    split_tile<kChunkThreads>(bs, b_lo, NS, kStateKeys, N);
    __syncthreads();  // the B tile is split
    if (!active) continue;
    const float* dj = dec + t * kStateKeys;
    // A (p, q) = xdt[q][p] exp(cum_last - cum_q), decayed in fp32.
    FragA f[kStateKeys / 8];
    load_a<kStateKeys / 8>(
        f, [&](int m, int k) { return xs[k * PS + mi * 16 + m] * dj[k]; });
    product_3xtf32<kStateKeys / 8, Sh::kCols / 8>(
        acc, f, tiles, SplitB{bs + n_base, b_lo + n_base, NS});
  }
  if (!active) return;
  float* dst = states + ((static_cast<long long>(bh) * nc + ch) * P + mi * 16 +
                         lane / 4) * N + n_base + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < Sh::kCols / 8; ++j) {
    if (j >= tiles) break;
    *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(dst + 8 * N + 8 * j) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// Pass 3: one block per (bh, chunk, 64-row query tile), heaviest first;
// four warps of 16 query rows, the (16, P) output summed in fp32.  The
// inter-chunk term first (chunks after the first): C of the group row and
// h_in, 64 columns of N at a time ([.][68] in the walk's space), o =
// exp(cum_i) (C h_in^T).
// Then the key tiles kt <= qt: the xdt rows [64][P + 8] through a 2-stage
// cp.async ring, each split once for the four warps on arrival; the score
// tile of the group row read by each warp in fragment order (16-byte
// loads, L2), every score decayed by this head's exp(cum_i - cum_j)
// (masked on the diagonal tile) as its fragment is formed.
constexpr int kInterCols = 64;  // N columns of a C h_in^T slice

inline size_t out_tf32_bytes(int P) {
  const size_t walk = size_t(kStages + 1) * kTile * (P + 8);
  const size_t inter = size_t(kTile + P) * (kInterCols + 4);
  return (kMaxChunk + (walk > inter ? walk : inter)) * sizeof(float);
}

// At P <= 64 three blocks an SM (the registers capped at 168).
template <int kP>
__global__ void __launch_bounds__(kOutThreads, kP == 64 ? 3 : 1)
    ssd_chunk_out_tf32_kernel(const float* __restrict__ xdt,
                              const float* __restrict__ c,
                              const float* __restrict__ cum,
                              const float* __restrict__ h_in,
                              const float* __restrict__ scores,
                              float* __restrict__ y, int S, int P, int N,
                              int Q, int nqt, int nc, int hpg) {
  extern __shared__ __align__(16) float of_smem[];
  float* cl = of_smem;            // [kMaxChunk] cum
  float* ring = cl + kMaxChunk;   // kStages x xdt [64][XS], then residuals
  const int XS = P + 8, NS = kInterCols + 4;
  const int slot = kTile * XS;
  float* x_lo = ring + kStages * slot;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int rest = blockIdx.x / nqt;
  const int ch = rest % nc, bh = rest / nc, gr = bh / hpg;
  const int i0 = qt * kTile;
  const long long r0 = static_cast<long long>(bh) * S +
                       static_cast<long long>(ch) * Q;
  const int npairs = nqt * (nqt + 1) / 2;
  // Tile (qt, kt)'s 16-byte pieces at sf + kt * 1024; this warp's at
  // + (warp * 8 + step) * 32 + lane.
  const float4* sf = reinterpret_cast<const float4*>(scores) +
                     ((static_cast<long long>(gr) * nc + ch) * npairs +
                      qt * (qt + 1) / 2) * (kTile * kTile / 4) +
                     warp * 8 * 32 + lane;
  const int ntiles = qt + 1;
  const int tiles = P / 8;
  for (int i = tid; i < i0 + kTile; i += kOutThreads)
    cl[i] = i < Q ? cum[r0 + i] : 0.f;

  float o[kP / 8][4];
#pragma unroll
  for (int j = 0; j < kP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (ch > 0) {  // chunk 0 enters with a zero state
    float* cs = ring;              // [64][NS]
    float* hs = ring + kTile * NS;  // [P][NS]
    const float* cw = cs + warp * 16 * NS;
    for (int n0 = 0; n0 < N; n0 += kInterCols) {
      const int w = min(kInterCols, N - n0);
      if (n0 > 0) __syncthreads();  // every warp is done with the last slice
      copy_cols<kOutThreads>(cs, NS, c + n0,
                             static_cast<long long>(gr) * S +
                                 static_cast<long long>(ch) * Q + i0,
                             N, w, kTile, Q - i0);
      copy_cols<kOutThreads>(
          hs, NS, h_in + (static_cast<long long>(bh) * nc + ch) * P * N + n0,
          0, N, w, P, P);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();  // the slices (and cl) are in
      for (int k0 = 0; k0 < w; k0 += 16) {
        FragA f[2];
        load_a<2>(f, [&](int m, int k) { return cw[m * NS + k0 + k]; });
        product_3xtf32<2, kP / 8>(o, f, tiles, [&](int k, int n, FragB& v) {
          const float* p = hs + (n + g) * NS + k0 + k + t4;
          mma::split_tf32(p[0], v.hi[0], v.lo[0]);
          mma::split_tf32(p[4], v.hi[1], v.lo[1]);
        });
      }
    }
    const float e0 = expf(cl[i0 + warp * 16 + g]);
    const float e1 = expf(cl[i0 + warp * 16 + g + 8]);
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      o[j][0] *= e0;
      o[j][1] *= e0;
      o[j][2] *= e1;
      o[j][3] *= e1;
    }
  }

  auto fetch = [&](int u) {
    if (u >= ntiles) return;
    const int j0 = u * kTile;
    copy_rows<kOutThreads>(ring + (u % kStages) * slot, XS, xdt, r0 + j0, P,
                           kTile, min(kTile, Q - j0));
  };
  __syncthreads();  // every warp is done with C and h_in (and cl is in)
  fetch(0);
  mma::cp_async_commit();
  const int rw = i0 + warp * 16;  // the warp's first query row
  const float cli[2] = {cl[rw + g], cl[rw + g + 8]};
  for (int u = 0; u < ntiles; ++u) {
    // This tile's score fragments (half of them at a time), ahead of the
    // split of its xdt rows.
    float4 v[kTile / 16];
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s) v[s] = __ldg(sf + u * 1024 + s * 32);
    mma::cp_async_wait<0>();
    __syncthreads();  // tile u is in; the other slot, tile u - 1's, and
                      // the residual plane are free
    fetch(u + 1);
    mma::cp_async_commit();
    float* xs = ring + (u % kStages) * slot;
    split_tile<kOutThreads>(xs, x_lo, XS, kTile, P);
    __syncthreads();  // the xdt tile is split
    const int j0 = u * kTile;
    const bool diag = u == qt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      FragA f[kTile / 16];
#pragma unroll
      for (int s = 0; s < kTile / 16; ++s) {
        const int ja = j0 + 8 * (4 * half + s) + t4;  // keys ja, ja + 4
        const float in[4] = {v[s].x, v[s].y, v[s].z, v[s].w};
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rw + g + 8 * (e % 2), j = ja + 4 * (e / 2);
          w[e] = i >= Q || (diag && j > i)
                     ? 0.f
                     : in[e] * mma::fast_exp2((cli[e % 2] - cl[j]) * kLog2e);
        }
        split_a(f[s], w[0], w[1], w[2], w[3]);
      }
      if (half == 0) {
#pragma unroll
        for (int s = 0; s < kTile / 16; ++s)
          v[s] = __ldg(sf + u * 1024 + (s + kTile / 16) * 32);
      }
      product_3xtf32<kTile / 16, kP / 8>(
          o, f, tiles,
          SplitB{xs + half * (kTile / 2) * XS,
                 x_lo + half * (kTile / 2) * XS, XS});
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw + g + 8 * h;
    if (row >= Q) continue;
    float* dst = y + (r0 + row) * P + 2 * t4;
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      if (j >= tiles) break;
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[j][2 * h], o[j][2 * h + 1]);
    }
  }
}

// ---- launches.

struct Args {
  const void *xdt, *a, *b, *c;
  void* y;
  float *state, *ws;
  int BH, S, P, N, Q, hpg;
  bool half;  // bf16 inputs
  cudaStream_t stream;
  int nc() const { return S / Q; }
  int nqt() const { return (Q + kTile - 1) / kTile; }
  int npairs() const { return nqt() * (nqt() + 1) / 2; }
  // The workspace (ssd_scan.ssd_plan): the chunk states (none for fp32
  // inputs in one chunk, where pass 1 writes the final state), cum
  // rounded up to 4 floats, then for bf16 inputs h_in in bf16, for fp32
  // ones the score tiles; each part 16-byte aligned.
  long long n_states() const {
    return !half && nc() == 1 ? 0
                              : static_cast<long long>(BH) * nc() * P * N;
  }
  float* states() const { return ws; }
  float* cum() const { return ws + n_states(); }
  float* tail() const {
    return cum() + (static_cast<long long>(BH) * S + 3) / 4 * 4;
  }
  bf16* h_in16() const { return reinterpret_cast<bf16*>(tail()); }
  float* scores() const { return tail(); }
};

template <typename H>
int launch_state_pass(const Args& g, H* h_in) {
  const int pn4 = g.P * g.N / 4;
  const int nblk = (pn4 + kStateThreads - 1) / kStateThreads;
  ssd_state_pass_kernel<H><<<g.BH * nblk, kStateThreads, 0, g.stream>>>(
      reinterpret_cast<const float4*>(g.states()), h_in, g.cum(),
      reinterpret_cast<float4*>(g.state), g.S, pn4, g.Q, g.nc(), nblk);
  return static_cast<int>(cudaGetLastError());
}

template <int kP, int kN>
int launch_tc(const Args& g) {
  static bool set1 = false, set3 = false;
  cudaError_t err = allow_smem(ssd_chunk_state_tc_kernel<kP, kN>,
                               StateShape<kP, kN>::bytes(kP, kN), set1);
  if (err == cudaSuccess)
    err = allow_smem(ssd_chunk_out_tc_kernel<kP, kN>, out_tc_bytes(kP, kN),
                     set3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* xdt = static_cast<const bf16*>(g.xdt);
  const bf16* b = static_cast<const bf16*>(g.b);
  ssd_chunk_state_tc_kernel<kP, kN>
      <<<g.BH * g.nc(), kChunkThreads, StateShape<kP, kN>::bytes(g.P, g.N),
         g.stream>>>(xdt, static_cast<const bf16*>(g.a), b, g.cum(),
                     g.states(), g.S, g.P, g.N, g.Q, g.nc());
  int code = static_cast<int>(cudaGetLastError());
  if (code) return code;
  code = launch_state_pass(g, reinterpret_cast<uint2*>(g.h_in16()));
  if (code) return code;
  ssd_chunk_out_tc_kernel<kP, kN>
      <<<g.BH * g.nc() * g.nqt(), kOutThreads, out_tc_bytes(g.P, g.N),
         g.stream>>>(xdt, b, static_cast<const bf16*>(g.c), g.cum(),
                     g.h_in16(), static_cast<bf16*>(g.y), g.S, g.P, g.N, g.Q,
                     g.nqt(), g.nc());
  return static_cast<int>(cudaGetLastError());
}

// fp32: pass 1 with the score pass, the state pass (more than one chunk),
// pass 3.
template <int kP, int kN>
int launch_tf32(const Args& g) {
  using Sh = Tf32StateShape<kP, kN>;
  static bool set1 = false, set3 = false;
  cudaError_t err = allow_smem(ssd_chunk_state_tf32_kernel<kP, kN>,
                               Sh::bytes(kP, kN), set1);
  if (err == cudaSuccess)
    err = allow_smem(ssd_chunk_out_tf32_kernel<kP>, out_tf32_bytes(kP), set3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xdt = static_cast<const float*>(g.xdt);
  const float* b = static_cast<const float*>(g.b);
  const float* c = static_cast<const float*>(g.c);
  const int nc = g.nc(), n_state = g.BH * nc;
  const int n_score = g.BH / g.hpg * nc * g.npairs();
  ssd_chunk_state_tf32_kernel<kP, kN>
      <<<n_state + n_score, kChunkThreads, Sh::bytes(g.P, g.N), g.stream>>>(
          xdt, static_cast<const float*>(g.a), b, c, g.cum(),
          nc == 1 ? g.state : g.states(), g.scores(), g.S, g.P, g.N, g.Q, nc,
          g.nqt(), g.hpg, n_state);
  int code = static_cast<int>(cudaGetLastError());
  if (code) return code;
  if (nc > 1) {
    code = launch_state_pass(g, reinterpret_cast<float4*>(g.states()));
    if (code) return code;
  }
  ssd_chunk_out_tf32_kernel<kP>
      <<<g.BH * nc * g.nqt(), kOutThreads, out_tf32_bytes(g.P), g.stream>>>(
          xdt, c, g.cum(), g.states(), g.scores(), static_cast<float*>(g.y),
          g.S, g.P, g.N, g.Q, g.nqt(), nc, g.hpg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// xdt, y: (BH, S, P); a: (BH, S); b, c: (BH / hpg, S, N), row bh reading
// b and c row bh / hpg (its group); all fp32 (bf16 = 0) or all bf16; xdt,
// b and c 16-byte aligned (cp.async); state: (BH, P, N) fp32; ws: the
// fp32 workspace of ssd_scan.ssd_plan (Args).  P and N multiples of 16 up
// to 128, chunk up to 256 dividing S, hpg dividing BH (bf16: hpg 1).
// bf16: three launches; fp32: three, two in one chunk; on `stream`.  Returns the
// first cudaError_t code that is not 0.
extern "C" int repro_ssd_scan(const void* xdt, const void* a, const void* b,
                              const void* c, void* y, float* state, float* ws,
                              int BH, int S, int P, int N, int chunk, int bf16,
                              int hpg, void* stream) {
  using namespace repro_torch;
  if (BH <= 0 || S <= 0 || chunk <= 0 || chunk > kMaxChunk || S % chunk ||
      P <= 0 || P > kMaxPN || P % 16 || N <= 0 || N > kMaxPN || N % 16 ||
      hpg <= 0 || BH % hpg || (bf16 && hpg != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{xdt, a, b, c, y, state, ws, BH, S, P, N, chunk, hpg, bf16 != 0,
               static_cast<cudaStream_t>(stream)};
  if (!bf16) {
    if (P <= 64 && N <= 64) return launch_tf32<64, 64>(g);
    if (P <= 64) return launch_tf32<64, 128>(g);
    if (N <= 64) return launch_tf32<128, 64>(g);
    return launch_tf32<128, 128>(g);
  }
  if (P <= 64 && N <= 64) return launch_tc<64, 64>(g);
  if (P <= 64) return launch_tc<64, 128>(g);
  if (N <= 64) return launch_tc<128, 64>(g);
  return launch_tc<128, 128>(g);
}
