// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan/ssd_scan.py.  Inputs, pre-scaled by the caller:
// xdt (BH, S, P), a (BH, S), b and c (BH, S, N), all fp32 or all bf16.
// Outputs: y (BH, S, P) in the inputs' type and the final state (BH, P, N)
// fp32.  Per chunk of Q positions, with cum the inclusive cumsum of a over
// the chunk:
//   y     = ((C B^T) . L) xdt + exp(cum) . (C h_in^T),  L_ij = exp(cum_i - cum_j), i >= j
//   h_out = exp(cum_last) h_in + (xdt . exp(cum_last - cum))^T B
//
// Bound on this card.  The work reads xdt, a, b, c and writes y and the
// state once; the chunked form does about Q/2 * (2N + 2P) + 4PN operations a
// position.  At mamba2-1.3b's widths (64 heads, P = 64, N = 128, 2048
// positions, chunk 256, bf16) that is 103 MB and 10.8 GFLOP: 0.0308 ms at
// 3.35 TB/s, bytes-bound (chip_smoke.py's check_ssd).
//
// Design: the SSD paper's chunked algorithm (arXiv:2405.21060 §6) in three
// launches, in place of the TPU's sequential chunk axis and its VMEM state.
// A chunk's own contribution to the state depends only on its inputs, so
// only a short scan over chunks is serial.  The wrapper allocates an fp32
// workspace (ssd_scan.ssd_plan): chunk states (BH, nc, P, N), cum (BH, S)
// and, for bf16 inputs, h_in (BH, nc, P, N) in bf16.
//   1. Chunk states, one block per (bh, chunk) (512 blocks at the widths
//      above): cum by a block scan in fp32, written to the workspace (pass
//      3 reads it and never recomputes it); s_c = (xdt . exp(cum_last -
//      cum))^T B, a (P x Q) (Q x N) product, into the chunk states.
//   2. State pass, one thread per 4 state entries of a bh: walks the
//      chunks in order, h_in[c] = h, h = exp(cum_last[c]) h + s_c, in fp32
//      FMAs with no atomics; the last h is the final state.
//   3. Chunk outputs, one block per (bh, chunk, 64-row query tile) (2048
//      blocks), each chunk's heaviest query tile first: the key tiles
//      j0 <= i0 of ((C B^T) . L) xdt, then exp(cum_i) (C h_in^T).  L is
//      taken only where i >= j, so exp never sees a positive argument,
//      and element by element only on the diagonal tile.
// bf16 inputs run passes 1 and 3 on the tensor cores (mma.cuh: mma.sync
// m16n8k16, fp32 sums), their tiles fed by a 2-stage 16-byte cp.async ring
// and read through ldmatrix (rows padded by 16 bytes: no bank conflicts).
// A pass-3 block holds its C tile's fragments in registers for the whole
// key walk; the C tile arrives in the ring's second slot before the second
// key tile does, and h_in arrives as the walk's last entry, in the slot
// after the last key tile, so its copy overlaps that tile's products and
// needs no shared memory of its own (4 blocks an SM at the widths above).
// Rounding points, each once to nearest-even bf16: the decayed xdt of pass
// 1 (xdt . exp(cum_last - cum) in fp32, rounded in shared memory before
// the product); h_in, which pass 2 writes in bf16 beside the fp32 chain so
// that pass 3 multiplies C h_in^T on the tensor cores (in fp32 on the CUDA
// cores that product alone would take ~2 GFLOP at the widths above); the
// decayed, masked scores, fed back from registers as the A operand of
// scores @ xdt.  The chunk states, the carried h and the final state stay
// fp32.  Pass 3 takes exp in base 2 on the special-function unit, cum
// scaled by log2(e) once.
// fp32 inputs keep exact fp32 arithmetic (the tests hold them to 1e-4,
// which TF32 or bf16 products would not meet): the same three passes, with
// passes 1 and 3 multiplying from shared memory in fp32 FMAs (a 16 x 16
// thread grid owning register blocks; row strides of N + 1), h_in
// overwriting the chunk states in place.
//
// Predicted before the design was first timed (PERF.md): 0.07-0.20 ms at
// the widths above (the three passes move ~190 MB with the workspace),
// 0.08-0.25 ms at chunk 128, 0.06-0.20 ms at zamba2-7b's widths (112
// heads of 64, N = 64); target at most 5x the bound.  Measured by
// chip_smoke.py on an H100 (80GB HBM3, 700 W): 0.1149 / 0.1127 / 0.1291
// ms, 3.6-3.7x the bound.  Pass 3 is ~2/3 of it.  With its products and exp
// taken out it kept ~88% of its time at mamba2's widths (moving its tiles
// bounds it there) but ~76% at zamba2's, where the scores @ xdt products
// alone are ~1/5 of it.  Deeper rings, two query tiles a block and capped
// registers were each slower.
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

// ---- bf16: the tensor-core bodies of passes 1 and 3.

// `rows` rows of `width` bf16 (width / 8 16-byte pieces) from global row
// `row0` of `src` into `dst` (row stride `stride`) by cp.async; rows at or
// past `valid` are zero-filled.
template <int kThreads>
__device__ __forceinline__ void copy_rows(bf16* dst, int stride,
                                          const bf16* __restrict__ src,
                                          long long row0, int width, int rows,
                                          int valid) {
  const int pieces = width / 8;
  for (int e = threadIdx.x; e < rows * pieces; e += kThreads) {
    const int r = e / pieces, k = (e % pieces) * 8;
    const bool in = r < valid;
    mma::cp_async16(dst + r * stride + k,
                    in ? src + (row0 + r) * width + k : src, in);
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

// ---- fp32: the exact bodies of passes 1 and 3, on the CUDA cores.
constexpr int kThreads = 256;
constexpr int kMaxPer = kMaxPN / 16;
constexpr int kScStride = kTile + 1;

// Rows [0, n) of a (rows, width) slice of `src` starting at element `off`
// into `dst` (row stride `stride`); each element times `scale(row)`.
template <typename Scale>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* __restrict__ src,
                                          long long off, int n, int width,
                                          Scale scale) {
  for (int e = threadIdx.x; e < n * width; e += kThreads) {
    const int i = e / width, k = e % width;
    dst[i * stride + k] = src[off + e] * scale(i);
  }
}

// Pass 1: thread (hi, lo) of a 16 x 16 grid owns state entries
// p = hi + 16 r, n = lo + 16 q.
inline size_t state_exact_floats(int P, int N) {
  return kMaxChunk + 8 + size_t(kTile) * (N + 1) + size_t(kTile) * P;
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const float* __restrict__ xdt,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ cum_out,
                           float* __restrict__ states, int S, int P, int N,
                           int Q, int nc) {
  extern __shared__ __align__(16) float sx_smem[];
  float* cum = sx_smem;         // [kMaxChunk]
  float* wsum = cum + kMaxChunk;  // [8]
  float* bt = wsum + 8;         // [kTile][N + 1]
  float* xt = bt + kTile * (N + 1);  // [kTile][P]
  const int tid = threadIdx.x, hi = tid / 16, lo = tid % 16;
  const int np = P / 16, nn = N / 16, Ns = N + 1;
  const int ch = blockIdx.x % nc, bh = blockIdx.x / nc;
  const long long r0 = static_cast<long long>(bh) * S +
                       static_cast<long long>(ch) * Q;
  chunk_cum(a, r0, Q, cum, wsum);
  if (tid < Q) cum_out[r0 + tid] = cum[tid];
  const float c_last = cum[Q - 1];
  auto one = [](int) { return 1.f; };

  float st[kMaxPer][kMaxPer];
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r)
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q) st[r][q] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    const int nk = min(kTile, Q - j0);
    if (j0 > 0) __syncthreads();  // the previous key tile is consumed
    load_rows(bt, Ns, b, (r0 + j0) * N, nk, N, one);
    const float* cj = cum + j0;
    load_rows(xt, P, xdt, (r0 + j0) * P, nk, P,
              [=](int j) { return expf(c_last - cj[j]); });
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float xv[kMaxPer], bv[kMaxPer];
#pragma unroll
      for (int r = 0; r < kMaxPer; ++r)
        xv[r] = r < np ? xt[j * P + hi + 16 * r] : 0.f;
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q)
        bv[q] = q < nn ? bt[j * Ns + lo + 16 * q] : 0.f;
#pragma unroll
      for (int r = 0; r < kMaxPer; ++r)
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q) st[r][q] = fmaf(xv[r], bv[q], st[r][q]);
    }
  }
  float* dst = states + (static_cast<long long>(bh) * nc + ch) * P * N;
#pragma unroll
  for (int r = 0; r < kMaxPer; ++r)
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q)
      if (r < np && q < nn) dst[(hi + 16 * r) * N + lo + 16 * q] = st[r][q];
}

// Pass 3: one 64-row query tile; thread (hi, lo) owns rows i = hi * 4 + r
// and columns p = lo + 16 q.
inline size_t out_exact_floats(int P, int N) {
  return size_t(P) * (N + 1) + kMaxChunk + 2 * size_t(kTile) * (N + 1) +
         size_t(kTile) * P + size_t(kTile) * kScStride;
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_out_kernel(const float* __restrict__ xdt,
                         const float* __restrict__ b,
                         const float* __restrict__ c,
                         const float* __restrict__ cum_in,
                         const float* __restrict__ h_in,
                         float* __restrict__ y, int S, int P, int N, int Q,
                         int nqt, int nc) {
  extern __shared__ __align__(16) float ox_smem[];
  const int Ns = N + 1;
  float* st = ox_smem;                // [P][N + 1]  h_in of the chunk
  float* cum = st + P * Ns;           // [kMaxChunk]
  float* ct = cum + kMaxChunk;        // [kTile][N + 1]
  float* bt = ct + kTile * Ns;        // [kTile][N + 1]
  float* xt = bt + kTile * Ns;        // [kTile][P]
  float* sc = xt + kTile * P;         // [kTile][kTile + 1]
  const int tid = threadIdx.x, hi = tid / 16, lo = tid % 16;
  const int np = P / 16;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int rest = blockIdx.x / nqt;
  const int ch = rest % nc, bh = rest / nc;
  const int i0 = qt * kTile;
  const int nq = min(kTile, Q - i0);
  const long long r0 = static_cast<long long>(bh) * S +
                       static_cast<long long>(ch) * Q;
  auto one = [](int) { return 1.f; };

  const float* h = h_in + (static_cast<long long>(bh) * nc + ch) * P * N;
  for (int e = tid; e < P * N; e += kThreads) st[(e / N) * Ns + e % N] = h[e];
  const int k_end = i0 + nq;
  for (int i = tid; i < k_end; i += kThreads) cum[i] = cum_in[r0 + i];
  load_rows(ct, Ns, c, (r0 + i0) * N, nq, N, one);
  __syncthreads();

  // Inter-chunk: exp(cum_i) * (c_i . h_p).
  float acc[4][kMaxPer];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q) acc[r][q] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], sv[kMaxPer];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = ct[(hi * 4 + r) * Ns + n];
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q)
      sv[q] = q < np ? st[(lo + 16 * q) * Ns + n] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = hi * 4 + r;
    const float g = i < nq ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q) acc[r][q] *= g;
  }

  // Intra-chunk: key tiles up to the tile's last query row.
  for (int j0 = 0; j0 < k_end; j0 += kTile) {
    const int nk = min(kTile, k_end - j0);
    __syncthreads();  // the previous key tile is consumed
    load_rows(bt, Ns, b, (r0 + j0) * N, nk, N, one);
    load_rows(xt, P, xdt, (r0 + j0) * P, nk, P, one);
    __syncthreads();

    // Scores: thread (hi, lo) owns i = hi * 4 + r, j = lo + 16 * q.
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ct[(hi * 4 + r) * Ns + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bt[(lo + 16 * q) * Ns + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = hi * 4 + r, j = lo + 16 * q;
        const int qi = i0 + i, kj = j0 + j;
        sc[i * kScStride + j] = (i < nq && j < nk && kj <= qi)
                                    ? s[r][q] * expf(cum[qi] - cum[kj])
                                    : 0.f;
      }
    __syncthreads();

    // acc += scores @ xdt.
    for (int j = 0; j < nk; ++j) {
      float sv[4], xv[kMaxPer];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = sc[(hi * 4 + r) * kScStride + j];
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q)
        xv[q] = q < np ? xt[j * P + lo + 16 * q] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q) acc[r][q] = fmaf(sv[r], xv[q], acc[r][q]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = hi * 4 + r;
    if (i >= nq) continue;
    float* yr = y + (r0 + i0 + i) * P;
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q)
      if (q < np) yr[lo + 16 * q] = acc[r][q];
  }
}

// ---- launches.

struct Args {
  const void *xdt, *a, *b, *c;
  void* y;
  float *state, *ws;
  int BH, S, P, N, Q;
  cudaStream_t stream;
  int nc() const { return S / Q; }
  int nqt() const { return (Q + kTile - 1) / kTile; }
  long long n_states() const {
    return static_cast<long long>(BH) * nc() * P * N;
  }
  float* states() const { return ws; }
  float* cum() const { return ws + n_states(); }
  // bf16 inputs: h_in in bf16 after cum, whose length is rounded up to 4
  // floats so that h_in rows stay 16-byte aligned.
  bf16* h_in16() const {
    return reinterpret_cast<bf16*>(
        cum() + (static_cast<long long>(BH) * S + 3) / 4 * 4);
  }
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

int launch_exact(const Args& g) {
  static bool set1 = false, set3 = false;
  cudaError_t err = allow_smem(ssd_chunk_state_kernel,
                               state_exact_floats(kMaxPN, kMaxPN) * sizeof(float),
                               set1);
  if (err == cudaSuccess)
    err = allow_smem(ssd_chunk_out_kernel,
                     out_exact_floats(kMaxPN, kMaxPN) * sizeof(float), set3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xdt = static_cast<const float*>(g.xdt);
  const float* b = static_cast<const float*>(g.b);
  ssd_chunk_state_kernel<<<g.BH * g.nc(), kThreads,
                           state_exact_floats(g.P, g.N) * sizeof(float),
                           g.stream>>>(xdt, static_cast<const float*>(g.a), b,
                                       g.cum(), g.states(), g.S, g.P, g.N,
                                       g.Q, g.nc());
  int code = static_cast<int>(cudaGetLastError());
  if (code) return code;
  code = launch_state_pass(g, reinterpret_cast<float4*>(g.states()));
  if (code) return code;
  ssd_chunk_out_kernel<<<g.BH * g.nc() * g.nqt(), kThreads,
                         out_exact_floats(g.P, g.N) * sizeof(float),
                         g.stream>>>(xdt, b, static_cast<const float*>(g.c),
                                     g.cum(), g.states(),
                                     static_cast<float*>(g.y), g.S, g.P, g.N,
                                     g.Q, g.nqt(), g.nc());
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// xdt, y: (BH, S, P); a: (BH, S); b, c: (BH, S, N); all fp32 (bf16 = 0) or
// all bf16, bf16 xdt, b and c 16-byte aligned (cp.async); state: (BH, P, N) fp32; ws: the fp32
// workspace of ssd_scan.ssd_plan (BH * nc * P * N chunk states, then
// BH * S cum rounded up to a multiple of 4, then for bf16 BH * nc * P * N
// bf16 h_in).  P and N multiples
// of 16 up to 128, chunk up to 256 dividing S.  Three launches on
// `stream`; returns the first cudaError_t code that is not 0.
extern "C" int repro_ssd_scan(const void* xdt, const void* a, const void* b,
                              const void* c, void* y, float* state, float* ws,
                              int BH, int S, int P, int N, int chunk, int bf16,
                              void* stream) {
  using namespace repro_torch;
  if (BH <= 0 || S <= 0 || chunk <= 0 || chunk > kMaxChunk || S % chunk ||
      P <= 0 || P > kMaxPN || P % 16 || N <= 0 || N > kMaxPN || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{xdt, a, b, c, y, state, ws, BH, S, P, N, chunk,
               static_cast<cudaStream_t>(stream)};
  if (!bf16) return launch_exact(g);
  if (P <= 64 && N <= 64) return launch_tc<64, 64>(g);
  if (P <= 64) return launch_tc<64, 128>(g);
  if (N <= 64) return launch_tc<128, 64>(g);
  return launch_tc<128, 128>(g);
}
