// Paged flash-prefill for Hopper (sm_90a), with the chunk's K/V scatter,
// bf16 or SCLAD (int8/fp8) pool.
//
// Replaces the TPU kernel `paged_flash_prefill` (body `_prefill_kernel`,
// fp and `kv_dtype` branches) of src/repro/kernels/flash_prefill/
// flash_prefill.py.  One prompt chunk per row: queries (B, S, H, D), the
// chunk's own K/V (B, S, Hk, D), S = prefix + P with the P prompt tokens
// LEFT-padded, lengths[b] real tokens, start[b] positions already cached.
//
// Query rows.  A thread block owns the rep = H / Hk query heads that share
// kv head h, for `qpos` query positions q0 .. q0 + qpos - 1 of row b (grid
// (ceil(S / qpos), Hk, B)).  Its rows are flattened as row r = (position
// q0 + r / rep, head h * rep + r % rep), so each K/V tile it loads serves
// all of them.  The launch takes qpos = rows / rep, from shapes alone:
// 128 rows for bf16 q, 64 for fp32 q (flash_prefill.prefill_tiles mirrors
// it for the tests).  Any rep from 1 to 32.
//
// Phase 1, attention.  The cached context [0, start[b]) is read through
// the row's block table, then the chunk itself, causal on padded column
// indices with the left-pad keys dropped and the patch-prefix keys always
// visible — the mask is derived here from start, lengths and prefix, the
// same rule as the TPU kernel's.  Output (B, S, H * D); rows of pad
// positions are junk, as there.
//
// Phase 2, the scatter, spread over every block: position start + j takes
// padded chunk row j (patch prefix) or j + pad (prompt tokens), for j <
// prefix + lengths[b]; the block whose positions hold padded row p stores
// it, so no row is stored twice, and rows past the chunk's length are not
// stored (they keep their old payload and their old scale).  The TPU
// kernel's one-hot (bs, S) placement matmul and its read-then-write grid
// order are TPU devices; here the stores are plain indexed stores through
// the table (scatter_rows, 8 elements a thread), and the pool bytes equal
// the plain version's bit for bit.  There is no race: the stores touch only
// positions >= start, every read of the pool is of a position < start
// (later positions are zero-filled, never read), and the engine's
// copy-on-write barrier makes every block a row writes exclusive to that
// row.
//
// SCLAD pool (int8 or fp8 payload + fp32 (N, bs, Hk) scales).  Context
// rows are dequantized (payload * scale in fp32, rounded to q's type:
// kv_quant.dequantize(..., q.dtype)).  The chunk's own K/V rows are
// fake-quantized before they are attended to (row amax over D, then the
// codec round trip: kv_quant.fake_quant), so a key scores the same
// in-chunk as it will when a later chunk or decode step reads it from the
// pool.  The scatter quantizes each stored row the same way
// (kv_quant.quantize: float32(1/qmax) multiply, IEEE division, rintf,
// saturating fp8; no fast-math) and writes its payload and scale.
//
// bf16 q: the tensor-core body (prefill_tc_kernel), FlashAttention-2 form
// as flash_attention.cu.  One 16-row m tile a warp, 8 warps (two blocks
// an SM at D = 64, one at D = 128); the last m tile is padded with zero
// rows.  Q fragments are loaded once into registers.  The block walks one
// sequence of 64-key tiles — the context through the table, then the
// chunk keys [0, prefix) and [prefix + pad, last query position] — through
// a 3-stage cp.async ring of 16-byte copies into rows padded by 16 bytes;
// keys past a range's end are zero-filled and masked.  A SCLAD context
// tile arrives as payload bytes plus scales (4-byte cp.async) and is
// dequantized to bf16 in shared memory; a chunk tile on a SCLAD pool is
// fake-quantized into the same bf16 buffer (8 elements a lane, the row's
// amax by shuffles); the scatter, the dequant and the fake-quant share
// paged_attention.cuh's lanes_row_scale / encode8 / dequant8, one cast
// chain.  Both conversions run while the next tiles' copies are in flight and
// only for the tile's keys (the buffer starts zeroed, so the rows past
// them stay finite for P @ V).
// Each tile (flash_tile.cuh, shared with flash_attention.cu): S = Q K^T
// by mma.sync m16n8k16 (K through ldmatrix), the online softmax in fp32
// registers (1/sqrt(D) and log2(e) applied to the fp32 scores inside
// exp2), P rounded to bf16 in registers as the A operand of P @ V
// (V through ldmatrix.trans), as the TPU body's `p.astype(_pv_dtype(v))
// @ v`; l sums the fp32 p.  Only tiles that cross the diagonal or a
// range's end are masked element by element.  A block whose positions are
// all left-pad skips both walks and writes zeros (junk by contract,
// finite for the layers after).  The scatter runs while the first tiles'
// copies are in flight.
//
// fp32 q: the exact-fp32 body (paged_prefill_kernel over
// paged_attention.cuh's attend_tile: K/V as fp32 in shared memory, fp32
// FMAs, 32-key tiles), so fp32 parameters keep fp32 products.
//
// Bound on this card.  The work must read the context K/V,
// 2 * sum_b(start_b) * Hk * (D * payload_bytes + scale_bytes) bytes, plus
// the chunk's q, K, V and the output, and write the new K/V (and scales);
// it does 4 * H * D operations per visible (query, key) pair.  At the main
// path's shapes (chunks of 128 tokens over a few hundred cached positions)
// that is ~10-100 operations per byte: bandwidth-bound on paper, ~0.002 ms.
// Predicted at chip_smoke.py's shapes (8 rows of a 128-token chunk, starts
// up to 600, (32, 4, 64) heads: 8 query tiles x 4 kv heads x 8 rows = 256
// blocks, all resident at once): 0.015-0.045 ms a continuation on a bf16
// pool, 0.018-0.050 ms on an int8 / fp8 pool, 0.008-0.025 ms a first
// chunk; the floor is the launch and each block's dependent loads
// (length, start, table entries) before its first mma.
#include "flash_tile.cuh"
#include "mma.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRep = 32;  // query heads per kv head

// One row's chunk: its left pad (P - lengths[b]) and its cached
// positions.  A length outside [0, P] is clamped, so no index leaves the
// chunk.
struct Chunk {
  int pad, start;
  __device__ Chunk(const int* lengths, const int* starts, int b, int S,
                   int prefix) {
    pad = S - prefix - min(max(lengths[b], 0), S - prefix);
    start = starts ? starts[b] : 0;
  }
};

// Eight neighbouring elements of a chunk row as fp32 (exact).
__device__ __forceinline__ void load8(float (&x)[8],
                                      const __nv_bfloat16* p) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wv[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// Phase 2 for the block's positions [q0, q0 + nq): padded row p goes to
// position start + p (patch prefix) or start + p - pad (a prompt token);
// left-pad rows are not stored.  Every thread of the block takes 8
// elements of a (row, K or V) pair, D / 8 neighbouring lanes a row.  A
// bf16 pool takes the values; a SCLAD pool takes kv_quant.quantize's
// payload and scale: the row's amax over D (by shuffles among its lanes),
// scale = row_scale(amax), payload = encode(x / scale), the scale from the
// row's first lane.  The caller's block size is a multiple of 32.
template <int D, typename T, typename P>
__device__ __forceinline__ void scatter_rows(
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    P* __restrict__ k_pool, P* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int* __restrict__ table, const Chunk& c, int b, int h, int S,
    int Hk, int bs, int T_, int prefix, int q0, int nq) {
  constexpr int kLanes = D / 8;
  const int total = 2 * nq * kLanes;
  // Whole rounds of the block: every lane reaches the shuffles.
  for (int base = 0; base < total; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const int i = e / kLanes, col = (e % kLanes) * 8;
    const int p = q0 + i / 2;
    const bool live = e < total && (p < prefix || p >= prefix + c.pad);
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    long long dst = 0;  // the (N, bs, Hk) pool row
    if (live) {
      const int dest = c.start + (p < prefix ? p : p - c.pad);
      const long long blk = table[min(dest / bs, T_ - 1)];
      dst = (blk * bs + dest % bs) * Hk + h;
      load8(x, (i % 2 ? v_new : k_new) +
                   ((static_cast<long long>(b) * S + p) * Hk + h) * D + col);
    }
    P* row = (i % 2 ? v_pool : k_pool) + dst * D + col;
    if constexpr (kQuantized<P>) {
      const float scale = lanes_row_scale<P, kLanes>(x);
      if (live) {
        *reinterpret_cast<uint2*>(row) = encode8<P>(x, scale);
        if (col == 0) (i % 2 ? v_scale : k_scale)[dst] = scale;
      }
    } else if (live) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = mma::pack_bf16x2(x[2 * j], x[2 * j + 1]);
      *reinterpret_cast<uint4*>(row) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---- fp32 q: the exact-fp32 body.
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
                         int qpos, float scale) {
  extern __shared__ float smem[];
  __shared__ long long row_off[kTileKeys];
  const TileSmem<D, kRows> sm(smem);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hk;
  const int q0 = qt * qpos;
  const int nq = min(qpos, S - q0);
  const int rows = nq * rep;
  const Chunk c(lengths, starts, b, S, prefix);
  const int pad = c.pad;
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
  const int n_ctx = min(c.start, T_ * bs);
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

  // Phase 2: this block's chunk rows into the pool.
  scatter_rows<D>(k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, c,
                  b, h, S, Hk, bs, T_, prefix, q0, nq);
}

// ---- bf16 q: the tensor-core body.
using bf16 = __nv_bfloat16;
constexpr int kBK = 64;  // keys per K/V tile

template <int D>
struct TcShape {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // per SM
  static constexpr int kRows = 16 * kWarps;  // query rows: one m tile a warp
  static constexpr int kStages = 3;          // K/V tiles in the ring
  static constexpr int kStride = D + 8;      // bf16 elements a smem row
  static constexpr int kTile = kBK * kStride;
  static constexpr int kPayStride = D + 16;  // bytes a staged payload row
};

// Dynamic shared memory of a block, in bytes: the Q tile, the K and V
// rings, and on a SCLAD pool the bf16 K/V tiles being attended to and the
// ring's scales.
template <int D, typename P>
struct TcSmem {
  using Sh = TcShape<D>;
  static constexpr bool kQuant = kQuantized<P>;
  static constexpr size_t kQ = size_t(Sh::kRows) * Sh::kStride * 2;
  static constexpr size_t kRing = size_t(2) * Sh::kStages * Sh::kTile * 2;
  static constexpr size_t kConv = kQuant ? size_t(2) * Sh::kTile * 2 : 0;
  static constexpr size_t kScales = kQuant ? size_t(2) * Sh::kStages * kBK * 4 : 0;
  static constexpr size_t kBytes = kQ + kRing + kConv + kScales;
};

// A tile of the key walk: keys key0 .. key0 + n - 1 of the context (ctx)
// or of the chunk (padded indices).
struct KeyTile {
  int key0, n;
  bool ctx;
};

template <int D, typename P>
__global__ void __launch_bounds__(TcShape<D>::kThreads,
                                  TcShape<D>::kMinBlocks)
    prefill_tc_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k_new,
                      const bf16* __restrict__ v_new, P* __restrict__ k_pool,
                      P* __restrict__ v_pool, float* __restrict__ k_scale,
                      float* __restrict__ v_scale,
                      const int* __restrict__ lengths,
                      const int* __restrict__ starts,
                      const int* __restrict__ tables, bf16* __restrict__ out,
                      int S, int H, int Hk, int bs, int T_, int prefix,
                      int qpos, float scale_log2) {
  using Sh = TcShape<D>;
  using L = TcSmem<D, P>;
  constexpr int kS = Sh::kStride, kNT = Sh::kThreads;
  constexpr int kStages = Sh::kStages;
  constexpr int kPieces = D / 8;               // 16-byte pieces a bf16 row
  constexpr int kRowStep = kNT / kPieces;      // bf16 rows a pass copies
  constexpr int kPayPieces = D / 16;           // 16-byte pieces a payload row
  constexpr int kPayStep = kNT / kPayPieces;   // payload rows a pass copies
  extern __shared__ __align__(16) unsigned char pf_smem[];
  bf16* qs = reinterpret_cast<bf16*>(pf_smem);   // [kRows][kS]
  bf16* kr = qs + Sh::kRows * kS;                // [kStages][kBK][kS]
  bf16* vr = kr + kStages * Sh::kTile;           // [kStages][kBK][kS]
  bf16* ck = vr + kStages * Sh::kTile;           // [kBK][kS]  (SCLAD)
  bf16* cv = ck + Sh::kTile;                     // [kBK][kS]  (SCLAD)
  float* sk = reinterpret_cast<float*>(pf_smem + L::kQ + L::kRing + L::kConv);
  float* sv = sk + kStages * kBK;                // [kStages][kBK] (SCLAD)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hk;
  const int q0 = qt * qpos;
  const int nq = min(qpos, S - q0);
  const int rows = nq * rep;
  const Chunk c(lengths, starts, b, S, prefix);
  const long long q_row = static_cast<long long>(H) * D;  // position stride

  // A block of left-pad positions only: zeros, no walk, nothing to store.
  if (q0 >= prefix && q0 + nq <= prefix + c.pad) {
    for (int e = tid; e < rows * kPieces; e += kNT) {
      const int r = e / kPieces;
      bf16* dst = out + (static_cast<long long>(b) * S + q0 + r / rep) * q_row +
                  (h * rep + r % rep) * D + (e % kPieces) * 8;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int* table = tables + static_cast<long long>(b) * T_;
  if constexpr (L::kQuant) {
    // The bf16 tiles start at zero: rows past a tile's keys are skipped
    // below and keep finite values (0 * p = 0 in P @ V).
    for (int e = tid; e < 2 * Sh::kTile / 8; e += kNT)
      reinterpret_cast<uint4*>(ck)[e] = make_uint4(0, 0, 0, 0);
  }
  // The key walk: context tiles, then the chunk's patch-prefix keys
  // [0, a_end) and prompt keys [b0, k_end); keys past the block's last
  // query position are never visible.
  const int n_ctx = min(c.start, T_ * bs);
  const int k_end = q0 + nq;
  const int a_end = min(prefix, k_end);
  const int b0 = prefix + c.pad;
  const int n_ctx_t = (n_ctx + kBK - 1) / kBK;
  const int n_a_t = (a_end + kBK - 1) / kBK;
  const int ntiles =
      n_ctx_t + n_a_t + (k_end > b0 ? (k_end - b0 + kBK - 1) / kBK : 0);
  auto tile_at = [&](int t) -> KeyTile {
    if (t < n_ctx_t) return {t * kBK, min(kBK, n_ctx - t * kBK), true};
    t -= n_ctx_t;
    if (t < n_a_t) return {t * kBK, min(kBK, a_end - t * kBK), false};
    const int k0 = b0 + (t - n_a_t) * kBK;
    return {k0, min(kBK, k_end - k0), false};
  };
  auto pool_row = [&](int pos) -> long long {
    const long long blk = table[pos / bs];
    return (blk * bs + pos % bs) * Hk + h;
  };

  // Copy roles: thread tid copies piece tid % kPieces of bf16 rows
  // tid / kPieces + i * kRowStep (payload rows likewise); rows past a
  // tile's keys or the block's query rows are zero-filled.
  const int cr = tid / kPieces, cc = (tid % kPieces) * 8;
#pragma unroll
  for (int i = 0; i < Sh::kRows / kRowStep; ++i) {
    const int r = cr + i * kRowStep;
    const bool in = r < rows;
    const long long src =
        in ? (static_cast<long long>(b) * S + q0 + r / rep) * q_row +
                 (h * rep + r % rep) * D + cc
           : 0;
    mma::cp_async16(qs + r * kS + cc, q + src, in);
  }
  auto load_kv = [&](int t) {
    const KeyTile kt = tile_at(t);
    const int slot = t % kStages;
    bf16* kd = kr + slot * Sh::kTile;
    bf16* vd = vr + slot * Sh::kTile;
    if constexpr (L::kQuant) {
      if (kt.ctx) {  // payload bytes and scales
        unsigned char* kb = reinterpret_cast<unsigned char*>(kd);
        unsigned char* vb = reinterpret_cast<unsigned char*>(vd);
        const int pr = tid / kPayPieces, pc = (tid % kPayPieces) * 16;
#pragma unroll
        for (int i = 0; i < kBK / kPayStep; ++i) {
          const int r = pr + i * kPayStep;
          const bool in = r < kt.n;
          const long long o = (in ? pool_row(kt.key0 + r) : 0) * D + pc;
          mma::cp_async16(kb + r * Sh::kPayStride + pc, k_pool + o, in);
          mma::cp_async16(vb + r * Sh::kPayStride + pc, v_pool + o, in);
        }
        if (tid < kBK) {
          const bool in = tid < kt.n;
          const long long row = in ? pool_row(kt.key0 + tid) : 0;
          mma::cp_async4(sk + slot * kBK + tid, k_scale + row, in);
          mma::cp_async4(sv + slot * kBK + tid, v_scale + row, in);
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < kBK / kRowStep; ++i) {
      const int r = cr + i * kRowStep;
      const bool in = r < kt.n;
      const bf16 *ksrc, *vsrc;
      if (kt.ctx) {
        const long long o = (in ? pool_row(kt.key0 + r) : 0) * D + cc;
        ksrc = reinterpret_cast<const bf16*>(k_pool) + o;
        vsrc = reinterpret_cast<const bf16*>(v_pool) + o;
      } else {
        const long long o =
            in ? ((static_cast<long long>(b) * S + kt.key0 + r) * Hk + h) * D + cc
               : 0;
        ksrc = k_new + o;
        vsrc = v_new + o;
      }
      mma::cp_async16(kd + r * kS + cc, ksrc, in);
      mma::cp_async16(vd + r * kS + cc, vsrc, in);
    }
  };
  // Tiles 0 .. kStages - 2 in flight (the Q tile with tile 0).
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_kv(t);
    mma::cp_async_commit();
  }

  // Phase 2 while the first copies are in flight.
  scatter_rows<D>(k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, c,
                  b, h, S, Hk, bs, T_, prefix, q0, nq);

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // Rows g and g + 8 of the warp: running max of the raw scores, and this
  // lane's share of l.
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};
  const int row0 = warp * 16 + lane / 4;  // the block's row of fragment row g
  const int pos[2] = {q0 + row0 / rep, q0 + (row0 + 8) / rep};
  const bool busy = warp * 16 < rows;  // the warp's m tile has query rows

  // One key tile; kMask only on the tiles that cross the diagonal or the
  // end of their range.
  auto step = [&](int t, const KeyTile& kt, auto masked) {
    constexpr bool kMask = decltype(masked)::value;
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t (at t = 0 the Q tile too) is in, and every
                      // warp is done with tile t - 1, whose slot refills
    if (t + kStages - 1 < ntiles) load_kv(t + kStages - 1);
    mma::cp_async_commit();
    const int slot = t % kStages;
    const bf16* kt_s = kr + slot * Sh::kTile;
    const bf16* vt_s = vr + slot * Sh::kTile;
    if constexpr (L::kQuant) {
      // The tile as bf16 into ck / cv: a context tile dequantized, a chunk
      // tile fake-quantized.
      if (kt.ctx) {
        constexpr int kChunks = D / 8;  // 8 payload bytes -> 16 bf16 bytes
#pragma unroll
        for (int it = 0; it < kBK * kChunks / kNT; ++it) {
          const int e = tid + it * kNT;
          const int r = e / kChunks, ch = e % kChunks;
          if (r >= kt.n) continue;
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const unsigned char* src =
                reinterpret_cast<const unsigned char*>(kv ? vt_s : kt_s) +
                r * Sh::kPayStride + ch * 8;
            *reinterpret_cast<uint4*>((kv ? cv : ck) + r * kS + ch * 8) =
                dequant8<P>(*reinterpret_cast<const uint2*>(src),
                            (kv ? sv : sk)[slot * kBK + r]);
          }
        }
      } else {
        // kPieces neighbouring lanes per row, 8 elements each: quantized
        // and dequantized as the scatter and the context tiles do.
#pragma unroll
        for (int it = 0; it < 2 * kBK * kPieces / kNT; ++it) {
          const int e = tid + it * kNT;
          const int rr = e / kPieces, ch = (e % kPieces) * 8;
          const int r = rr % kBK;
          if (__all_sync(0xffffffffu, r >= kt.n)) continue;
          float x[8];
          load8(x, (rr < kBK ? kt_s : vt_s) + r * kS + ch);
          const float s = lanes_row_scale<P, kPieces>(x);
          *reinterpret_cast<uint4*>((rr < kBK ? ck : cv) + r * kS + ch) =
              dequant8<P>(encode8<P>(x, s), s);
        }
      }
      __syncthreads();
      kt_s = ck;
      vt_s = cv;
    }
    if (!busy) return;
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        mma::ldmatrix_x4(qf[kd], qs + (warp * 16 + lane % 16) * kS + kd * 16 +
                                     (lane / 16) * 8);
    }

    flash_tile<D, kBK, kS>(
        qf, kt_s, vt_s, scale_log2,
        [&](int c, int i) {
          return kMask && (c >= kt.n || (!kt.ctx && kt.key0 + c > pos[i]));
        },
        o, m_run, l_part);
  };
  for (int t = 0; t < ntiles; ++t) {
    const KeyTile kt = tile_at(t);
    // Unmasked: a full tile of context keys, or of chunk keys that the
    // block's first position (and so every position) sees.
    if (kt.n == kBK && (kt.ctx || kt.key0 + kBK - 1 <= q0))
      step(t, kt, std::false_type{});
    else
      step(t, kt, std::true_type{});
  }
  mma::cp_async_wait<0>();
  if (!busy) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = row0 + 8 * i;
    if (r >= rows) continue;
    bf16* dst = out + (static_cast<long long>(b) * S + pos[i]) * q_row +
                (h * rep + r % rep) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          mma::pack_bf16x2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int D, typename P>
int launch_tc(const void* q, const void* k_new, const void* v_new,
              void* k_pool, void* v_pool, float* k_scale, float* v_scale,
              const int* lengths, const int* starts, const int* tables,
              void* out, int B, int S, int H, int Hk, int bs, int T_,
              int prefix, int qpos, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TcSmem<D, P>::kBytes;
  cudaError_t err = allow_smem(prefill_tc_kernel<D, P>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  const dim3 grid((S + qpos - 1) / qpos, Hk, B);
  prefill_tc_kernel<D, P><<<grid, TcShape<D>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<P*>(k_pool),
      static_cast<P*>(v_pool), k_scale, v_scale, lengths, starts, tables,
      static_cast<bf16*>(out), S, H, Hk, bs, T_, prefix, qpos, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename P>
int launch_exact(const void* q, const void* k_new, const void* v_new,
                 void* k_pool, void* v_pool, float* k_scale, float* v_scale,
                 const int* lengths, const int* starts, const int* tables,
                 void* out, int B, int S, int H, int Hk, int bs, int T_,
                 int prefix, int qpos, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = TileSmem<D, kRows>::kFloats * sizeof(float);
  cudaError_t err =
      allow_smem(paged_prefill_kernel<float, D, P>, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((S + qpos - 1) / qpos, Hk, B);
  paged_prefill_kernel<float, D, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<P*>(k_pool),
      static_cast<P*>(v_pool), k_scale, v_scale, lengths, starts, tables,
      static_cast<float*>(out), S, H, Hk, bs, T_, prefix, qpos, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename P>
int launch(int q_bf16, const void* q, const void* k_new, const void* v_new,
           void* k_pool, void* v_pool, float* k_scale, float* v_scale,
           const int* lengths, const int* starts, const int* tables,
           void* out, int B, int S, int H, int Hk, int bs, int T_,
           int prefix, cudaStream_t s) {
  // The block holds qpos * rep <= its body's query rows.
  const int qpos = (q_bf16 ? TcShape<D>::kRows : kRows) / (H / Hk);
  if (q_bf16)
    return launch_tc<D, P>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                           lengths, starts, tables, out, B, S, H, Hk, bs, T_,
                           prefix, qpos, s);
  return launch_exact<D, P>(q, k_new, v_new, k_pool, v_pool, k_scale,
                            v_scale, lengths, starts, tables, out, B, S, H,
                            Hk, bs, T_, prefix, qpos, s);
}

template <int D>
int launch_kv(int kv_kind, int q_bf16, const void* q, const void* k_new,
              const void* v_new, void* k_pool, void* v_pool, float* k_scale,
              float* v_scale, const int* lengths, const int* starts,
              const int* tables, void* out, int B, int S, int H, int Hk,
              int bs, int T_, int prefix, cudaStream_t s) {
  switch (kv_kind) {
    case kKvBf16:
      return launch<D, __nv_bfloat16>(q_bf16, q, k_new, v_new, k_pool,
                                      v_pool, nullptr, nullptr, lengths,
                                      starts, tables, out, B, S, H, Hk, bs,
                                      T_, prefix, s);
    case kKvInt8:
      return launch<D, int8_t>(q_bf16, q, k_new, v_new, k_pool, v_pool,
                               k_scale, v_scale, lengths, starts, tables, out,
                               B, S, H, Hk, bs, T_, prefix, s);
    case kKvFp8:
      return launch<D, fp8_e4m3>(q_bf16, q, k_new, v_new, k_pool, v_pool,
                                 k_scale, v_scale, lengths, starts, tables,
                                 out, B, S, H, Hk, bs, T_, prefix, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// q: (B, S, H, D); k_new, v_new: (B, S, Hk, D), all bf16 (q_bf16 = 1: the
// tensor-core body) or fp32 (the exact body), 16-byte aligned; pools:
// (N, bs, Hk, D) bf16 (kv_kind 0), int8 (1) or fp8 e4m3 (2), 16-byte
// aligned, updated in place; k_scale, v_scale: (N, bs, Hk) fp32, updated
// in place, for kv_kind 1-2, else null; lengths: (B,) int32; starts: (B,)
// int32, or null for a first chunk; tables: (B, T) int32; out: (B, S, H *
// D) in q's type.  Returns a cudaError_t code.
extern "C" int repro_paged_prefill(const void* q, const void* k_new,
                                   const void* v_new, void* k_pool,
                                   void* v_pool, float* k_scale,
                                   float* v_scale, const int* lengths,
                                   const int* starts, const int* tables,
                                   void* out, int B, int S, int H, int Hk,
                                   int D, int bs, int T, int prefix,
                                   int q_bf16, int kv_kind, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || B > 65535 || Hk <= 0 || Hk > 65535 || H % Hk != 0 ||
      H / Hk > kMaxRep || bs <= 0 || T <= 0 || S <= 0 ||
      prefix < 0 || prefix > S ||
      (kv_kind != kKvBf16 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_kv<64>(kv_kind, q_bf16, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, lengths, starts, tables, out, B, S, H, Hk, bs, T, prefix, s);
  if (D == 128)
    return launch_kv<128>(kv_kind, q_bf16, q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, lengths, starts, tables, out, B, S, H, Hk, bs, T, prefix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
