// Block-SCLD matmul for Hopper (sm_90a): y = x @ decode(vals, rows).
//
// Replaces the TPU kernel `sclad_matmul` (body `_sclad_kernel`) of
// src/repro/kernels/sclad_matmul/sclad_matmul.py.  The weight W (K, N) is
// stored as compressed (128, 128) tiles: each keeps C of its 16 (8, 128)
// row-units, `vals` (K/128, N/128, C, 8, 128) fp32 or bf16, with the units'
// row indices `rows` (K/128, N/128, C) int32.  x (M, K) and y (M, N) are fp32
// or bf16 (y in x's type).  Each decoded weight is rounded to x's type before
// its product and products are summed in fp32, as the TPU body's
// `dot(x, w.astype(x.dtype), preferred_element_type=f32)`.
//
// Bound on this card.  The work reads x, the stored units (C/16 of the dense
// weight's bytes) and the rows, writes y, and does 2 * M * K * N dense
// operations.  At the SCLD check's shapes (M = 128, tinyllama-1.1b's MLP
// widths, bf16) that is 10.6 MB and 2.95 GFLOP at C = 6 (3.2 us from bytes,
// 3.0 us from operations) and 25 MB at C = 16 (7.5 us): the bytes bound it,
// and a kernel that reads only the stored units can beat a dense matmul
// on the decoded weight.
//
// bf16 x: tensor cores.  One block of 8 warps per (128-row M tile, 128-
// column N tile = one W tile column, K slice), one block an SM; each warp
// owns a 64 x 32 output tile in fp32 registers and multiplies with
// mma.sync m16n8k16 (bf16 x bf16 -> fp32), its ldmatrix for the next
// 16-deep slice in flight during this slice's products.  The K loop goes
// in steps of 64 rows, half a W tile, through a 4-stage ring in shared
// memory: three steps in flight by cp.async while the fourth is multiplied.
// A step holds x's (128, 64) slice, copied row by row in 16-byte pieces
// (rows past M zero-filled), and the decoded (64, 128) W slice in bf16:
// warp w fills unit slot w, by copying the stored unit for that slot (2 KB,
// contiguous) straight into rows w * 8, or by zero-filling them in the same
// pass where no unit is stored.  So the block loads C/16 of the dense
// weight from memory and multiplies the dense tile (load-as-dense: zero
// units are multiplied, never skipped).  A tile's unit map is read into a
// register (lane c holds rows[c]) three tiles ahead, and a ballot gives
// each warp its slot's unit, no __syncthreads of its own.  fp32 vals with
// bf16 x go through registers: loaded, rounded to bf16, stored.  Rows of
// both tiles are padded by 16 bytes, so ldmatrix (x) and ldmatrix.trans (W)
// read without bank conflicts.  M = 128 gives few output tiles (44 and 16
// at the check's shapes), so the wrapper splits the K loop into slices
// (repro_torch.kernels.sclad_matmul.sclad_matmul.k_split) until there is
// one block for each of the card's SMs: 3 slices a tile for gate/up, 9 on
// 4 tiles and 8 on the other 12 for down (an even split would leave SMs
// idle or start a second wave).  Each block writes its fp32 partial sums
// to a workspace the wrapper allocates, and a second kernel adds them up
// slice by slice in a fixed order and casts to bf16, so y is the same
// bits from run to run (no float atomics).  On an H100 (80GB HBM3, 700 W,
// chip_smoke.py) the C = 6 projections run at ~140 TFLOP/s, ~15% of the
// bound, 2.4x (gate/up) and 1.7x (down) the time of torch.matmul on the
// dense weight; the time hardly moves with C.  What holds it back is not
// the stored units' bytes but the multiply on mma.sync at ~10 64-row steps
// a block (each block's start, and its final partial sums, are paid once
// for little work), and the workspace's round trip (3 fp32 partials of the
// output written and read back by the second kernel, more than the stored
// units' bytes at C = 6).  A wgmma body fed the same way (cp.async into
// unswizzled core matrices, one group in flight) was not faster; TMA loads
// into swizzled tiles with a producer warp, and partial sums kept on chip,
// are the next steps.
//
// fp32 x: the exact-fp32 body of the first port, kept so that fp32 inputs
// keep fp32 products (the SCLD example holds them to 1e-4; TF32 would not):
// one block per (64-row M tile, 128-column N tile), the K tiles in turn,
// each decoded into a dense fp32 tile in shared memory and multiplied by
// fp32 FMAs, 4 x 8 outputs a thread.  The dtype of x picks the body.
#include "mma.cuh"
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 128;              // tile edge, along K and N
constexpr int kUnitRows = 8;            // rows of one stored unit
constexpr int kUnits = kTile / kUnitRows;  // 16 units a tile
constexpr int kUnitElems = kUnitRows * kTile;

// ---- fp32 x: the exact-fp32 body.
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

// ---- bf16 x: the tensor-core body.
using bf16 = __nv_bfloat16;
constexpr int kTcBM = 128;               // output rows per block
constexpr int kTcBN = kTile;             // output columns per block
constexpr int kBK = 64;                  // K rows a step: 8 unit slots
constexpr int kTcThreads = 256;          // 8 warps, 2 x 4 over the output
constexpr int kSlots = kBK / kUnitRows;  // = warps: one unit slot a warp
constexpr int kWarpM = 64, kWarpN = 32;  // a warp's output tile
constexpr int kMI = kWarpM / 16, kNI = kWarpN / 8;  // its mma tiles
constexpr int kStages = 4;               // K steps in the ring
constexpr int kXStride = kBK + 8;        // bf16 elements a row: 144 bytes
constexpr int kWStride = kTcBN + 8;      // 272 bytes
constexpr int kXElems = kTcBM * kXStride;
constexpr int kWElems = kBK * kWStride;
constexpr int kStageElems = kXElems + kWElems;
constexpr size_t kTcSmemBytes = size_t(kStages) * kStageElems * sizeof(bf16);
constexpr int kXCopies = kTcBM * (kBK / 8) / kTcThreads;  // x pieces a thread
constexpr int kXRowStep = kTcThreads / (kBK / 8);         // rows apart

// Eight neighbouring stored values as eight bf16 in one 16-byte store.
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(mma::pack_bf16x2(a.x, a.y), mma::pack_bf16x2(a.z, a.w),
                 mma::pack_bf16x2(b.x, b.y), mma::pack_bf16x2(b.z, b.w));
}

// The K split of a launch: of its `tiles` output tiles (128 x 128, M tile
// fastest), the first `wide` take split + 1 K slices and the others
// `split`, so that the grid can be any block count.  Slice z of an output
// tile with s slices covers K tiles [nk * z / s, nk * (z + 1) / s).
struct Split {
  int split, wide;
  __host__ __device__ int slices(int tile) const {
    return tile < wide ? split + 1 : split;
  }
  __host__ __device__ int blocks(int tiles) const {
    return tiles * split + wide;
  }
  // Block b -> (output tile, slice).
  __device__ void of_block(int b, int& tile, int& z) const {
    const int head = wide * (split + 1);
    if (b < head) {
      tile = b / (split + 1);
      z = b % (split + 1);
    } else {
      tile = wide + (b - head) / split;
      z = (b - head) % split;
    }
  }
};

// Block blockIdx.x: one K slice of one (128-row M tile, 128-column N tile =
// W tile column) output tile.  With one slice a tile (ws == nullptr) it
// writes y; else its fp32 sums go to ws[z] (slices, M, N).
template <typename V>
__global__ void __launch_bounds__(kTcThreads, 1)
    sclad_matmul_tc_kernel(const bf16* __restrict__ x,
                           const V* __restrict__ vals,
                           const int* __restrict__ rows, bf16* __restrict__ y,
                           float* __restrict__ ws, int M, int nk, int nn,
                           int C, Split sp) {
  extern __shared__ __align__(16) bf16 tc_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mt = (M + kTcBM - 1) / kTcBM;
  int tile, z;
  sp.of_block(blockIdx.x, tile, z);
  const int m0 = (tile % mt) * kTcBM;
  const int jn = tile / mt;
  const int s = sp.slices(tile);
  const int kt0 = static_cast<int>(static_cast<long long>(nk) * z / s);
  const int kt1 = static_cast<int>(static_cast<long long>(nk) * (z + 1) / s);
  const int nsteps = 2 * (kt1 - kt0);
  const long long K = static_cast<long long>(nk) * kTile;
  const long long N = static_cast<long long>(nn) * kTile;

  // x copies: piece tid % 8 (16 bytes) of rows tid / 8 + kXRowStep * i;
  // rows past M are zero-filled.
  const int xr = tid / 8, xc = (tid % 8) * 8;
  const bf16* xp = x + (m0 + xr) * K + static_cast<long long>(kt0) * kTile + xc;
  unsigned x_in = 0;
#pragma unroll
  for (int i = 0; i < kXCopies; ++i)
    x_in |= unsigned(m0 + xr + kXRowStep * i < M) << i;
  // The unit map of K tile kt0 + t: lane c < C holds rows[c], the others -1.
  auto unit_map = [&](int t) {
    const long long tile = static_cast<long long>(kt0 + t) * nn + jn;
    return t < kt1 - kt0 && lane < C ? __ldg(rows + tile * C + lane) : -1;
  };
  // Step t: x's (128, 64) slice and W's 8 unit slots (64, 128) at K rows
  // (kt0 + t / 2) * 128 + (t % 2) * 64.  W: warp w fills slot w of the
  // step with the stored unit for it (2 KB, contiguous, 4 pieces a lane)
  // or zeros.
  auto issue = [&](int t, int map) {
    bf16* xs = tc_smem + (t % kStages) * kStageElems;
    bf16* wsm = xs + kXElems;
#pragma unroll
    for (int i = 0; i < kXCopies; ++i) {
      const bool in = (x_in >> i) & 1u;
      mma::cp_async16(xs + (xr + kXRowStep * i) * kXStride + xc,
                      in ? xp + t * kBK + kXRowStep * i * K : x, in);
    }
    const unsigned stored =
        __ballot_sync(0xffffffffu, map == (t % 2) * kSlots + warp);
    bf16* dst = wsm + warp * kUnitRows * kWStride;
    const V* src = vals + ((static_cast<long long>(kt0 + t / 2) * nn + jn) * C +
                           (stored ? __ffs(stored) - 1 : 0)) *
                              kUnitElems;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i;  // the unit's piece e: elements 8e..8e+7
      bf16* d = dst + (e / 16) * kWStride + (e % 16) * 8;
      if (stored == 0)  // warp-uniform
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      else if constexpr (std::is_same<V, bf16>::value)
        mma::cp_async16(d, src + e * 8, true);
      else
        store8_bf16(d, src + e * 8);
    }
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Unit maps of the next three K tiles: map0 is the one of the next step
  // to issue, and a tile's map is loaded three tiles (six steps) before its
  // first step, so its latency never holds up an issue.
  int map0 = unit_map(0), map1 = unit_map(1), map2 = unit_map(2);
  auto issue_next = [&](int t) {
    issue(t, map0);
    if (t % 2) {  // the tile's second half: move the maps on
      map0 = map1;
      map1 = map2;
      map2 = unit_map(t / 2 + 3);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nsteps) issue_next(t);
    mma::cp_async_commit();
  }

  const int wm = warp / 4, wn = warp % 4;  // the warp's 64 x 32 output tile
  // Fragments of one 16-deep slice of a step, double-buffered so that the
  // next slice's ldmatrix are in flight during this slice's mma.
  uint32_t a[2][kMI][4], b[2][kNI][2];
  auto load_frags = [&](const bf16* xs, const bf16* wsm, int kk, int buf) {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
      mma::ldmatrix_x4(a[buf][mi],
                       xs + (wm * kWarpM + mi * 16 + lane % 16) * kXStride +
                           kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n2 = 0; n2 < kNI / 2; ++n2) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(
          r, wsm + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kWStride +
                 wn * kWarpN + n2 * 16 + (lane / 16) * 8);
      b[buf][2 * n2][0] = r[0];
      b[buf][2 * n2][1] = r[1];
      b[buf][2 * n2 + 1][0] = r[2];
      b[buf][2 * n2 + 1][1] = r[3];
    }
  };
  for (int t = 0; t < nsteps; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // step t is in; every warp is done with step t - 1
    if (t + kStages - 1 < nsteps) issue_next(t + kStages - 1);  // into the
                                      // slot step t - 1 held
    mma::cp_async_commit();

    const bf16* xs = tc_smem + (t % kStages) * kStageElems;
    const bf16* wsm = xs + kXElems;
    load_frags(xs, wsm, 0, 0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk + 1 < kBK / 16) load_frags(xs, wsm, kk + 1, (kk + 1) % 2);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
          mma::mma_bf16(acc[mi][ni], a[kk % 2][mi], b[kk % 2][ni][0],
                        b[kk % 2][ni][1]);
    }
  }
  mma::cp_async_wait<0>();

  // Row wm * 64 + mi * 16 + lane / 4 + 8 h of the tile, columns wn * 32 +
  // ni * 8 + 2 (lane % 4) + {0, 1}.
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * kWarpM + mi * 16 + lane / 4 + 8 * h;
        const long long col = static_cast<long long>(jn) * kTile +
                              wn * kWarpN + ni * 8 + 2 * (lane % 4);
        if (m >= M) continue;
        const float lo = acc[mi][ni][2 * h], hi = acc[mi][ni][2 * h + 1];
        if (ws == nullptr)
          *reinterpret_cast<uint32_t*>(y + m * N + col) =
              mma::pack_bf16x2(lo, hi);
        else
          *reinterpret_cast<float2*>(
              ws + (static_cast<long long>(z) * M + m) * N + col) =
              make_float2(lo, hi);
      }
}

// y = bf16(ws[0] + ws[1] + ... ), over the slices of each element's output
// tile, in slice order: four elements a thread.
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 bf16* __restrict__ y, int M, int nn,
                                 Split sp) {
  const long long n = static_cast<long long>(M) * nn * kTile;
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const int m = static_cast<int>(i / (nn * kTile));
  const int jn = static_cast<int>(i % (nn * kTile)) / kTile;
  const int s = sp.slices(m / kTcBM + (M + kTcBM - 1) / kTcBM * jn);
  float4 acc = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < s; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(ws + z * n + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  *reinterpret_cast<uint2*>(y + i) = make_uint2(
      mma::pack_bf16x2(acc.x, acc.y), mma::pack_bf16x2(acc.z, acc.w));
}

template <typename V>
int launch_tc(const void* x, const void* vals, const int* rows, void* y,
              void* ws, int M, int nk, int nn, int C, Split sp,
              cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t err =
      allow_smem(sclad_matmul_tc_kernel<V>, kTcSmemBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (M + kTcBM - 1) / kTcBM * nn;
  float* w = (sp.split + (sp.wide > 0) > 1) ? static_cast<float*>(ws) : nullptr;
  sclad_matmul_tc_kernel<V>
      <<<sp.blocks(tiles), kTcThreads, kTcSmemBytes, stream>>>(
          static_cast<const bf16*>(x), static_cast<const V*>(vals), rows,
          static_cast<bf16*>(y), w, M, nk, nn, C, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr) return static_cast<int>(err);
  const long long quads = static_cast<long long>(M) * nn * kTile / 4;
  split_sum_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256, 0,
                     stream>>>(w, static_cast<bf16*>(y), M, nn, sp);
  return static_cast<int>(cudaGetLastError());
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
// type.  bf16 x runs the tensor-core body: of its (M / 128) * nn output
// tiles the first `wide` take split + 1 K slices and the others `split`
// (1 <= split, each at most nk); more than one slice on any tile needs
// `ws`, fp32 (split + (wide > 0), M, N).  fp32 x runs the exact-fp32 body
// and takes split = 1, wide = 0.  All pointers 16-byte aligned.  Returns a
// cudaError_t code.
extern "C" int repro_sclad_matmul(const void* x, const void* vals,
                                  const int* rows, void* y, void* ws, int M,
                                  int nk, int nn, int C, int split, int wide,
                                  int x_bf16, int vals_bf16, void* stream) {
  using namespace repro_torch;
  const int tiles = (M + kTcBM - 1) / kTcBM * nn;
  const int most = split + (wide > 0);
  if (M <= 0 || nk <= 0 || nn <= 0 || C < 1 || C > kUnits || split < 1 ||
      wide < 0 || wide >= tiles || most > nk ||
      static_cast<long long>(tiles) * split + wide > 0x7fffffff ||
      (most > 1 && (ws == nullptr || !x_bf16)) || nn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp{split, wide};
  if (x_bf16 && vals_bf16)
    return launch_tc<__nv_bfloat16>(x, vals, rows, y, ws, M, nk, nn, C, sp, s);
  if (x_bf16)
    return launch_tc<float>(x, vals, rows, y, ws, M, nk, nn, C, sp, s);
  if (vals_bf16)
    return launch<float, __nv_bfloat16>(x, vals, rows, y, M, nk, nn, C, s);
  return launch<float, float>(x, vals, rows, y, M, nk, nn, C, s);
}
