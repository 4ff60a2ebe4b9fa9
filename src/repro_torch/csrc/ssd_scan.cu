// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan/ssd_scan.py.  Inputs, pre-scaled by the caller:
// xdt (BH, S, P), a (BH, S), b and c (BH, S, N), all fp32 or all bf16.
// Outputs: y (BH, S, P) in the inputs' type and the final state (BH, P, N)
// fp32.  Per chunk of Q positions, with cum the inclusive cumsum of a over
// the chunk:
//   y     = ((C B^T) . L) xdt + exp(cum) . (C state^T),  L_ij = exp(cum_i - cum_j), i >= j
//   state = exp(cum_last) state + (xdt . exp(cum_last - cum))^T B
//
// Design.  One thread block per bh; the chunk loop runs inside the block
// with the (P, N) fp32 state in shared memory, which takes the place of the
// TPU's sequential chunk axis and its VMEM state scratch.  A (Q, Q) score
// tile would not fit a block's shared memory at Q = 256 (256 KB in fp32), so
// the chunk's outputs are computed 64 query rows at a time, each walking the
// 64-row key tiles up to its own last row (fully masked key tiles are
// skipped).  L is taken only where i >= j, so exp never sees a positive
// argument (the TPU body takes exp of the whole (Q, Q) difference and masks
// afterwards, where the upper triangle can overflow).  Every output tile
// reads the state that entered the chunk; the state update runs after the
// chunk's last output tile, and the state is written out after the last
// chunk.  A 16 x 16 thread grid owns register blocks of each product (4 x 4
// scores, 4 x P/16 outputs, P/16 x N/16 state entries); row strides of N + 1
// keep the column walks on distinct banks.  All arithmetic is fp32 on the
// CUDA cores.
//
// Bound on this card.  The work reads xdt, a, b, c and writes y and the
// state once; the chunked form does about Q/2 * (2N + 2P) + 4PN operations a
// position.  At mamba2-1.3b's widths (P = 64, N = 128, chunk 256, bf16) that
// is ~100 operations per byte: bandwidth-bound on paper.  This version gives
// each bh one SM (BH blocks in all) and multiplies from shared memory on the
// CUDA cores, so it runs far from that bound; splitting the sequence across
// blocks with a state pass between them, and tensor cores, are the later
// work.
#include "paged_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 64;    // query rows and key rows of a tile
constexpr int kScStride = kTileQ + 1;
constexpr int kMaxPN = 128;   // P and N at most
constexpr int kMaxPer = kMaxPN / 16;
constexpr int kMaxChunk = 256;

// Shared memory of one block, in floats.
struct SsdSmem {
  float* st;   // [P][N + 1]  the state carried from chunk to chunk
  float* cum;  // [Q]         cumsum of a over the chunk
  float* ct;   // [kTileQ][N + 1]  c rows of the query tile
  float* bt;   // [kTileQ][N + 1]  b rows of the key tile
  float* xt;   // [kTileQ][P]      xdt rows of the key tile
  float* sc;   // [kTileQ][kTileQ + 1]  masked, decayed scores
  static size_t floats(int P, int N, int Q) {
    return size_t(P) * (N + 1) + Q + 2 * size_t(kTileQ) * (N + 1) +
           size_t(kTileQ) * P + size_t(kTileQ) * kScStride;
  }
  __device__ SsdSmem(float* base, int P, int N, int Q)
      : st(base),
        cum(st + P * (N + 1)),
        ct(cum + Q),
        bt(ct + kTileQ * (N + 1)),
        xt(bt + kTileQ * (N + 1)),
        sc(xt + kTileQ * P) {}
};

// Rows [0, n) of a (rows, width) slice of `src` starting at element `off`
// into `dst` (row stride `stride`), as fp32; each element times `scale(row)`.
template <typename T, typename Scale>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const T* __restrict__ src,
                                          long long off, int n, int width,
                                          Scale scale) {
  for (int e = threadIdx.x; e < n * width; e += kThreads) {
    const int i = e / width, k = e % width;
    dst[i * stride + k] = to_float(src[off + e]) * scale(i);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ xdt, const T* __restrict__ a,
                    const T* __restrict__ b, const T* __restrict__ c,
                    T* __restrict__ y, float* __restrict__ state_out, int S,
                    int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const SsdSmem sm(smem, P, N, Q);
  const int tid = threadIdx.x;
  const int hi = tid / 16, lo = tid % 16;
  const int np = P / 16, nn = N / 16;
  const int Ns = N + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * S;
  auto one = [](int) { return 1.f; };

  for (int e = tid; e < P * Ns; e += kThreads) sm.st[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const long long r0 = row0 + t0;  // the chunk's first (bh, position) row
    __syncthreads();  // the state is initialised / updated

    // 1. cum: warp 0, each lane a run of Q/32 positions, then a scan of
    // the lanes' totals.
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int i_lo = tid * per, i_hi = min(Q, i_lo + per);
      float run = 0.f;
      for (int i = i_lo; i < i_hi; ++i) {
        run += to_float(a[r0 + i]);
        sm.cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      for (int i = i_lo; i < i_hi; ++i) sm.cum[i] += incl - run;
    }
    __syncthreads();

    // 2. Outputs, one 64-row query tile at a time.  Thread (hi, lo) owns
    // rows i = hi * 4 + r and columns p = lo + 16 * q.
    for (int i0 = 0; i0 < Q; i0 += kTileQ) {
      const int nq = min(kTileQ, Q - i0);
      load_rows(sm.ct, Ns, c, (r0 + i0) * N, nq, N, one);
      __syncthreads();

      // Inter-chunk: exp(cum_i) * (c_i . state_p).
      float acc[4][kMaxPer];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[kMaxPer];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sm.ct[(hi * 4 + r) * Ns + n];
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q)
          sv[q] = q < np ? sm.st[(lo + 16 * q) * Ns + n] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < kMaxPer; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = hi * 4 + r;
        const float g = i < nq ? expf(sm.cum[i0 + i]) : 0.f;
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q) acc[r][q] *= g;
      }

      // Intra-chunk: key tiles up to the tile's last query row.
      const int k_end = i0 + nq;
      for (int j0 = 0; j0 < k_end; j0 += kTileQ) {
        const int nk = min(kTileQ, k_end - j0);
        __syncthreads();  // the previous key tile is consumed
        load_rows(sm.bt, Ns, b, (r0 + j0) * N, nk, N, one);
        load_rows(sm.xt, P, xdt, (r0 + j0) * P, nk, P, one);
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
          for (int r = 0; r < 4; ++r) cv[r] = sm.ct[(hi * 4 + r) * Ns + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = sm.bt[(lo + 16 * q) * Ns + n];
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
            sm.sc[i * kScStride + j] =
                (i < nq && j < nk && kj <= qi)
                    ? s[r][q] * expf(sm.cum[qi] - sm.cum[kj])
                    : 0.f;
          }
        __syncthreads();

        // acc += scores @ xdt.
        for (int j = 0; j < nk; ++j) {
          float sv[4], xv[kMaxPer];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = sm.sc[(hi * 4 + r) * kScStride + j];
#pragma unroll
          for (int q = 0; q < kMaxPer; ++q)
            xv[q] = q < np ? sm.xt[j * P + lo + 16 * q] : 0.f;
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
        T* yr = y + (r0 + i0 + i) * P;
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q)
          if (q < np) yr[lo + 16 * q] = from_float<T>(acc[r][q]);
      }
      __syncthreads();  // ct, bt, xt and sc are reused
    }

    // 3. The state update.  Thread (hi, lo) owns p = hi + 16 * r and
    // n = lo + 16 * q; nobody else reads those entries until the next
    // chunk, so they are updated in place.
    const float c_last = sm.cum[Q - 1];
    float st[kMaxPer][kMaxPer];
    {
      const float g = expf(c_last);
#pragma unroll
      for (int r = 0; r < kMaxPer; ++r)
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q)
          st[r][q] = (r < np && q < nn)
                         ? g * sm.st[(hi + 16 * r) * Ns + lo + 16 * q]
                         : 0.f;
    }
    for (int j0 = 0; j0 < Q; j0 += kTileQ) {
      const int nk = min(kTileQ, Q - j0);
      if (j0 > 0) __syncthreads();  // the previous key tile is consumed
      load_rows(sm.bt, Ns, b, (r0 + j0) * N, nk, N, one);
      const float* cum = sm.cum + j0;
      load_rows(sm.xt, P, xdt, (r0 + j0) * P, nk, P,
                [=](int j) { return expf(c_last - cum[j]); });
      __syncthreads();
      for (int j = 0; j < nk; ++j) {
        float xv[kMaxPer], bv[kMaxPer];
#pragma unroll
        for (int r = 0; r < kMaxPer; ++r)
          xv[r] = r < np ? sm.xt[j * P + hi + 16 * r] : 0.f;
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q)
          bv[q] = q < nn ? sm.bt[j * Ns + lo + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < kMaxPer; ++r)
#pragma unroll
          for (int q = 0; q < kMaxPer; ++q) st[r][q] = fmaf(xv[r], bv[q], st[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxPer; ++r)
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q)
        if (r < np && q < nn) sm.st[(hi + 16 * r) * Ns + lo + 16 * q] = st[r][q];
  }

  __syncthreads();
  float* so = state_out + static_cast<long long>(blockIdx.x) * P * N;
  for (int e = tid; e < P * N; e += kThreads) so[e] = sm.st[(e / N) * Ns + e % N];
}

template <typename T>
int launch(const void* xdt, const void* a, const void* b, const void* c,
           void* y, float* state, int BH, int S, int P, int N, int Q,
           cudaStream_t stream) {
  static bool smem_set = false;
  const size_t most = SsdSmem::floats(kMaxPN, kMaxPN, kMaxChunk) * sizeof(float);
  cudaError_t err = allow_smem(ssd_scan_kernel<T>, most, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = SsdSmem::floats(P, N, Q) * sizeof(float);
  ssd_scan_kernel<T><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      state, S, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// xdt, y: (BH, S, P); a: (BH, S); b, c: (BH, S, N); all fp32 (bf16 = 0) or
// all bf16; state: (BH, P, N) fp32.  P and N multiples of 16 up to 128,
// chunk up to 256 dividing S.  Returns a cudaError_t code.
extern "C" int repro_ssd_scan(const void* xdt, const void* a, const void* b,
                              const void* c, void* y, float* state, int BH,
                              int S, int P, int N, int chunk, int bf16,
                              void* stream) {
  using namespace repro_torch;
  if (BH <= 0 || S <= 0 || chunk <= 0 || chunk > kMaxChunk || S % chunk ||
      P <= 0 || P > kMaxPN || P % 16 || N <= 0 || N > kMaxPN || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(xdt, a, b, c, y, state, BH, S, P, N, chunk, s);
  return launch<float>(xdt, a, b, c, y, state, BH, S, P, N, chunk, s);
}
