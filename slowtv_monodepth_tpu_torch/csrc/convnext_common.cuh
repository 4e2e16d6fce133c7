// Device code shared by the fused ConvNeXt block's forward (convnext_block.cu)
// and backward (convnext_block_bwd.cu): the 7x7 depthwise taps of a pixel
// tile, and `gemm_panel`, a (M, K) operand in shared memory times 256 rows of
// a weight matrix in device memory, by hand-written float32 FMA loops.
//
// gemm_panel: 256 threads as 4 rows x 64 columns, each with an (M/4) x 4
// register tile; weights stream through a [256][32] shared tile (rows padded
// to 36 floats: conflict-free 128-bit reads), the next tile prefetched into
// registers during the current one's FMAs; both operands are read as float4
// along K, and a warp (8 columns x 4 rows) shares its reads: 12 shared-memory
// wavefronts per 128 FMAs of a warp. The weight rows are either K-contiguous
// (PyTorch's (out, in) layout read as it is: the forward's two products) or
// the transposed read of the same matrix (the backward's two input-gradient
// products), which a transposing tile load puts in the same shared layout.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTN = 64;          // thread columns
constexpr int kTM = 4;           // thread rows (kTM * kTN threads)
constexpr int kRN = 4;           // output columns per thread (n = tn + 64 * i)
constexpr int kNP = kTN * kRN;   // panel width = hidden chunk = 256
constexpr int kKT = 32;          // K per weight tile
constexpr int kWS = kKT + 4;     // padded row stride of the weight tile
constexpr int kHS = kNP + 4;     // padded row stride of the hidden chunk
constexpr int kK = 7;            // depthwise taps per axis
constexpr int kFetch = 8;        // float4 per thread and weight tile (256 * 8 / 256)
constexpr int kStrip = 4;        // pixels per strip of the taps
constexpr float kEps = 1e-6f;    // the LayerNorm's epsilon (as the TPU kernel's)

// Timing aids, never defined in the library's build: each leaves one part of
// kernel 9 out (the result is then wrong), so that the package's
// tools/block_kernel_bench.py can say where the time goes.
#ifdef K9_NO_TAPS
constexpr bool kTaps = false;    // skip the 49 taps
#else
constexpr bool kTaps = true;
#endif
#ifdef K9_NO_FMA
constexpr bool kFma = false;     // skip the matrix products' FMAs
#else
constexpr bool kFma = true;
#endif
#ifdef K9_NO_STREAM
constexpr bool kStream = false;  // skip the weight tiles' loads, stores and barriers
#else
constexpr bool kStream = true;
#endif

__device__ __forceinline__ float gelu(float h, bool approximate) {
  if (approximate) {
    const float inner = 0.7978845608028654f * (h + 0.044715f * h * h * h);
    return 0.5f * h * (1.f + tanhf(inner));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865475f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread t's place in the 4 x 64 grid of register tiles: a warp covers 8
// columns x 4 rows. The thread owns rows tm + 4 * r and columns tn + 64 * i.
__device__ __forceinline__ int thread_col(int t) { return (t >> 5) * 8 + (t & 7); }
__device__ __forceinline__ int thread_row(int t) { return (t & 31) >> 3; }

// This thread's kFetch float4 of the [256][32] weight tile at k = kt.
// K-contiguous rows (TRANS false): W(n, k) = Wg[n * ldw + k]; the thread
// reads row ln + 32 * i, columns lk .. lk + 3. Transposed (TRANS true):
// W(n, k) = Wg[k * ldw + n]; a warp reads 8 k-rows x 4 float4 along n (64
// contiguous bytes per k-row). Rows n >= N and columns k >= K read as zero;
// N and K are multiples of 4.
template <bool TRANS>
__device__ __forceinline__ void fetch_tile(float4 (&pre)[kFetch], const float* __restrict__ Wg,
                                           long long ldw, int N, int K, int kt, int t) {
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    int n, k;
    if (TRANS) {
      const int q = i * 8 + (t >> 5), lane = t & 31;
      k = (q & 3) * 8 + (lane >> 2);
      n = ((q >> 2) * 4 + (lane & 3)) * 4;
    } else {
      n = (t >> 3) + 32 * i;
      k = (t & 7) * 4;
    }
    const bool live = n < N && kt + k < K;
    const float* src = TRANS ? Wg + (long long)(kt + k) * ldw + n : Wg + n * ldw + kt + k;
    pre[i] = live ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The fetched float4s into the [256][kWS] tile, in the [n][k] layout both
// kinds of fetch share. (Transposed: one float per row, 2-way bank conflicts.)
template <bool TRANS>
__device__ __forceinline__ void store_tile(const float4 (&pre)[kFetch], float* Ws, int t) {
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    if (TRANS) {
      const int q = i * 8 + (t >> 5), lane = t & 31;
      const int k = (q & 3) * 8 + (lane >> 2), n = ((q >> 2) * 4 + (lane & 3)) * 4;
      Ws[(n + 0) * kWS + k] = pre[i].x;
      Ws[(n + 1) * kWS + k] = pre[i].y;
      Ws[(n + 2) * kWS + k] = pre[i].z;
      Ws[(n + 3) * kWS + k] = pre[i].w;
    } else {
      *reinterpret_cast<float4*>(&Ws[((t >> 3) + 32 * i) * kWS + (t & 7) * 4]) = pre[i];
    }
  }
}

// One step of 4 along K for this thread's RM x 4 register tile. FULL: all four
// of its columns are live (no test).
template <int RM, bool FULL>
__device__ __forceinline__ void mma_step(const float* Ar, int lda, const float* Wr, int k4,
                                         int ni, float (&acc)[RM][kRN]) {
  float4 w[kRN];
#pragma unroll
  for (int i = 0; i < kRN; ++i) {
    w[i] = *reinterpret_cast<const float4*>(&Wr[kTN * i * kWS + 4 * k4]);
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(&Ar[kTM * r * lda + 4 * k4]);
#pragma unroll
    for (int i = 0; i < kRN; ++i) {
      if (FULL || i < ni) {
        acc[r][i] = fmaf(a.x, w[i].x, acc[r][i]);
        acc[r][i] = fmaf(a.y, w[i].y, acc[r][i]);
        acc[r][i] = fmaf(a.z, w[i].z, acc[r][i]);
        acc[r][i] = fmaf(a.w, w[i].w, acc[r][i]);
      }
    }
  }
}

// One weight tile's worth of FMAs: nk4 steps; a whole tile (all but K's last
// one, when K is no multiple of 32) is straight-line code.
template <int RM, bool FULL>
__device__ __forceinline__ void mma_tile(const float* Ar, int lda, const float* Wr, int nk4,
                                         int ni, float (&acc)[RM][kRN]) {
  if (!kFma) return;
  if (nk4 == kKT / 4) {
#pragma unroll
    for (int k4 = 0; k4 < kKT / 4; ++k4) mma_step<RM, FULL>(Ar, lda, Wr, k4, ni, acc);
  } else {
    for (int k4 = 0; k4 < nk4; ++k4) mma_step<RM, FULL>(Ar, lda, Wr, k4, ni, acc);
  }
}

// acc[r][i] = sum_k A[tm + 4 * r][k] * W(tn + 64 * i, k), k < K, for the N <=
// 256 rows of W (see fetch_tile for TRANS). A is in shared memory (row stride
// lda, 16-byte aligned rows), Wg in device memory (16-byte aligned rows; N and
// K multiples of 4). Ws is the [256][kWS] staging tile. Every thread of the
// block must call it.
//
// A warp is 8 thread columns x 4 thread rows: a 128-bit read of the weight
// tile touches 8 rows (one 128-byte wavefront, the 4 thread rows share it) and
// one of A touches 4 rows (lda = 4 mod 32 keeps them on different banks).
template <int RM, bool TRANS>
__device__ __forceinline__ void gemm_panel(const float* A, int lda,
                                           const float* __restrict__ Wg, long long ldw,
                                           int N, int K, float* Ws,
                                           float (&acc)[RM][kRN]) {
  const int t = threadIdx.x, tn = thread_col(t), tm = thread_row(t);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int i = 0; i < kRN; ++i) acc[r][i] = 0.f;
  }
  int ni = (N - tn + kTN - 1) / kTN;  // this thread's live columns
  ni = ni < 0 ? 0 : (ni > kRN ? kRN : ni);

  float4 pre[kFetch];
  if (kStream) fetch_tile<TRANS>(pre, Wg, ldw, N, K, 0, t);
  for (int kt = 0; kt < K; kt += kKT) {
    if (kStream || kt == 0) __syncthreads();  // the last tile's reads and A's writers are done
    if (kStream) {
      store_tile<TRANS>(pre, Ws, t);
      if (kt + kKT < K) fetch_tile<TRANS>(pre, Wg, ldw, N, K, kt + kKT, t);
      __syncthreads();
    }
    const int nk4 = (K - kt < kKT ? K - kt : kKT) / 4;
    const float* Ar = A + tm * lda + kt;
    const float* Wr = Ws + tn * kWS;
    if (ni == kRN) {
      mma_tile<RM, true>(Ar, lda, Wr, nk4, ni, acc);
    } else {
      mma_tile<RM, false>(Ar, lda, Wr, nk4, ni, acc);
    }
  }
}

// u[j] = bias + the 49 taps at pixel (py, px + j) of the image whose first row is
// row0 (= b * H), channel c, j < L; zeros outside the image. One row window of
// L + 6 loads feeds the 7 taps of all L outputs.
template <int L>
__device__ __forceinline__ void taps_strip(const float* __restrict__ x,
                                           const float (&wr)[kK * kK], float bias,
                                           long long row0, int py, int px, int H, int W,
                                           int C, int c, float (&u)[L]) {
  constexpr int P = kK / 2;
#pragma unroll
  for (int j = 0; j < L; ++j) u[j] = bias;
#pragma unroll
  for (int dy = 0; dy < kK; ++dy) {
    const int iy = py + dy - P;
    if (iy < 0 || iy >= H) continue;
    const float* row = x + (row0 + iy) * W * (long long)C + c;
    float v[L + kK - 1];
#pragma unroll
    for (int j = 0; j < L + kK - 1; ++j) {
      const int ix = px + j - P;
      v[j] = (ix >= 0 && ix < W) ? __ldg(row + (long long)ix * C) : 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < kK; ++dx) {
#pragma unroll
      for (int j = 0; j < L; ++j) u[j] = fmaf(v[j + dx], wr[dy * kK + dx], u[j]);
    }
  }
}

// The depthwise 7x7 + bias of the tile's pixels p0 .. p0 + M - 1 into
// us[m * ldu + c], threads along C (one coalesced 128-byte read of x per warp;
// neighbouring tiles' reads meet in L2), zeros outside the image and past the
// last pixel. A thread keeps one channel's 49 taps in registers and computes
// strips of 4 pixels of one image row from one window of 10 loads per tap row
// (70 loads per 4 outputs, not 196); with fewer than 256 channels the strips
// are dealt to 256 / C thread groups. Strip k belongs to block k % S of a
// cluster of S (rank: this block's place in it).
__device__ __forceinline__ void taps_tile(const float* __restrict__ x,
                                          const float* __restrict__ dww,
                                          const float* __restrict__ dwb, float* us, int ldu,
                                          long long p0, long long pixels, int M, int H, int W,
                                          int C, int rank, int S) {
  const int t = threadIdx.x, strips = M / kStrip;
  const int groups = C >= kThreads ? 1 : kThreads / C;
  const int g = groups == 1 ? 0 : t / C;
  for (int c = groups == 1 ? t : t % C; c < C && g < groups; c += kThreads) {
    float wr[kK * kK];
#pragma unroll
    for (int i = 0; i < kK * kK; ++i) wr[i] = __ldg(dww + (long long)c * (kK * kK) + i);
    const float bias = __ldg(dwb + c);
    for (int k = rank + S * g; kTaps && k < strips; k += S * groups) {
      const int m = k * kStrip;
      const long long p = p0 + m;
      const int px = (int)(p % W);
      if (p + kStrip <= pixels && px + kStrip <= W) {  // one image row: share the loads
        const long long by = p / W;  // b * H + y
        const int py = (int)(by % H);
        float u[kStrip];
        taps_strip<kStrip>(x, wr, bias, by - py, py, px, H, W, C, c, u);
#pragma unroll
        for (int j = 0; j < kStrip; ++j) us[(m + j) * ldu + c] = u[j];
      } else {  // the strip wraps a row or runs off the last pixel
        for (int j = 0; j < kStrip; ++j) {
          float u[1] = {0.f};
          if (p + j < pixels) {
            const long long by = (p + j) / W;
            const int py = (int)(by % H);
            taps_strip<1>(x, wr, bias, by - py, py, (int)((p + j) % W), H, W, C, c, u);
          }
          us[(m + j) * ldu + c] = u[0];
        }
      }
    }
  }
}

}  // namespace
