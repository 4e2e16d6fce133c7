// Device code shared by the fused ConvNeXt block's forward (convnext_block.cu)
// and backward (convnext_block_bwd.cu): the 7x7 depthwise taps of a pixel
// tile, the LayerNorm of its rows, a 32 x 32 tile transpose, and the product
// core `gemm_run`.
//
// gemm_run: a block of 256 threads owns a 128 x 128 output tile, each thread
// an 8 x 8 register tile (a warp 32 x 64: its 128-bit shared reads of one
// operand row are one wavefront, so 64 FMAs cost 4 shared loads); both
// operands are staged as [k][128] slabs of 32 k by 16-byte cp.async copies in
// a ring, one barrier a slab. Every operand is read K-major (row k holds the
// tile's columns, `Operand`): the launch that writes an operand writes it so.
// Float32 FMA on the CUDA cores only (no tensor cores: TF32 would change the
// exact-float32 recipe's numerics).
#pragma once
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 7;                    // depthwise taps per axis
constexpr int kStrip = 4;                // pixels per strip of the taps
constexpr float kEps = 1e-6f;            // the LayerNorm's epsilon (as the TPU kernel's)
constexpr int kBM = 128;                 // product tile rows
constexpr int kBN = 128;                 // product tile columns
constexpr int kBK = 32;                  // K per staged slab
constexpr int kLd = kBM + 4;             // padded slab row (128-bit aligned)
constexpr int kSlab = kBK * kLd;         // floats of one operand's slab
__host__ __device__ constexpr int ring_floats(int stages) { return stages * 2 * kSlab; }
constexpr int kTile = 8;                 // a thread's register tile is kTile x kTile
constexpr int kMaxGroup = 256;           // the longest float32 chain of a product's K
static_assert(kBM == kBN && kBM * kBN == kThreads * kTile * kTile, "8 x 8 per thread");
static_assert(kBK * kBM % (4 * kThreads) == 0, "whole copies a thread");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
// are dealt to 256 / C thread groups.
__device__ __forceinline__ void taps_tile(const float* __restrict__ x,
                                          const float* __restrict__ dww,
                                          const float* __restrict__ dwb, float* us, int ldu,
                                          long long p0, long long pixels, int M, int H, int W,
                                          int C) {
  const int t = threadIdx.x, strips = M / kStrip;
  const int groups = C >= kThreads ? 1 : kThreads / C;
  const int g = groups == 1 ? 0 : t / C;
  for (int c = groups == 1 ? t : t % C; c < C && g < groups; c += kThreads) {
    float wr[kK * kK];
#pragma unroll
    for (int i = 0; i < kK * kK; ++i) wr[i] = __ldg(dww + (long long)c * (kK * kK) + i);
    const float bias = __ldg(dwb + c);
    for (int k = g; k < strips; k += groups) {
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

// The LayerNorm over C of rows q < live of u (row stride ldu), one warp per
// row, two passes (the mean, then the mean squared deviation: not E[x^2] -
// E[x]^2). emit(q, c, xhat, xhat * lnw + lnb) for every value of a row, then
// done(q, rstd) on its lane 0.
template <class Emit, class Done>
__device__ __forceinline__ void layer_norm_rows(const float* u, int ldu, int live, int C,
                                                const float* __restrict__ lnw,
                                                const float* __restrict__ lnb, Emit&& emit,
                                                Done&& done) {
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < live; q += kWarps) {
    const float* uq = u + q * ldu;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += uq[c];
    const float mean = warp_sum(s) / (float)C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = uq[c] - mean;
      v = fmaf(d, d, v);
    }
    const float r = 1.f / sqrtf(warp_sum(v) / (float)C + kEps);
    for (int c = lane; c < C; c += 32) {
      const float xh = (uq[c] - mean) * r;
      emit(q, c, xh, xh * __ldg(lnw + c) + __ldg(lnb + c));
    }
    if (lane == 0) done(q, r);
  }
}

// Tile b of src (R, Q) -> dst (Q, R), 32 x 32 through u ([32][33] floats):
// tiles row-major over ceil(R / 32) x ceil(Q / 32). Every thread of the block
// calls it.
__device__ __forceinline__ void transpose_tile(const float* __restrict__ src,
                                               float* __restrict__ dst, int R, int Q, int b,
                                               float* u) {
  const int t = threadIdx.x, tq = (Q + 31) / 32;
  const int r0 = (b / tq) * 32, q0 = (b % tq) * 32;
  for (int e = t; e < 32 * 32; e += kThreads) {
    const int r = e >> 5, q = e & 31;
    if (r0 + r < R && q0 + q < Q) u[r * 33 + q] = __ldg(src + (long long)(r0 + r) * Q + q0 + q);
  }
  __syncthreads();
  for (int e = t; e < 32 * 32; e += kThreads) {
    const int r = e >> 5, q = e & 31;
    if (q0 + r < Q && r0 + q < R) dst[(long long)(q0 + r) * R + r0 + q] = u[q * 33 + r];
  }
}

// This thread's rows and columns of the 128 x 128 tile. Warp w covers rows
// 32 (w % 4) .. + 31 and columns 64 (w / 4) .. + 63; lane l owns rows
// 4 (l / 8) + {0..3} and + 16, columns 4 (l % 8) + {0..3} and + 32.
__device__ __forceinline__ int tile_row(int i) {
  const int t = threadIdx.x;
  return ((t >> 5) & 3) * 32 + (i >> 2) * 16 + ((t & 31) >> 3) * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + (j >> 2) * 32 + (t & 7) * 4 + (j & 3);
}

// A K-major operand of a product: element (k, mn) at g[k * ld + mn], the
// tile's columns from mn0, live below mn_end. Every operand is laid out so:
// the launch that writes it writes it so.
struct Operand {
  const float* g;
  long long ld;
  int mn0, mn_end;
};

// One operand's [kBK][kBM] slab, rows k0 .., into s (row stride kLd) by
// 16-byte cp.async; a warp copies one 512-byte slab row. Rows at or past
// k_end and quads starting at or past mn_end read zeros; a quad that
// straddles mn_end (the last pixel, in a row padded to a multiple of 4) reads
// the row's padding, which only reaches outputs that are not stored.
__device__ __forceinline__ void stage_slab(float* s, const Operand& o, int k0, int k_end) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kBK * kBM / 4 / kThreads; ++r) {
    const int q = t + kThreads * r, k = q / (kBM / 4), m = (q % (kBM / 4)) * 4;
    const bool in = k0 + k < k_end && o.mn0 + m < o.mn_end;
    __pipeline_memcpy_async(s + k * kLd + m,
                            in ? o.g + (long long)(k0 + k) * o.ld + o.mn0 + m : o.g, 16,
                            in ? 0 : 16);
  }
}

__device__ __forceinline__ void stage_pair(float* As, float* Bs, const Operand& a,
                                           const Operand& b, int k0, int k_end) {
  stage_slab(As, a, k0, k_end);
  stage_slab(Bs, b, k0, k_end);
}

// acc += the slab pair's kBK k for this thread's 8 x 8: per k four 128-bit
// shared reads (A's two row quads, B's two column quads) and 64 FMAs.
__device__ __forceinline__ void mma_slab(const float* As, const float* Bs,
                                         float (&acc)[kTile][kTile]) {
  const int t = threadIdx.x;
  const int am = ((t >> 5) & 3) * 32 + ((t & 31) >> 3) * 4, bn = (t >> 7) * 64 + (t & 7) * 4;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLd + am);
    const float4 a1 = *reinterpret_cast<const float4*>(As + k * kLd + am + 16);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kLd + bn);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kLd + bn + 32);
    const float a[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
  }
}

// The product core. From acc = 0, nk slabs: stage(i, As, Bs) issues slab i's
// copies (STAGES - 1 slabs ahead of the FMAs), acc += slab i for this
// thread's 8 x 8 of the 128 x 128 tile (tile_row, tile_col), one float32
// chain per output in k order; after slab i, when i + 1 is a multiple of
// per_chain or i + 1 == nk, chain(i) takes acc (and may reset it). The ring
// (ring_floats(STAGES) of shared memory) keeps flowing across chains. Every
// thread of the block calls it.
template <int STAGES, class Stage, class Chain>
__device__ __forceinline__ void gemm_run(int nk, int per_chain, float* ring,
                                         float (&acc)[kTile][kTile], Stage&& stage,
                                         Chain&& chain) {
  zero(acc);
  __syncthreads();  // the ring's last readers are done
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s, ring + 2 * s * kSlab, ring + (2 * s + 1) * kSlab);
    __pipeline_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    __pipeline_wait_prior(STAGES - 2);  // slab kt has landed (this thread's copies)
    __syncthreads();                     // ... and everyone's; slab kt - 1 is read
    const int next = kt + STAGES - 1, s = next % STAGES;
    if (next < nk) stage(next, ring + 2 * s * kSlab, ring + (2 * s + 1) * kSlab);
    __pipeline_commit();
    const float* slab = ring + 2 * (kt % STAGES) * kSlab;
    mma_slab(slab, slab + kSlab, acc);
    if ((kt + 1) % per_chain == 0 || kt + 1 == nk) chain(kt);
  }
}

// Rows of K per split: ceil(n / splits) rounded up to the 32-deep slab (the
// host's plans, ops/convnext_block.py _split_len, use the same).
__host__ __device__ __forceinline__ long long split_len(long long n, int splits) {
  return ((n + splits - 1) / splits + kBK - 1) / kBK * kBK;
}

// Launch `kernel` on a 1-D grid of kThreads-thread blocks with `smem` bytes of
// dynamic shared memory, in clusters of `cluster` blocks (0: no cluster
// attribute), on stream s.
template <class K, class... Args>
cudaError_t launch(K kernel, unsigned grid, size_t smem, int cluster, cudaStream_t s,
                   Args... args) {
  // Above 48 KB shared memory is dynamic and has to be asked for, or the
  // launch is refused (as it is above what the card allows).
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
