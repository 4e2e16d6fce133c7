// What the two photometric kernels share: photo.cu (kernel 7, the SSIM + L1
// error map) and photo_bwd.cu (kernel 8, its backward). The SSIM constants,
// explicitly rounded float operations (never contracted into an FMA unless
// asked for by fmadd), the reflect map of the 3x3 pool's 1-pixel pad, and the
// staging of one image row of x and y into shared memory.
#pragma once
#include <cfloat>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// v / D rounded to nearest: the same bits as __fdiv_rn(v, D) for every float
// v (NaN gives NaN), without the IEEE division's slow-path branch. The product
// by the rounded reciprocal is corrected once by its remainder, which an FMA
// computes exactly (checked over all 2^32 floats for D = 1, 2, 3, 4 and 9:
// tools/photo_bench.py exact). The remainder is taken as D q - v so that -0
// stays -0, and the min makes the NaN remainder of v = +-inf finite, so that
// +-inf stays +-inf.
template <int D>
__device__ __forceinline__ float div_rn(float v) {
  constexpr float r = 1.f / D;
  const float q = mul(v, r);
  return fmadd(-fminf(fmadd((float)D, q, -v), FLT_MAX), r, q);
}

// Reflect (edge not repeated) for the pad, then clamp: positions past the pad
// only feed pooled positions outside the image, which are never used.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Floats of a staged row of `pixels` pixels of C channels: + 3 for the shift
// that aligns its 16-byte copies, rounded up to 16 bytes.
__host__ __device__ constexpr int row_floats(int pixels, int C) { return (pixels * C + 6) / 4 * 4; }

// One staged row of x and y: pixels col0 .. col0 + N - 1 (col0 may be
// negative) of the image row whose first pixel is `row_base`, all C channels,
// at xd, yd, as they lie in memory. The in-image part of the row is one
// contiguous run: by 16-byte cp.async where `vec` (x and y 16-byte aligned
// and W C % 4 == 0; the caller shifts xd, yd so that the copies land on 16
// bytes), else float by float. Only the pixels past the image's edges go
// through the reflect map. Lanes of one warp; the copies land at the
// caller's __pipeline_wait_prior.
template <int C, int N>
__device__ __forceinline__ void stage_row(const float* x, const float* y, int W, int vec,
                                          long long row_base, int col0, float* xd, float* yd,
                                          int lane) {
  const long long g0 = (row_base + col0) * C;   // staged float 0 (may lie before the row)
  const int pl = col0 < 0 ? -col0 : 0;           // staged pixels left of the image
  const int pr = W - col0 < N ? W - col0 : N;    // the first one right of it
  const int fa = pl * C, fb = pr * C;            // the contiguous in-image floats
  if (vec) {
    const int sh = (int)(g0 & 3);
    int f0 = fa + ((4 - ((sh + fa) & 3)) & 3);   // the first 16-byte aligned float
    f0 = f0 < fb ? f0 : fb;
    const int n4 = (fb - f0) >> 2;
    for (int i = lane; i < n4; i += 32) {
      const int f = f0 + 4 * i;
      __pipeline_memcpy_async(xd + f, x + (g0 + f), 16);
      __pipeline_memcpy_async(yd + f, y + (g0 + f), 16);
    }
    // The ends: at most 3 floats before f0 (lanes 0-3), 3 after (lanes 4-7).
    const int f1 = f0 + 4 * n4;
    const int f = lane < 4 ? fa + lane : f1 + lane - 4;
    if (lane < 8 && f < (lane < 4 ? f0 : fb)) {
      xd[f] = __ldg(x + (g0 + f));
      yd[f] = __ldg(y + (g0 + f));
    }
  } else {
    for (int f = fa + lane; f < fb; f += 32) {
      xd[f] = __ldg(x + (g0 + f));
      yd[f] = __ldg(y + (g0 + f));
    }
  }
  // Staged pixels past the image's edges, through the reflect map.
  const int nout = pl + N - pr;
  for (int i = lane; i < nout; i += 32) {
    const int p = i < pl ? i : pr + i - pl;
    const long long src = (row_base + reflect(col0 + p, W)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xd[p * C + c] = __ldg(x + src + c);
      yd[p * C + c] = __ldg(y + src + c);
    }
  }
}

}  // namespace
