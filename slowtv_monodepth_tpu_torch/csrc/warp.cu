// Bilinear border-mode warp with its spatial derivatives, float32, NHWC.
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_warp.py:_kernel
// (launched by _warp_bilinear_jit); entry point warp_bilinear_pallas, reached
// from ops/sample.py:grid_sample. The KBR training step runs it once per
// micro-step on the (supports x scales x batch) stack of view synthesis.
//
// For each output pixel with continuous source coords (fx, fy), already
// clamped to [0, w-1] x [0, h-1] by the caller, and every channel:
//   out = bilinear sample at (fx, fy), corners x1 = min(x0 + 1, w - 1) and
//         y1 = min(y0 + 1, h - 1) (border semantics, as the TPU kernel);
//   ddx = d(out)/d(fx) = (v01 - v00)(1 - wy) + (v11 - v10) wy;
//   ddy = d(out)/d(fy) = bot - top.
// The grid gradient of the autograd Function is then an elementwise product.
//
// Bound on Hopper: memory. Per output pixel it reads 8 bytes of coords and
// 4 corners of c floats (through L1/L2: one 384x640x3 float32 source is
// 2.9 MB and neighbouring outputs share corners) and writes 3c floats.
//
// Design: the TPU kernel scans the source tiles a warp touches because a TPU
// has no cheap gather; on Hopper a direct gather is the natural form. One
// thread per output pixel handles all c channels, so the coords are read
// once and the four corner addresses are computed once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ img, const float* __restrict__ fx,
                     const float* __restrict__ fy, float* __restrict__ out,
                     float* __restrict__ ddx, float* __restrict__ ddy, int B,
                     int H, int W, int C, int HO, int WO) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long per_image = (long long)HO * WO;
  if (i >= B * per_image) return;
  const long long b = i / per_image;
  const float x = fx[i];
  const float y = fy[i];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  // The coords are pre-clamped; clamping the indices again keeps a NaN coord
  // (which converts to 0) or a caller's slip inside the image.
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const float* base = img + b * H * (long long)W * C;
  const float* p00 = base + ((long long)y0 * W + x0) * C;
  const float* p01 = base + ((long long)y0 * W + x1) * C;
  const float* p10 = base + ((long long)y1 * W + x0) * C;
  const float* p11 = base + ((long long)y1 * W + x1) * C;
  float* o = out + i * C;
  float* gx = ddx + i * C;
  float* gy = ddy + i * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(p00 + c), v01 = __ldg(p01 + c);
    const float v10 = __ldg(p10 + c), v11 = __ldg(p11 + c);
    const float top = v00 * (1.f - wx) + v01 * wx;
    const float bot = v10 * (1.f - wx) + v11 * wx;
    o[c] = top * (1.f - wy) + bot * wy;
    gx[c] = (v01 - v00) * (1.f - wy) + (v11 - v10) * wy;
    gy[c] = bot - top;
  }
}

}  // namespace

// img (B, H, W, C); fx, fy (B, HO, WO) clamped to the image; out, ddx, ddy
// (B, HO, WO, C). All float32, contiguous, on `device`. Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int slowtv_warp_bilinear_f32(const float* img, const float* fx,
                                        const float* fy, float* out, float* ddx,
                                        float* ddy, int B, int H, int W, int C,
                                        int HO, int WO, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * HO * WO;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_bilinear_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, fx, fy, out, ddx, ddy, B, H, W, C, HO, WO);
  return (int)cudaGetLastError();
}
