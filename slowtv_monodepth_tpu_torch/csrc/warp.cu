// Bilinear border-mode warp with its spatial derivatives, NHWC: float32
// sources (warp_bilinear_kernel) and bfloat16 sources in packed words
// (warp_bilinear_packed_kernel), float32 coords and outputs for both.
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
//
// The packed kernel replaces pallas_warp.py:_kernel_packed (launched by
// _warp_bilinear_packed_jit), which the training step reaches under
// `trainer.warp_bf16`: the same function on a bfloat16 source. Two channels
// share one 32-bit word there (bit halves of a float32 plane); here the
// source stays NHWC in bfloat16 as it is, with no padded copy. With an even
// channel count a corner is C / 2 aligned 32-bit words (one 8-byte load for 4
// channels); with an odd one (RGB, the training path) a corner is C 16-bit
// loads, since its pixels start on 2-byte boundaries only. A bfloat16 widens
// exactly to the float32 whose bits are `b << 16`: the low half of a word by
// a shift, the high half by a mask. The blend is kernel 5's, in float32 and
// in the same order, so on the widened source both kernels give the same
// bits. Bound: memory, as above, with half the bytes per corner; the float32
// coords and the three float32 outputs dominate.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void blend(float v00, float v01, float v10, float v11,
                                      float wx, float wy, float* o, float* gx,
                                      float* gy) {
  const float top = v00 * (1.f - wx) + v01 * wx;
  const float bot = v10 * (1.f - wx) + v11 * wx;
  *o = top * (1.f - wy) + bot * wy;
  *gx = (v01 - v00) * (1.f - wy) + (v11 - v10) * wy;
  *gy = bot - top;
}

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
    blend(__ldg(p00 + c), __ldg(p01 + c), __ldg(p10 + c), __ldg(p11 + c), wx, wy,
          o + c, gx + c, gy + c);
  }
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float bf16_at(const unsigned short* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);
}

// img: (B, H, W, C) bfloat16. For even C it is read as 32-bit words, two
// channels per word (the even channel in the low half: little endian), and
// must be 4-byte aligned (8-byte when C == 4); for odd C as 16-bit values.
// Outputs (B, HO, WO, C) float32.
__global__ void __launch_bounds__(kThreads)
warp_bilinear_packed_kernel(const unsigned short* __restrict__ img,
                            const float* __restrict__ fx,
                            const float* __restrict__ fy, float* __restrict__ out,
                            float* __restrict__ ddx, float* __restrict__ ddy,
                            int B, int H, int W, int C, int HO, int WO) {
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
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const unsigned short* base = img + b * H * (long long)W * C;
  const unsigned short* p00 = base + ((long long)y0 * W + x0) * C;
  const unsigned short* p01 = base + ((long long)y0 * W + x1) * C;
  const unsigned short* p10 = base + ((long long)y1 * W + x0) * C;
  const unsigned short* p11 = base + ((long long)y1 * W + x1) * C;
  float* o = out + i * C;
  float* gx = ddx + i * C;
  float* gy = ddy + i * C;
  if (C % 2) {  // RGB: pixels start on 2-byte boundaries, one 16-bit load per channel
    for (int c = 0; c < C; ++c) {
      blend(bf16_at(p00 + c), bf16_at(p01 + c), bf16_at(p10 + c), bf16_at(p11 + c), wx,
            wy, o + c, gx + c, gy + c);
    }
    return;
  }
  if (C == 4) {  // one 8-byte load per corner
    const uint2 u00 = __ldg(reinterpret_cast<const uint2*>(p00));
    const uint2 u01 = __ldg(reinterpret_cast<const uint2*>(p01));
    const uint2 u10 = __ldg(reinterpret_cast<const uint2*>(p10));
    const uint2 u11 = __ldg(reinterpret_cast<const uint2*>(p11));
    blend(bf16_lo(u00.x), bf16_lo(u01.x), bf16_lo(u10.x), bf16_lo(u11.x), wx, wy,
          o, gx, gy);
    blend(bf16_hi(u00.x), bf16_hi(u01.x), bf16_hi(u10.x), bf16_hi(u11.x), wx, wy,
          o + 1, gx + 1, gy + 1);
    blend(bf16_lo(u00.y), bf16_lo(u01.y), bf16_lo(u10.y), bf16_lo(u11.y), wx, wy,
          o + 2, gx + 2, gy + 2);
    blend(bf16_hi(u00.y), bf16_hi(u01.y), bf16_hi(u10.y), bf16_hi(u11.y), wx, wy,
          o + 3, gx + 3, gy + 3);
    return;
  }
  const unsigned* w00 = reinterpret_cast<const unsigned*>(p00);
  const unsigned* w01 = reinterpret_cast<const unsigned*>(p01);
  const unsigned* w10 = reinterpret_cast<const unsigned*>(p10);
  const unsigned* w11 = reinterpret_cast<const unsigned*>(p11);
  for (int k = 0; k < C / 2; ++k) {
    const unsigned u00 = __ldg(w00 + k), u01 = __ldg(w01 + k);
    const unsigned u10 = __ldg(w10 + k), u11 = __ldg(w11 + k);
    const int c = 2 * k;
    blend(bf16_lo(u00), bf16_lo(u01), bf16_lo(u10), bf16_lo(u11), wx, wy, o + c,
          gx + c, gy + c);
    blend(bf16_hi(u00), bf16_hi(u01), bf16_hi(u10), bf16_hi(u11), wx, wy, o + c + 1,
          gx + c + 1, gy + c + 1);
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

// img (B, H, W, C) bfloat16, 4-byte aligned when C is even and 8-byte when
// C == 4; fx, fy (B, HO, WO) float32 clamped to the image; out, ddx, ddy
// (B, HO, WO, C) float32. All contiguous, on `device`. Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int slowtv_warp_bilinear_packed_bf16(const void* img, const float* fx,
                                                const float* fy, float* out,
                                                float* ddx, float* ddy, int B,
                                                int H, int W, int C, int HO,
                                                int WO, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long align = C == 4 ? 7 : (C % 2 ? 1 : 3);
  if (reinterpret_cast<unsigned long long>(img) & align) return (int)cudaErrorMisalignedAddress;
  const long long n = (long long)B * HO * WO;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_bilinear_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(img), fx, fy, out, ddx, ddy, B, H, W, C, HO, WO);
  return (int)cudaGetLastError();
}
