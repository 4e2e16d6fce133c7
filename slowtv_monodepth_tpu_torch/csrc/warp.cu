// Bilinear border-mode warp with its spatial derivatives, NHWC, float32
// coords and outputs: kernel 5 on a float32 source and kernel 6 on a
// bfloat16 source, one body (warp_bilinear_kernel<T, C>).
//
// Replaces the TPU kernels slowtv_monodepth_tpu/ops/pallas_warp.py:_kernel
// (launched by _warp_bilinear_jit) and _kernel_packed (launched by
// _warp_bilinear_packed_jit, which the training step reaches under
// `trainer.warp_bf16`); entry point warp_bilinear_pallas, reached from
// ops/sample.py:grid_sample. The KBR training step runs it once per
// micro-step on the (supports x scales x batch) stack of view synthesis, and
// the aspect-ratio augmentation 4 times a batch.
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
// the 4 corners' C values (neighbouring outputs share corners: at the step's
// near-identity coords the source is read about once) and writes 3 C floats,
// with about 14 float operations per output float. At the step's (32, 384,
// 640, 3) the three outputs are 283 of the 440 MB it must move (kernel 6,
// with 2-byte source values: 393 MB).
//
// Design: a block of kThreads = 256 threads per run of kPixels = 512
// neighbouring output pixels of one image, a thread per output FLOAT.
// - The run's coords are staged once into shared memory, by 16-byte loads
//   where fx and fy are 16-byte aligned and HO WO % 4 == 0 (else float by
//   float); one barrier.
// - Float l of the run (l = thread + j kThreads, j < 2 C) is pixel l / C and
//   channel l % C; C is a template parameter, so both are a multiply and a
//   shift. A warp's 32 threads own 32 neighbouring floats of each output, so
//   every store of out, ddx and ddy covers whole sectors; the C threads of a
//   pixel read its coords as one broadcast, and a warp's corner gathers
//   cover neighbouring source pixels.
// - A thread first computes the corners of all its 2 C floats and issues
//   their 8 C gathers, then blends and stores: 8 C independent loads in
//   flight a thread.
// - Index work inside an image is 32-bit (the entries refuse an image of
//   2^31 floats or more); a block finds its image once, by one division.
// - The source type T is float (kernel 5) or unsigned short (kernel 6: a
//   bfloat16, widened exactly to the float32 whose bits are b << 16). Values
//   are read one by one, so a bfloat16 source needs only its own 2-byte
//   alignment. Both blend in float32 by the same function in the same order:
//   on the widened source the two kernels give the same bits, and each gives
//   the bits of this file's first kernels (chip_smoke.py's WARP_SHA256). Their
//   blend's sums of two products were contracted by nvcc as fma(a, b, c d);
//   written as plain expressions in this body, nvcc fused the other product,
//   so `blend` spells the first kernels' operations out in intrinsics.
// - C = 1..4 have instances of their own; any other C runs the instance
//   C = 0, the same body with C read from the arguments.
// No atomics. The launch goes through cudaLaunchKernelEx and shared memory is
// dynamic (SLOWTV_DYNAMIC_SMEM), so tests/cuda_emu builds this file for the
// CPU.
#include <climits>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 512;  // output pixels of a block: 2 C floats a thread
static_assert(kPixels % kThreads == 0 && kPixels % 4 == 0, "whole floats a thread");

template <class T>
struct WarpArgs {
  const T* img;  // (B, H, W, C)
  const float* fx;
  const float* fy;
  float* out;
  float* ddx;
  float* ddy;
  int H, W, C;
  int per_image;         // HO WO
  int blocks_per_image;  // per_image / kPixels rounded up
  int vec;               // fx, fy 16-byte aligned and HO WO % 4 == 0: coords by 16-byte loads
};

// a b + c d as nvcc contracted it in this file's first kernels: the first
// product fused with the rounded second, fma(a, b, c d). Written out, so that
// no body contracts it another way.
__device__ __forceinline__ float mix(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, __fmul_rn(c, d));
}

// top = v00 (1 - wx) + v01 wx, bot = v10 (1 - wx) + v11 wx,
// out = top (1 - wy) + bot wy, ddx = (v01 - v00)(1 - wy) + (v11 - v10) wy,
// ddy = bot - top: the first kernels' rounded operations in their order.
__device__ __forceinline__ void blend(float v00, float v01, float v10, float v11,
                                      float wx, float wy, float* o, float* gx,
                                      float* gy) {
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  const float top = mix(v00, ux, v01, wx);
  const float bot = mix(v10, ux, v11, wx);
  *o = mix(top, uy, bot, wy);
  *gx = mix(__fsub_rn(v01, v00), uy, __fsub_rn(v11, v10), wy);
  *gy = __fsub_rn(bot, top);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

// The four corners of channel c at (x, y) of an (H, W, C) image, and the
// fractional offsets. The coords are pre-clamped; clamping the indices again
// keeps a NaN coord (which converts to 0) or a caller's slip inside the image.
template <class T>
__device__ __forceinline__ void corners(const T* img, int H, int W, int C, int c, float x,
                                        float y, float* v, float* wx, float* wy) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  *wx = x - x0f;
  *wy = y - y0f;
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const int r0 = y0 * W, r1 = y1 * W;
  v[0] = widen(__ldg(img + (r0 + x0) * C + c));
  v[1] = widen(__ldg(img + (r0 + x1) * C + c));
  v[2] = widen(__ldg(img + (r1 + x0) * C + c));
  v[3] = widen(__ldg(img + (r1 + x1) * C + c));
}

template <class T, int CT>
__global__ void __launch_bounds__(kThreads) warp_bilinear_kernel(WarpArgs<T> a) {
  const int C = CT ? CT : a.C;
  SLOWTV_DYNAMIC_SMEM(smem);
  float* sx = reinterpret_cast<float*>(smem);  // [kPixels]
  float* sy = sx + kPixels;                    // [kPixels]
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int b = blk / a.blocks_per_image;  // the block's image: its one division
  const int q0 = (blk - b * a.blocks_per_image) * kPixels;
  const int n = min(kPixels, a.per_image - q0);  // pixels of the run
  const long long pix0 = (long long)b * a.per_image + q0;
  if (a.vec) {  // n is a multiple of 4: float4 i of fx, then of fy
    for (int i = tid; i < kPixels / 2; i += kThreads) {
      const int k = i % (kPixels / 4);
      if (4 * k >= n) continue;
      const float* src = (i < kPixels / 4 ? a.fx : a.fy) + pix0;
      float* dst = i < kPixels / 4 ? sx : sy;
      reinterpret_cast<float4*>(dst)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      sx[i] = __ldg(a.fx + pix0 + i);
      sy[i] = __ldg(a.fy + pix0 + i);
    }
  }
  __syncthreads();

  const T* img = a.img + (long long)b * (a.H * a.W * C);
  float* out = a.out + pix0 * C;
  float* ddx = a.ddx + pix0 * C;
  float* ddy = a.ddy + pix0 * C;
  const int nf = n * C;  // floats of the run
  if constexpr (CT > 0) {
    constexpr int kFloats = CT * kPixels / kThreads;
    float v[kFloats][4], wx[kFloats], wy[kFloats];
#pragma unroll
    for (int j = 0; j < kFloats; ++j) {  // every gather first: 4 kFloats loads in flight
      // Past the run: the last float again, not stored.
      const int l = min(tid + j * kThreads, nf - 1);
      const int p = l / CT;
      corners(img, a.H, a.W, CT, l - p * CT, sx[p], sy[p], v[j], wx + j, wy + j);
    }
#pragma unroll
    for (int j = 0; j < kFloats; ++j) {
      const int l = tid + j * kThreads;
      if (l < nf) {
        blend(v[j][0], v[j][1], v[j][2], v[j][3], wx[j], wy[j], out + l, ddx + l, ddy + l);
      }
    }
  } else {
    for (int l = tid; l < nf; l += kThreads) {
      const int p = l / C;
      float v[4], wx, wy;
      corners(img, a.H, a.W, C, l - p * C, sx[p], sy[p], v, &wx, &wy);
      blend(v[0], v[1], v[2], v[3], wx, wy, out + l, ddx + l, ddy + l);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

template <class T>
int launch(const T* img, const float* fx, const float* fy, float* out, float* ddx, float* ddy,
           int B, int H, int W, int C, int HO, int WO, int device, void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || HO < 0 || WO < 0) return (int)cudaErrorInvalidValue;
  const long long per_image = (long long)HO * WO;
  if ((long long)H * W * C > INT_MAX || per_image * C > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks_per_image = (per_image + kPixels - 1) / kPixels;
  const long long blocks = B * blocks_per_image;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WarpArgs<T> a = {img, fx, fy, out, ddx, ddy, H, W, C};
  a.per_image = (int)per_image;
  a.blocks_per_image = (int)blocks_per_image;
  a.vec = aligned16(fx) && aligned16(fy) && per_image % 4 == 0;
  void (*kernel)(WarpArgs<T>) = C == 1   ? warp_bilinear_kernel<T, 1>
                                : C == 2 ? warp_bilinear_kernel<T, 2>
                                : C == 3 ? warp_bilinear_kernel<T, 3>
                                : C == 4 ? warp_bilinear_kernel<T, 4>
                                         : warp_bilinear_kernel<T, 0>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = 2 * kPixels * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// img (B, H, W, C); fx, fy (B, HO, WO) clamped to the image; out, ddx, ddy
// (B, HO, WO, C). All float32, contiguous, on `device`; H W C and HO WO C
// below 2^31. Launches on `stream` and returns the launch's cudaError_t (0 on
// success).
extern "C" int slowtv_warp_bilinear_f32(const float* img, const float* fx,
                                        const float* fy, float* out, float* ddx,
                                        float* ddy, int B, int H, int W, int C,
                                        int HO, int WO, int device,
                                        void* stream) {
  return launch(img, fx, fy, out, ddx, ddy, B, H, W, C, HO, WO, device, stream);
}

// The same on an img of bfloat16 (any 2-byte aligned address); fx, fy, out,
// ddx, ddy float32.
extern "C" int slowtv_warp_bilinear_packed_bf16(const void* img, const float* fx,
                                                const float* fy, float* out,
                                                float* ddx, float* ddy, int B,
                                                int H, int W, int C, int HO,
                                                int WO, int device, void* stream) {
  return launch(static_cast<const unsigned short*>(img), fx, fy, out, ddx, ddy, B, H, W, C,
                HO, WO, device, stream);
}
