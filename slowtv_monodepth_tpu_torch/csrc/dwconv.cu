// Depthwise KxK convolution, stride 1, zero 'SAME' padding, fused bias, and
// its tap gradient. Float32, NHWC activations, PyTorch (C, 1, K, K) taps.
//
// Forward: replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_dwconv.py:
// _fwd_kernel (launched by _dwconv_fwd_jit); entry point depthwise_conv.
// Every ConvNeXt block's 7x7 depthwise conv runs here: 36 launches per
// ConvNeXt-B forward. The input gradient is the same kernel run on the
// cotangent with the taps flipped (stride-1 'SAME' depthwise conv is its own
// transpose up to the flip), as pallas_dwconv.py:_dwconv_core_bwd does.
//
// Tap gradient (second half of this file): replaces the TPU kernel
// pallas_dwconv.py:_dw_kernel (launched by _dwconv_dw_jit).
//
// Bound on Hopper: memory. Per output element it does K*K multiply-adds and
// needs one input value once the halo is reused from L1/L2, so device memory
// sees roughly one read of the input and one write of the output (tens of
// MB at 384x640), far below the 295 flop/byte line.
//
// Design:
// - One block covers 32 neighbouring channels (threadIdx.x) and 8 pixel
//   strips (threadIdx.y). A warp therefore loads 32 consecutive floats of
//   one pixel: one coalesced 128-byte request, the NHWC analogue of the
//   TPU kernel's 128-lane channel blocks.
// - The block's taps are copied from the (C, K*K) PyTorch layout into
//   shared memory as [K*K][32] (the copy reads contiguous addresses, the
//   compute reads conflict-free rows), and the bias with them.
// - Each thread computes kStrip outputs along W and keeps the K + kStrip - 1
//   input values of one row in registers, so each loaded value feeds up to K
//   taps: K*(K+kStrip-1) loads per kStrip outputs instead of K*K per output.
// - The zero padding is a bounds test on each load; the TPU kernel padded
//   the input in device memory instead.
// Later work: a shared-memory row tile and float4 channel loads.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // channels per block (one warp)
constexpr int kRows = 8;    // pixel strips per block (warps per block)
constexpr int kStrip = 4;   // outputs per thread along W

template <int K>
__global__ void __launch_bounds__(kLanes * kRows)
dwconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int B, int H, int W, int C) {
  __shared__ float s_w[K * K][kLanes];
  __shared__ float s_b[kLanes];
  const int c0 = blockIdx.y * kLanes;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < kLanes * K * K; i += kLanes * kRows) {
    const int cl = i / (K * K);
    const int t = i - cl * (K * K);
    s_w[t][cl] = (c0 + cl < C) ? w[(long long)(c0 + cl) * (K * K) + t] : 0.f;
  }
  if (tid < kLanes) {
    s_b[tid] = (bias != nullptr && c0 + tid < C) ? bias[c0 + tid] : 0.f;
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  const int strips = (W + kStrip - 1) / kStrip;
  const long long item = (long long)blockIdx.x * kRows + threadIdx.y;
  if (c >= C || item >= (long long)B * H * strips) return;
  const int x0 = (int)(item % strips) * kStrip;
  const long long by = item / strips;  // b * H + y
  const int y = (int)(by % H);
  const long long row0 = by - y;       // b * H

  constexpr int P = K / 2;
  float acc[kStrip];
#pragma unroll
  for (int r = 0; r < kStrip; ++r) acc[r] = s_b[threadIdx.x];

#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int iy = y + dy - P;
    if (iy < 0 || iy >= H) continue;
    const float* row = x + (row0 + iy) * W * (long long)C + c;
    float v[kStrip + K - 1];
#pragma unroll
    for (int j = 0; j < kStrip + K - 1; ++j) {
      const int ix = x0 + j - P;
      v[j] = (ix >= 0 && ix < W) ? __ldg(row + (long long)ix * C) : 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float wv = s_w[dy * K + dx][threadIdx.x];
#pragma unroll
      for (int r = 0; r < kStrip; ++r) acc[r] = fmaf(v[r + dx], wv, acc[r]);
    }
  }

  float* o = out + (by * W + x0) * (long long)C + c;
#pragma unroll
  for (int r = 0; r < kStrip; ++r) {
    if (x0 + r < W) o[(long long)r * C] = acc[r];
  }
}

template <int K>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int H, int W, int C, cudaStream_t s) {
  const long long items = (long long)B * H * ((W + kStrip - 1) / kStrip);
  const dim3 block(kLanes, kRows);
  const dim3 grid((unsigned)((items + kRows - 1) / kRows),
                  (unsigned)((C + kLanes - 1) / kLanes));
  dwconv_fwd_kernel<K><<<grid, block, 0, s>>>(x, w, bias, out, B, H, W, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tap gradient
// dw[c, 0, ky, kx] = sum_{b, y, x} xpad[b, y + ky, x + kx, c] * g[b, y, x, c],
// xpad the zero-padded input: a reduction over B*H*W for each of the K*K*C
// taps.
//
// Bound on Hopper: by its bytes, memory: it reads x and g once each (plus
// the K-1 row halo from L1/L2) and does K*K multiply-adds per element pair.
// As written it is issue-bound instead (PERF.md): each thread carries K*K
// accumulators and issues K*(K+kStrip-1) loads per work item.
//
// Design: the TPU kernel carried the sum across its sequential grid in the
// resident output block; Hopper's blocks run in parallel and in no order, so
// the reduction is a deterministic two-pass one, with no atomics:
// - pass 1: `nblk` blocks per 32-channel group each walk a fixed, strided
//   share of the (b, y, x-strip) work items. A thread keeps all K*K partial
//   sums of its channel in registers, and, as the forward does, computes
//   kStrip outputs along W from one row window of K + kStrip - 1 inputs. The
//   block's 8 rows are summed in shared memory in a fixed order and written
//   to partial[blk][K*K][C] (a torch.empty scratch from the wrapper);
// - pass 2: one thread per (tap, channel) sums its nblk partials in block
//   order and writes the tap in PyTorch's (C, 1, K, K) layout.
// The result is the same from run to run.

constexpr int kDwRows = 8;  // work-item rows per block (warps per block)

template <int K>
__global__ void __launch_bounds__(kLanes * kDwRows)
dwconv_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ partial, int B, int H, int W, int C,
                         int nblk) {
  constexpr int P = K / 2;
  __shared__ float s_sum[kDwRows][K][kLanes];
  const int c0 = blockIdx.y * kLanes;
  const int c = c0 + threadIdx.x;
  const int strips = (W + kStrip - 1) / kStrip;
  const long long items = (long long)B * H * strips;

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

  if (c < C) {
    for (long long item = (long long)blockIdx.x * kDwRows + threadIdx.y; item < items;
         item += (long long)nblk * kDwRows) {
      const int x0 = (int)(item % strips) * kStrip;
      const long long by = item / strips;  // b * H + y
      const int y = (int)(by % H);
      const long long row0 = by - y;       // b * H
      float gv[kStrip];
      const float* grow = g + (by * W + x0) * (long long)C + c;
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        gv[r] = (x0 + r < W) ? __ldg(grow + (long long)r * C) : 0.f;
      }
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int iy = y + dy - P;
        if (iy < 0 || iy >= H) continue;
        const float* row = x + (row0 + iy) * W * (long long)C + c;
        float v[kStrip + K - 1];
#pragma unroll
        for (int j = 0; j < kStrip + K - 1; ++j) {
          const int ix = x0 + j - P;
          v[j] = (ix >= 0 && ix < W) ? __ldg(row + (long long)ix * C) : 0.f;
        }
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
          for (int r = 0; r < kStrip; ++r) {
            acc[dy * K + dx] = fmaf(v[r + dx], gv[r], acc[dy * K + dx]);
          }
        }
      }
    }
  }

  // Sum the block's kDwRows partials per tap in a fixed order, one tap row
  // (K taps) at a time to keep shared memory small.
  const int tid = threadIdx.y * kLanes + threadIdx.x;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) s_sum[threadIdx.y][dx][threadIdx.x] = acc[dy * K + dx];
    __syncthreads();
    for (int i = tid; i < K * kLanes; i += kLanes * kDwRows) {
      const int dx = i / kLanes, lane = i - dx * kLanes;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kDwRows; ++r) s += s_sum[r][dx][lane];
      if (c0 + lane < C) {
        partial[((long long)blockIdx.x * K * K + dy * K + dx) * C + c0 + lane] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void dwconv_dw_sum_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dw, int nblk, int KK,
                                     int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // t * C + c
  if (i >= (long long)KK * C) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += partial[(long long)b * KK * C + i];
  const int t = (int)(i / C), c = (int)(i - (long long)t * C);
  dw[(long long)c * KK + t] = s;
}

template <int K>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* dw,
                      int B, int H, int W, int C, int nblk, cudaStream_t s) {
  const dim3 block(kLanes, kDwRows);
  const dim3 grid((unsigned)nblk, (unsigned)((C + kLanes - 1) / kLanes));
  dwconv_dw_partial_kernel<K><<<grid, block, 0, s>>>(x, g, partial, B, H, W, C, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)K * K * C;
  dwconv_dw_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, dw, nblk,
                                                                    K * K, C);
  return cudaGetLastError();
}

}  // namespace

// x, g (B, H, W, C) -> dw (C, 1, K, K), through partial (nblk, K*K, C)
// scratch; all float32, contiguous, on `device`. Two launches on `stream`;
// returns the first failing launch's cudaError_t (0 on success).
extern "C" int slowtv_dwconv_dw_f32(const float* x, const float* g, float* partial,
                                    float* dw, int B, int H, int W, int C, int K,
                                    int nblk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch_dw<1>(x, g, partial, dw, B, H, W, C, nblk, s);
    case 3: return (int)launch_dw<3>(x, g, partial, dw, B, H, W, C, nblk, s);
    case 5: return (int)launch_dw<5>(x, g, partial, dw, B, H, W, C, nblk, s);
    case 7: return (int)launch_dw<7>(x, g, partial, dw, B, H, W, C, nblk, s);
    case 9: return (int)launch_dw<9>(x, g, partial, dw, B, H, W, C, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (B, H, W, C), w (C, 1, K, K), bias (C,) or NULL, out (B, H, W, C); all
// float32, contiguous, on `device`. Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int slowtv_dwconv_fwd_f32(const float* x, const float* w,
                                     const float* bias, float* out, int B,
                                     int H, int W, int C, int K, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return (int)launch<1>(x, w, bias, out, B, H, W, C, s);
    case 3: return (int)launch<3>(x, w, bias, out, B, H, W, C, s);
    case 5: return (int)launch<5>(x, w, bias, out, B, H, W, C, s);
    case 7: return (int)launch<7>(x, w, bias, out, B, H, W, C, s);
    case 9: return (int)launch<9>(x, w, bias, out, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
