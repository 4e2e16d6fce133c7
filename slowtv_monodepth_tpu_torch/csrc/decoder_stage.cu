// One skip-less Monodepth decoder stage, forward, float32, NHWC activations,
// PyTorch OIHW (co, ci, 3, 3) weights:
//
//   ha   = ELU(conv3x3_reflect(x, wa) + ba)            (B, H, W, CD)
//   u    = upsample2x_nearest(ha)                      (never stored)
//   feat = ELU(conv3x3_reflect(u, wb) + bb)            (B, 2H, 2W, CD)
//   disp = sigmoid(conv3x3_reflect(feat, wo) + bo)     (B, 2H, 2W, 1)
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_decoder.py:_fwd_kernel
// (launched by _stage_fwd_jit); entry point fused_upconv_stage. The KBR
// decoder runs it for its two full-resolution stages (scales 1 and 0).
//
// Bound on Hopper: at 16-32 channels the convs do about 2*9*CI multiply-adds
// per output value against 4*CI bytes of input per pixel, so with the input
// reused from L1 they sit on the fp32 pipe rather than on device memory; the
// one avoidable memory stream is the 4x larger upsampled activation u.
//
// Design: three launches of one templated direct 3x3 conv kernel with an
// activation epilogue, on the caller's stream.
// - u is never written: the second launch reads ha through the up2 index
//   map. Reflection happens on the upsampled grid first and the index is
//   halved after: u[-1] = u[1] = ha[0] and u[2H] = u[2H-2] = ha[H-1].
//   (Reflecting ha and then upsampling would give u[-1] = ha[1]: wrong.)
// - The disp launch reflects feat on its own grid.
// - One thread computes COT output channels of one pixel. The block's
//   weight tile [9*CI][COT] sits in shared memory, reordered from OIHW when
//   it is loaded; every lane of a warp reads the same weight address (a
//   broadcast) and its own pixel's CI inputs, four at a time when CI % 4 == 0
//   and x is 16-byte aligned (a contiguous view may start at any float).
// - ha is a scratch buffer the caller allocates; feat and disp are outputs.
// Later work: tensor-core (TF32/bf16) tiles and keeping ha in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFeatTile = 16;  // output channels per thread for ha and feat
constexpr int kElu = 0;
constexpr int kSigmoid = 1;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <int COT>
__device__ __forceinline__ void fma_row(float (&acc)[COT], float v,
                                        const float* wrow) {
#pragma unroll
  for (int co = 0; co < COT; ++co) acc[co] = fmaf(v, wrow[co], acc[co]);
}

// x (B, Hin, Win, CI) -> out (B, Hout, Wout, CO) with (Hout, Wout) =
// UP ? (2Hin, 2Win) : (Hin, Win); blockIdx.y picks the COT-channel tile.
template <int COT, bool UP, int ACT>
__global__ void __launch_bounds__(kThreads)
conv3x3_reflect_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int B, int Hin, int Win,
                       int CI, int CO) {
  extern __shared__ float s_w[];  // [9 * CI][COT]
  const int co0 = blockIdx.y * COT;
  for (int i = threadIdx.x; i < 9 * CI * COT; i += kThreads) {
    const int col = i % COT;
    const int r = i / COT;  // tap * CI + ci
    const int tap = r / CI;
    const int ci = r - tap * CI;
    const int co = co0 + col;
    s_w[i] = (co < CO) ? w[((long long)co * CI + ci) * 9 + tap] : 0.f;
  }
  __syncthreads();

  const int Hout = UP ? 2 * Hin : Hin;
  const int Wout = UP ? 2 * Win : Win;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)B * Hout * Wout) return;
  const int ox = (int)(p % Wout);
  const long long t = p / Wout;
  const int oy = (int)(t % Hout);
  const long long b = t / Hout;

  float acc[COT];
#pragma unroll
  for (int co = 0; co < COT; ++co) {
    acc[co] = (co0 + co < CO) ? __ldg(bias + co0 + co) : 0.f;
  }
  // float4 loads need every pixel's CI values 16-byte aligned.
  const bool vec4 = (CI & 3) == 0 &&
                    (reinterpret_cast<unsigned long long>(x) & 15) == 0;

#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    int sy = reflect(oy + ky - 1, Hout);
    if (UP) sy >>= 1;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      int sx = reflect(ox + kx - 1, Wout);
      if (UP) sx >>= 1;
      const float* xp = x + ((b * Hin + sy) * Win + sx) * (long long)CI;
      const float* wp = s_w + (ky * 3 + kx) * CI * COT;
      if (vec4) {
        for (int ci = 0; ci < CI; ci += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xp + ci));
          fma_row<COT>(acc, v.x, wp + (ci + 0) * COT);
          fma_row<COT>(acc, v.y, wp + (ci + 1) * COT);
          fma_row<COT>(acc, v.z, wp + (ci + 2) * COT);
          fma_row<COT>(acc, v.w, wp + (ci + 3) * COT);
        }
      } else {
        for (int ci = 0; ci < CI; ++ci) {
          fma_row<COT>(acc, __ldg(xp + ci), wp + ci * COT);
        }
      }
    }
  }

  float* op = out + p * CO + co0;
#pragma unroll
  for (int co = 0; co < COT; ++co) {
    if (co0 + co < CO) {
      const float z = acc[co];
      op[co] = (ACT == kElu) ? (z > 0.f ? z : expm1f(z))
                             : 1.f / (1.f + expf(-z));
    }
  }
}

template <int COT, bool UP, int ACT>
cudaError_t launch_conv(const float* x, const float* w, const float* bias,
                        float* out, int B, int Hin, int Win, int CI, int CO,
                        cudaStream_t s) {
  auto kernel = conv3x3_reflect_kernel<COT, UP, ACT>;
  const int smem = 9 * CI * COT * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long pixels = (long long)B * Hin * Win * (UP ? 4 : 1);
  const dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads),
                  (unsigned)((CO + COT - 1) / COT));
  kernel<<<grid, kThreads, smem, s>>>(x, w, bias, out, B, Hin, Win, CI, CO);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, CI); wa (CD, CI, 3, 3), ba (CD); wb (CD, CD, 3, 3), bb (CD);
// wo (1, CD, 3, 3), bo (1); scratch ha (B, H, W, CD); outputs feat
// (B, 2H, 2W, CD) and disp (B, 2H, 2W, 1). All float32, contiguous, on
// `device`; H, W >= 2. Three launches on `stream`; returns the first
// failing cudaError_t, 0 on success.
extern "C" int slowtv_decoder_stage_fwd_f32(
    const float* x, const float* wa, const float* ba, const float* wb,
    const float* bb, const float* wo, const float* bo, float* ha, float* feat,
    float* disp, int B, int H, int W, int CI, int CD, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_conv<kFeatTile, false, kElu>(x, wa, ba, ha, B, H, W, CI, CD, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<kFeatTile, true, kElu>(ha, wb, bb, feat, B, H, W, CD, CD, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_conv<1, false, kSigmoid>(feat, wo, bo, disp, B, 2 * H,
                                              2 * W, CD, 1, s);
}
