// One skip-less Monodepth decoder stage, backward, float32, NHWC activations,
// PyTorch OIHW (co, ci, 3, 3) weights. The forward (decoder_stage.cu) is
//
//   ha   = ELU(conv3x3_reflect(x, wa) + ba)            (B, H, W, CD)
//   u    = upsample2x_nearest(ha)                      (never stored)
//   feat = ELU(conv3x3_reflect(u, wb) + bb)            (B, 2H, 2W, CD)
//   disp = sigmoid(conv3x3_reflect(feat, wo) + bo)     (B, 2H, 2W, 1)
//
// and this file computes its vector-Jacobian product: dx, dwa, dba, dwb, dbb,
// dwo, dbo from the cotangents g_feat and g_disp.
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_decoder.py:_bwd_kernel
// (launched by _stage_bwd_jit); reached from the autograd Function behind
// fused_upconv_stage. The KBR training step runs it for the decoder's two
// full-resolution stages (scales 1 and 0), once per micro-step each.
//
// The TPU kernel walks row bands in order, recomputes ha / feat per band and
// carries dx rows and weight-gradient sums from one band to the next. Here
// blocks run in parallel and nothing carries over, so the forward's ha, feat
// and disp are inputs (nothing is recomputed) and the chain is
//
//   dzo  = g_disp * disp * (1 - disp)                          elementwise
//   dwo, dbo = sum_pixels reflect_pad(feat) (x) dzo            weight gradient
//   dzb  = (g_feat + conv3x3^T(dzo, wo)) * elu'(feat)          input gradient
//   dwb, dbb = sum_pixels reflect_pad(u) (x) dzb               weight gradient
//   dza  = (2x2 sum of conv3x3^T(dzb, wb)) * elu'(ha)          input gradient
//   dwa, dba = sum_pixels reflect_pad(x) (x) dza               weight gradient
//   dx   = conv3x3^T(dza, wa)                                  input gradient
//
// with elu'(h) = h > 0 ? 1 : h + 1 taken from the stored OUTPUT of the ELU.
//
// Bound on Hopper: operations. At 16-64 channels each gradient does
// 2 * 9 * CI * CO FLOP per pixel against a few hundred bytes per pixel, on
// the float32 pipe (no tensor cores yet): conv_b's two gradients on the
// upsampled grid dominate.
//
// Design.
// - Input gradients are GATHERS: one thread per INPUT pixel (and per tile of
//   16 input channels) collects dz[q] * w[tap] from every output pixel q
//   whose tap read it, the reflected reads included, so there are no atomics
//   and the bits are the same every run. Each conv reflects on its own grid:
//   conv_b on the upsampled (2H, 2W) grid, where padded row -1 is row 1 and
//   padded row 2H is row 2H - 2; `tap_pair` lists, for an input row Y, the up
//   to five (output row, tap) pairs that read it (three direct ones, plus
//   row 0's tap 0 when Y == 1 and row n-1's tap 2 when Y == n - 2; for n of 2
//   or 3 a fold lands on a row that also has direct reads, which the list
//   handles as any other pair). Columns the same. With the up2 index map the
//   thread of ha pixel (y, x) sums the gathers of its four u pixels.
// - Weight gradients are reductions over all pixels into (9, CI, CO) numbers:
//   each block owns one tap, one 32 x COT tile of (ci, co) and one chunk of
//   pixels, stages 64 pixels' inputs and dz at a time in shared memory, keeps
//   its sums in registers and writes them to a scratch buffer; a second
//   kernel adds the chunks in a fixed order (deterministic, as the dwconv
//   tap gradient). The bias gradient rides along in the centre tap's blocks.
// Later work: tensor-core tiles for both, and folding the 36 gathered taps of
// the up2 stage into 16 with pre-summed weights.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInTile = 16;    // input channels per thread in the input gradients
constexpr int kPix = 64;       // pixels staged per iteration in the weight gradient
constexpr int kCiTile = 32;    // input channels per block in the weight gradient
constexpr int kTargetBlocks = 1056;  // about 8 blocks per SM

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The s-th (output index q, tap k) pair whose reflect-padded read
// reflect(q + k - 1, n) lands on input index y; false when slot s is empty.
__device__ __forceinline__ bool tap_pair(int s, int y, int n, int& q, int& k) {
  if (s < 3) {
    q = y + s - 1;
    k = 2 - s;
    return q >= 0 && q < n;
  }
  if (s == 3) {
    q = 0;
    k = 0;
    return y == 1;
  }
  q = n - 1;
  k = 2;
  return y == n - 2;
}

__device__ __forceinline__ float elu_grad(float h) {
  return h > 0.f ? 1.f : h + 1.f;
}

__global__ void __launch_bounds__(kThreads)
sigmoid_grad_kernel(const float* __restrict__ g, const float* __restrict__ s,
                    float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const float d = s[i];
    out[i] = g[i] * d * (1.f - d);
  }
}

// Gradient of y = conv3x3_reflect(UP ? up2(in) : in, w) w.r.t. `in`:
//   out[p, ci] = (add ? add[p, ci] : 0) + sum over the pixels P of the conv's
//                input grid that map to p (four with UP, else p itself) and
//                over every (q, tap) that read P of sum_co dz[q, co] * w[co, ci, tap]
//   out[p, ci] *= elu'(act[p, ci])   when act is given.
// dz (B, Hout, Wout, CO) with (Hout, Wout) = UP ? (2Hin, 2Win) : (Hin, Win);
// add, act, out (B, Hin, Win, CI); blockIdx.y picks the kInTile-channel tile.
template <bool UP>
__global__ void __launch_bounds__(kThreads)
conv3x3_reflect_input_grad_kernel(const float* __restrict__ dz,
                                  const float* __restrict__ w,
                                  const float* __restrict__ add,
                                  const float* __restrict__ act,
                                  float* __restrict__ out, int B, int Hin,
                                  int Win, int CI, int CO) {
  extern __shared__ float s_w[];  // [9][CO][kInTile]
  const int ci0 = blockIdx.y * kInTile;
  for (int i = threadIdx.x; i < 9 * CO * kInTile; i += kThreads) {
    const int j = i % kInTile;
    const int r = i / kInTile;  // tap * CO + co
    const int tap = r / CO;
    const int co = r - tap * CO;
    const int ci = ci0 + j;
    s_w[i] = (ci < CI) ? w[((long long)co * CI + ci) * 9 + tap] : 0.f;
  }
  __syncthreads();

  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)B * Hin * Win) return;
  const int x = (int)(p % Win);
  const long long t = p / Win;
  const int y = (int)(t % Hin);
  const long long b = t / Hin;
  const int Hout = UP ? 2 * Hin : Hin;
  const int Wout = UP ? 2 * Win : Win;
  const int sub = UP ? 2 : 1;
  const bool vec4 = (CO & 3) == 0 &&
                    (reinterpret_cast<unsigned long long>(dz) & 15) == 0;

  float acc[kInTile];
#pragma unroll
  for (int j = 0; j < kInTile; ++j) acc[j] = 0.f;

  for (int a = 0; a < sub; ++a) {
    const int Y = UP ? 2 * y + a : y;
    for (int sy = 0; sy < 5; ++sy) {
      int qy, ky;
      if (!tap_pair(sy, Y, Hout, qy, ky)) continue;
      for (int c = 0; c < sub; ++c) {
        const int X = UP ? 2 * x + c : x;
        for (int sx = 0; sx < 5; ++sx) {
          int qx, kx;
          if (!tap_pair(sx, X, Wout, qx, kx)) continue;
          const float* dzp = dz + ((b * Hout + qy) * Wout + qx) * (long long)CO;
          const float* wp = s_w + (ky * 3 + kx) * CO * kInTile;
          if (vec4) {
            for (int co = 0; co < CO; co += 4) {
              const float4 v = __ldg(reinterpret_cast<const float4*>(dzp + co));
#pragma unroll
              for (int j = 0; j < kInTile; ++j) {
                acc[j] = fmaf(v.x, wp[(co + 0) * kInTile + j], acc[j]);
                acc[j] = fmaf(v.y, wp[(co + 1) * kInTile + j], acc[j]);
                acc[j] = fmaf(v.z, wp[(co + 2) * kInTile + j], acc[j]);
                acc[j] = fmaf(v.w, wp[(co + 3) * kInTile + j], acc[j]);
              }
            }
          } else {
            for (int co = 0; co < CO; ++co) {
              const float v = __ldg(dzp + co);
#pragma unroll
              for (int j = 0; j < kInTile; ++j) {
                acc[j] = fmaf(v, wp[co * kInTile + j], acc[j]);
              }
            }
          }
        }
      }
    }
  }

  const long long o = p * CI + ci0;
#pragma unroll
  for (int j = 0; j < kInTile; ++j) {
    if (ci0 + j < CI) {
      float v = acc[j];
      if (add != nullptr) v += add[o + j];
      if (act != nullptr) v *= elu_grad(act[o + j]);
      out[o + j] = v;
    }
  }
}

// Partial gradient of y = conv3x3_reflect(UP ? up2(src) : src, w) w.r.t. w
// and the bias, over one chunk of output pixels:
//   part_w[chunk][tap][ci][co] = sum_{q in chunk} src[read(q, tap), ci] * dz[q, co]
//   part_b[chunk][co]          = sum_{q in chunk} dz[q, co]
// src (B, Hin, Win, CI), dz (B, Hout, Wout, CO). grid = (chunks, 9 taps,
// ci tiles * co tiles); a block keeps a kCiTile x COT tile, COT / 8 sums per
// thread: thread t owns co = t % COT and ci = t / COT + k * (kThreads / COT).
template <int COT, bool UP>
__global__ void __launch_bounds__(kThreads)
conv3x3_reflect_weight_grad_kernel(const float* __restrict__ src,
                                   const float* __restrict__ dz,
                                   float* __restrict__ part_w,
                                   float* __restrict__ part_b, int B, int Hin,
                                   int Win, int CI, int CO,
                                   long long chunk_pixels) {
  constexpr int kRows = kThreads / COT;  // ci rows covered by one pass of the block
  constexpr int kPer = kCiTile / kRows;  // sums per thread
  __shared__ float s_src[kPix][kCiTile + 1];
  __shared__ float s_dz[kPix][COT + 1];

  const int Hout = UP ? 2 * Hin : Hin;
  const int Wout = UP ? 2 * Win : Win;
  const long long total = (long long)B * Hout * Wout;
  const int chunk = blockIdx.x;
  const int tap = blockIdx.y;
  const int ky = tap / 3, kx = tap - 3 * (tap / 3);
  const int n_co_tiles = (CO + COT - 1) / COT;
  const int ci0 = (blockIdx.z / n_co_tiles) * kCiTile;
  const int co0 = (blockIdx.z % n_co_tiles) * COT;
  const long long begin = (long long)chunk * chunk_pixels;
  const long long end = min(begin + chunk_pixels, total);

  const int co_l = threadIdx.x % COT;
  const int ci_l = threadIdx.x / COT;
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  float bacc = 0.f;

  for (long long p0 = begin; p0 < end; p0 += kPix) {
    for (int i = threadIdx.x; i < kPix * kCiTile; i += kThreads) {
      const int pix = i / kCiTile;
      const int c = i - pix * kCiTile;
      const long long q = p0 + pix;
      float v = 0.f;
      if (q < end && ci0 + c < CI) {
        const int ox = (int)(q % Wout);
        const long long t = q / Wout;
        const int oy = (int)(t % Hout);
        const long long b = t / Hout;
        int sy = reflect(oy + ky - 1, Hout);
        int sx = reflect(ox + kx - 1, Wout);
        if (UP) {
          sy >>= 1;
          sx >>= 1;
        }
        v = __ldg(src + ((b * Hin + sy) * Win + sx) * (long long)CI + ci0 + c);
      }
      s_src[pix][c] = v;
    }
    for (int i = threadIdx.x; i < kPix * COT; i += kThreads) {
      const int pix = i / COT;
      const int c = i - pix * COT;
      const long long q = p0 + pix;
      s_dz[pix][c] = (q < end && co0 + c < CO) ? __ldg(dz + q * CO + co0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pix = 0; pix < kPix; ++pix) {
      const float d = s_dz[pix][co_l];
      bacc += d;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        acc[k] = fmaf(s_src[pix][ci_l + k * kRows], d, acc[k]);
      }
    }
    __syncthreads();
  }

  const int co = co0 + co_l;
  if (co >= CO) return;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int ci = ci0 + ci_l + k * kRows;
    if (ci < CI) {
      part_w[(((long long)chunk * 9 + tap) * CI + ci) * CO + co] = acc[k];
    }
  }
  if (tap == 4 && ci0 == 0 && ci_l == 0) part_b[(long long)chunk * CO + co] = bacc;
}

// dw[co][ci][tap] = sum_chunk part_w[chunk][tap][ci][co] and
// db[co] = sum_chunk part_b[chunk][co], chunks added in order.
__global__ void __launch_bounds__(kThreads)
reduce_weight_grad_kernel(const float* __restrict__ part_w,
                          const float* __restrict__ part_b,
                          float* __restrict__ dw, float* __restrict__ db,
                          int chunks, int CI, int CO) {
  const int n_w = 9 * CI * CO;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < n_w) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part_w[(long long)c * n_w + e];
    const int tap = e / (CI * CO);
    const int r = e - tap * CI * CO;
    const int ci = r / CO;
    const int co = r - ci * CO;
    dw[((long long)co * CI + ci) * 9 + tap] = s;
  } else if (e < n_w + CO) {
    const int co = e - n_w;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part_b[(long long)c * CO + co];
    db[co] = s;
  }
}

int co_tile(int CO) { return CO <= 8 ? 8 : (CO <= 16 ? 16 : 32); }

// Pixels per chunk (a multiple of kPix) and the number of chunks for a weight
// gradient over `pixels` output pixels, so that the grid has about
// kTargetBlocks blocks.
void chunking(long long pixels, int CI, int CO, long long& chunk_pixels,
              int& chunks) {
  const int cot = co_tile(CO);
  const long long tiles =
      9LL * ((CI + kCiTile - 1) / kCiTile) * ((CO + cot - 1) / cot);
  long long want = kTargetBlocks / tiles;
  if (want < 1) want = 1;
  chunk_pixels = (pixels + want - 1) / want;
  chunk_pixels = (chunk_pixels + kPix - 1) / kPix * kPix;
  chunks = (int)((pixels + chunk_pixels - 1) / chunk_pixels);
}

long long partial_floats(long long pixels, int CI, int CO) {
  long long chunk_pixels;
  int chunks;
  chunking(pixels, CI, CO, chunk_pixels, chunks);
  return (long long)chunks * (9LL * CI * CO + CO);
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

template <bool UP>
cudaError_t launch_input_grad(const float* dz, const float* w, const float* add,
                              const float* act, float* out, int B, int Hin,
                              int Win, int CI, int CO, cudaStream_t s) {
  auto kernel = conv3x3_reflect_input_grad_kernel<UP>;
  const int smem = 9 * CO * kInTile * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long pixels = (long long)B * Hin * Win;
  const dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads),
                  (unsigned)((CI + kInTile - 1) / kInTile));
  kernel<<<grid, kThreads, smem, s>>>(dz, w, add, act, out, B, Hin, Win, CI, CO);
  return cudaGetLastError();
}

template <bool UP>
cudaError_t launch_weight_grad(const float* src, const float* dz, float* part,
                               float* dw, float* db, int B, int Hin, int Win,
                               int CI, int CO, cudaStream_t s) {
  const long long pixels = (long long)B * Hin * Win * (UP ? 4 : 1);
  long long chunk_pixels;
  int chunks;
  chunking(pixels, CI, CO, chunk_pixels, chunks);
  float* part_w = part;
  float* part_b = part + (long long)chunks * 9 * CI * CO;
  const int cot = co_tile(CO);
  const dim3 grid((unsigned)chunks, 9u,
                  (unsigned)(((CI + kCiTile - 1) / kCiTile) * ((CO + cot - 1) / cot)));
  if (cot == 8) {
    conv3x3_reflect_weight_grad_kernel<8, UP><<<grid, kThreads, 0, s>>>(
        src, dz, part_w, part_b, B, Hin, Win, CI, CO, chunk_pixels);
  } else if (cot == 16) {
    conv3x3_reflect_weight_grad_kernel<16, UP><<<grid, kThreads, 0, s>>>(
        src, dz, part_w, part_b, B, Hin, Win, CI, CO, chunk_pixels);
  } else {
    conv3x3_reflect_weight_grad_kernel<32, UP><<<grid, kThreads, 0, s>>>(
        src, dz, part_w, part_b, B, Hin, Win, CI, CO, chunk_pixels);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * CI * CO + CO;
  reduce_weight_grad_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part_w, part_b, dw, db, chunks, CI, CO);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that slowtv_decoder_stage_bwd_f32 needs for these shapes:
// dzo (B, 2H, 2W), dzb (B, 2H, 2W, CD), dza (B, H, W, CD) and the weight
// gradients' per-chunk partial sums.
extern "C" long long slowtv_decoder_stage_bwd_scratch_floats(int B, int H, int W,
                                                             int CI, int CD) {
  const long long p = (long long)B * H * W;
  long long part = partial_floats(4 * p, CD, 1);
  const long long pb = partial_floats(4 * p, CD, CD);
  const long long pa = partial_floats(p, CI, CD);
  if (pb > part) part = pb;
  if (pa > part) part = pa;
  return round4(4 * p) + round4(4 * p * CD) + round4(p * CD) + round4(part);
}

// Inputs: x (B, H, W, CI); wa (CD, CI, 3, 3), wb (CD, CD, 3, 3), wo
// (1, CD, 3, 3); the forward's ha (B, H, W, CD), feat (B, 2H, 2W, CD) and disp
// (B, 2H, 2W, 1); the cotangents g_feat (B, 2H, 2W, CD) and g_disp
// (B, 2H, 2W, 1). `scratch` holds slowtv_decoder_stage_bwd_scratch_floats
// floats. Outputs, each computed only when its bit of `need` is set (and may
// be null otherwise): 1 dx (B, H, W, CI); 2 dwa, dba; 4 dwb, dbb; 8 dwo, dbo,
// shaped as their parameters. All float32, contiguous, on `device`; H, W >= 2.
// Launches on `stream`; returns the first failing cudaError_t, 0 on success.
extern "C" int slowtv_decoder_stage_bwd_f32(
    const float* x, const float* wa, const float* wb, const float* wo,
    const float* ha, const float* feat, const float* disp, const float* g_feat,
    const float* g_disp, float* scratch, float* dx, float* dwa, float* dba,
    float* dwb, float* dbb, float* dwo, float* dbo, int B, int H, int W, int CI,
    int CD, int need, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p = (long long)B * H * W;
  float* dzo = scratch;
  float* dzb = dzo + round4(4 * p);
  float* dza = dzb + round4(4 * p * CD);
  float* part = dza + round4(p * CD);

  sigmoid_grad_kernel<<<(unsigned)((4 * p + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      g_disp, disp, dzo, 4 * p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (need & 8) {
    err = launch_weight_grad<false>(feat, dzo, part, dwo, dbo, B, 2 * H, 2 * W, CD, 1, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(need & 7)) return 0;
  err = launch_input_grad<false>(dzo, wo, g_feat, feat, dzb, B, 2 * H, 2 * W, CD, 1, s);
  if (err != cudaSuccess) return (int)err;
  if (need & 4) {
    err = launch_weight_grad<true>(ha, dzb, part, dwb, dbb, B, H, W, CD, CD, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(need & 3)) return 0;
  err = launch_input_grad<true>(dzb, wb, nullptr, ha, dza, B, H, W, CD, CD, s);
  if (err != cudaSuccess) return (int)err;
  if (need & 2) {
    err = launch_weight_grad<false>(x, dza, part, dwa, dba, B, H, W, CI, CD, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (need & 1) {
    err = launch_input_grad<false>(dza, wa, nullptr, nullptr, dx, B, H, W, CI, CD, s);
  }
  return (int)err;
}
