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
// the float32 pipe (exact float32: no tensor cores): conv_b's two gradients
// on the upsampled grid dominate. So the design is about FMAs per
// shared-memory load and about threads that are not idle.
//
// Design.
// - Weight gradients (dwo, dwb, dwa) are products with K = pixels. A block
//   stages a band of R output rows x TW columns: their dz once, and the
//   source rows with a 1-pixel halo, reflect-padded once per staged value on
//   the conv's own grid (conv_b's on the upsampled grid, then halved: the up2
//   index map), as float4 when CI % 4 == 0. Positions come from walking the
//   band, with 32-bit arithmetic. A thread owns one tap row ky of one band
//   row and a register tile of 3 taps x 4 ci x TO co (TO = 4, or 1 for dwo's
//   single output channel: there the threads run over (ky, ci) and the band
//   rows, no idle co lanes), walks its row's TW pixels with the three source
//   columns of its taps as a sliding window: per pixel one float4 of source
//   and one of dz feed 48 FMAs (12 for dwo). Each block adds a fixed run of
//   band tiles, its band rows' sums in row order, and writes one partial; a
//   second launch adds the partials in a fixed order, 8 warps to 32 outputs.
//   No atomics: two calls give the same bits.
// - Input gradients (dzb, dza, dx) are gathers: an input pixel collects
//   dz[q] * w[tap] from every output pixel q whose tap read it, the reflected
//   reads included. Per axis the (q, taps) pairs are offsets of q from the
//   pixel with a SET of taps each: without upsampling q = y - 1 + a (a < 3)
//   with taps {2}, {1}, {0}, and {0, 2} where a reflect fold lands (y == 1
//   reads q = 0's tap 0; y == n - 2 reads q = n - 1's tap 2; grids of 2 and 3
//   take both); through the 2x upsample (conv_b reflects on the (2H, 2W)
//   grid: u[-1] = u[1] = ha[0]) q = 2y - 1 + a (a < 4) with taps {2}, {1, 2},
//   {0, 1}, {0}, and {0, 1, 2} at the borders. A first launch sums the
//   weights of each (row set, column set) pair once (16 or 25 matrices of
//   CO x CI): dza then does 16 (CO x CI) products per ha pixel where the
//   upsampled gather did 36. A thread owns 2 neighbouring pixels x 16 input
//   channels; the block's weight sets for 16 output channels at a time sit in
//   shared memory and are read as float4, one warp-wide broadcast per 4
//   weights: 32 FMAs per shared load.
//
// Launches go through cudaLaunchKernelEx and shared memory is dynamic
// (SLOWTV_DYNAMIC_SMEM), so tests/cuda_emu builds this file for the CPU.
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

constexpr int kEwThreads = 256;    // elementwise, pre-sum and reduce launches
constexpr int kIgThreads = 128;    // input gradient: 2 pixels a thread
constexpr int kCT = 16;            // input channels per thread in the input gradients
constexpr int kCOC = 16;           // output channels per staged chunk of weight sets
constexpr int kWgMaxThreads = 512; // weight gradient
constexpr int kWgTargetBlocks = 528;  // 4 blocks per SM of an H100 (132 SMs)
constexpr int kWgMaxSmem = 200 * 1024;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long round4(long long n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float elu_grad(float h) {
  return h > 0.f ? 1.f : h + 1.f;
}

template <class Kern, class... Args>
cudaError_t launch_1d(Kern kernel, long long grid, int threads, size_t smem, cudaStream_t s,
                      Args... args) {
  if (grid <= 0) return cudaSuccess;
  if (smem > 48 * 1024) {  // above 48 KB it has to be asked for, or the launch is refused
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

__global__ void __launch_bounds__(kEwThreads)
sigmoid_grad_kernel(const float* __restrict__ g, const float* __restrict__ s,
                    float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kEwThreads + threadIdx.x;
  if (i < n) {
    const float d = s[i];
    out[i] = g[i] * d * (1.f - d);
  }
}

// ------------------------------------------------------------ input gradients
// Tap sets per axis, as bit masks over the taps 0, 1, 2 (see the header).
// Without upsampling: {2}, {1}, {0}, {0, 2}; through it: {2}, {1, 2}, {0, 1},
// {0}, {0, 1, 2}.
template <bool UP>
__device__ __forceinline__ int tap_mask(int set) {
  if constexpr (UP) {
    return set == 0 ? 4 : set == 1 ? 6 : set == 2 ? 3 : set == 3 ? 1 : 7;
  } else {
    return set == 0 ? 4 : set == 1 ? 2 : set == 2 ? 1 : 5;
  }
}

// The tap set of offset `a` for input index y of an axis of n input values
// (q = y - 1 + a, or 2y - 1 + a through the upsample); -1 where q is off the
// output grid.
template <bool UP>
__device__ __forceinline__ int tap_set(int a, int y, int n) {
  if constexpr (UP) {
    if (a == 0) return y == 0 ? -1 : 0;
    if (a == 1) return y == 0 ? 4 : 1;
    if (a == 2) return y == n - 1 ? 4 : 2;
    return y == n - 1 ? -1 : 3;
  } else {
    if (a == 0) return y == 0 ? -1 : (y == 1 ? 3 : 0);
    if (a == 1) return 1;
    return y == n - 1 ? -1 : (y == n - 2 ? 3 : 2);
  }
}

// sets[sy][sx][co][ci] = sum over ky in set sy, kx in set sx (ascending) of
// w[co][ci][ky][kx], for the NS x NS set pairs.
template <bool UP>
__global__ void __launch_bounds__(kEwThreads)
presum_kernel(const float* __restrict__ w, float* __restrict__ sets, int CI, int CO) {
  constexpr int NS = UP ? 5 : 4;
  const long long e = (long long)blockIdx.x * kEwThreads + threadIdx.x;
  if (e >= (long long)NS * NS * CO * CI) return;
  const int ci = (int)(e % CI);
  const long long r = e / CI;
  const int co = (int)(r % CO);
  const int s = (int)(r / CO);
  const int my = tap_mask<UP>(s / NS), mx = tap_mask<UP>(s % NS);
  const float* wp = w + ((long long)co * CI + ci) * 9;
  float sum = 0.f;
  for (int ky = 0; ky < 3; ++ky) {
    if (!(my >> ky & 1)) continue;
    for (int kx = 0; kx < 3; ++kx) {
      if (mx >> kx & 1) sum += wp[ky * 3 + kx];
    }
  }
  sets[e] = sum;
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&d)[N]) {
  if constexpr (N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = __ldg(p);
  }
}

// acc[r][j] += sum_k d_r[k] * w_r[k][j] for the two pixels r, NK output
// channels k and kCT input channels j; the weights [NK][kCT] read as float4,
// once when both pixels use the same set (SAME).
template <int NK, bool SAME>
__device__ __forceinline__ void fma_cols(float (&acc)[2][kCT], const float (&d0)[NK],
                                         const float (&d1)[NK], const float* w0,
                                         const float* w1) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const float4* wa = reinterpret_cast<const float4*>(w0 + k * kCT);
    const float4* wb = reinterpret_cast<const float4*>(w1 + k * kCT);
#pragma unroll
    for (int j4 = 0; j4 < kCT / 4; ++j4) {
      const float4 u = wa[j4];
      const float4 v = SAME ? u : wb[j4];
      acc[0][4 * j4 + 0] = fmaf(d0[k], u.x, acc[0][4 * j4 + 0]);
      acc[0][4 * j4 + 1] = fmaf(d0[k], u.y, acc[0][4 * j4 + 1]);
      acc[0][4 * j4 + 2] = fmaf(d0[k], u.z, acc[0][4 * j4 + 2]);
      acc[0][4 * j4 + 3] = fmaf(d0[k], u.w, acc[0][4 * j4 + 3]);
      acc[1][4 * j4 + 0] = fmaf(d1[k], v.x, acc[1][4 * j4 + 0]);
      acc[1][4 * j4 + 1] = fmaf(d1[k], v.y, acc[1][4 * j4 + 1]);
      acc[1][4 * j4 + 2] = fmaf(d1[k], v.z, acc[1][4 * j4 + 2]);
      acc[1][4 * j4 + 3] = fmaf(d1[k], v.w, acc[1][4 * j4 + 3]);
    }
  }
}

// The products of one offset pair for output channels [co0, co0 + ncol): dz of
// the two pixels' output pixels (NK at a time) against the staged weight sets.
template <int NK, bool SAME>
__device__ __forceinline__ void offset_products(float (&acc)[2][kCT], const float* d0p,
                                                const float* d1p, bool v0, bool v1,
                                                const float* w0, const float* w1, int ncol) {
  for (int col = 0; col < ncol; col += NK) {
    float d0[NK], d1[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) d0[k] = d1[k] = 0.f;
    if (v0) load_vec<NK>(d0p + col, d0);
    if (v1) load_vec<NK>(d1p + col, d1);
    fma_cols<NK, SAME>(acc, d0, d1, w0 + col * kCT, w1 + col * kCT);
  }
}

// Gradient of y = conv3x3_reflect(UP ? up2(in) : in, w) w.r.t. `in`, from
// the weight sets of presum_kernel:
//   out[p, ci] = (add ? add[p, ci] : 0) + sum over offsets (a, c) and co of
//                dz[q(a, c), co] * sets[sy(a)][sx(c)][co][ci]
//   out[p, ci] *= elu'(act[p, ci])   when act is given.
// dz (B, Hout, Wout, CO); add, act, out (B, Hin, Win, CI). A thread: pixels
// (y, x0) and (y, x0 + 1), kCT input channels; the block: one channel tile.
template <bool UP>
__global__ void __launch_bounds__(kIgThreads)
input_grad_kernel(const float* __restrict__ dz, const float* __restrict__ sets,
                  const float* __restrict__ add, const float* __restrict__ act,
                  float* __restrict__ out, int B, int Hin, int Win, int CI, int CO,
                  int ci_tiles, int items) {
  constexpr int NA = UP ? 4 : 3;  // offsets per axis
  constexpr int NS = UP ? 5 : 4;  // tap sets per axis
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* s_w = reinterpret_cast<float*>(smem4);  // [NS * NS][kCOC][kCT]
  const int ci0 = (int)(blockIdx.x % ci_tiles) * kCT;
  const int item = (int)(blockIdx.x / ci_tiles) * kIgThreads + threadIdx.x;
  const int Hout = UP ? 2 * Hin : Hin, Wout = UP ? 2 * Win : Win;
  const int pairs = (Win + 1) / 2;
  const bool valid = item < items;
  const int row = valid ? item / pairs : 0;  // b * Hin + y
  const int x0 = valid ? 2 * (item - row * pairs) : 0;
  const int b = row / Hin, y = row - b * Hin;
  const bool has1 = x0 + 1 < Win;
  const bool vec = (CO & 3) == 0 && (reinterpret_cast<unsigned long long>(dz) & 15) == 0;

  float acc[2][kCT];
#pragma unroll
  for (int j = 0; j < kCT; ++j) acc[0][j] = acc[1][j] = 0.f;

  for (int co0 = 0; co0 < CO; co0 += kCOC) {
    const int ncol = CO - co0 < kCOC ? CO - co0 : kCOC;
    for (int i = threadIdx.x; i < NS * NS * ncol * kCT; i += kIgThreads) {
      const int j = i % kCT, r = i / kCT;
      const int col = r % ncol, s = r / ncol;
      const int ci = ci0 + j;
      s_w[(s * kCOC + col) * kCT + j] =
          ci < CI ? __ldg(sets + ((long long)s * CO + co0 + col) * CI + ci) : 0.f;
    }
    __syncthreads();
    if (valid) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int sy = tap_set<UP>(a, y, Hin);
        if (sy < 0) continue;
        const int qy = (UP ? 2 * y : y) - 1 + a;
        const float* dzrow = dz + ((long long)b * Hout + qy) * Wout * CO + co0;
#pragma unroll 1
        for (int c = 0; c < NA; ++c) {
          const int sx0 = tap_set<UP>(c, x0, Win);
          const int sx1 = has1 ? tap_set<UP>(c, x0 + 1, Win) : -1;
          if (sx0 < 0 && sx1 < 0) continue;
          const int qx0 = (UP ? 2 * x0 : x0) - 1 + c;
          const int qx1 = qx0 + (UP ? 2 : 1);
          const float* w0 = s_w + (sy * NS + (sx0 >= 0 ? sx0 : sx1)) * kCOC * kCT;
          const float* w1 = s_w + (sy * NS + (sx1 >= 0 ? sx1 : sx0)) * kCOC * kCT;
          const float* d0p = dzrow + qx0 * CO;
          const float* d1p = dzrow + qx1 * CO;
          const bool v0 = sx0 >= 0, v1 = sx1 >= 0;
          if (vec && w0 == w1) {
            offset_products<4, true>(acc, d0p, d1p, v0, v1, w0, w1, ncol);
          } else if (vec) {
            offset_products<4, false>(acc, d0p, d1p, v0, v1, w0, w1, ncol);
          } else if (w0 == w1) {
            offset_products<1, true>(acc, d0p, d1p, v0, v1, w0, w1, ncol);
          } else {
            offset_products<1, false>(acc, d0p, d1p, v0, v1, w0, w1, ncol);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!valid) return;
  // The epilogue moves 3 x kCT floats a pixel: float4 where CI % 4 == 0 and
  // the tensors are 16-byte aligned (ci0 is a multiple of 16).
  auto aligned = [](const float* p) {
    return p == nullptr || (reinterpret_cast<unsigned long long>(p) & 15) == 0;
  };
  const bool ci4 = (CI & 3) == 0 && aligned(add) && aligned(act) && aligned(out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == 1 && !has1) break;
    const long long o = ((long long)row * Win + x0 + r) * CI + ci0;
    if (ci4) {
#pragma unroll
      for (int j4 = 0; j4 < kCT / 4; ++j4) {
        if (ci0 + 4 * j4 >= CI) continue;
        float v[4] = {acc[r][4 * j4], acc[r][4 * j4 + 1], acc[r][4 * j4 + 2], acc[r][4 * j4 + 3]};
        if (add != nullptr) {
          float a[4];
          load_vec<4>(add + o + 4 * j4, a);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += a[e];
        }
        if (act != nullptr) {
          float a[4];
          load_vec<4>(act + o + 4 * j4, a);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] *= elu_grad(a[e]);
        }
        *reinterpret_cast<float4*>(out + o + 4 * j4) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        if (ci0 + j < CI) {
          float v = acc[r][j];
          if (add != nullptr) v += add[o + j];
          if (act != nullptr) v *= elu_grad(act[o + j]);
          out[o + j] = v;
        }
      }
    }
  }
}

template <bool UP>
cudaError_t launch_input_grad(const float* dz, const float* w, float* sets, const float* add,
                              const float* act, float* out, int B, int Hin, int Win, int CI,
                              int CO, cudaStream_t s) {
  constexpr int NS = UP ? 5 : 4;
  cudaError_t err = launch_1d(presum_kernel<UP>, cdiv((long long)NS * NS * CO * CI, kEwThreads),
                              kEwThreads, 0, s, w, sets, CI, CO);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * Hin * ((Win + 1) / 2);
  const int ci_tiles = (int)cdiv(CI, kCT);
  return launch_1d(input_grad_kernel<UP>, cdiv(items, kIgThreads) * ci_tiles, kIgThreads,
                   sizeof(float) * NS * NS * kCOC * kCT, s, dz, (const float*)sets, add, act,
                   out, B, Hin, Win, CI, CO, ci_tiles, (int)items);
}

// ----------------------------------------------------------- weight gradients
// How a weight gradient of CO output channels over an (Hout, Wout) output
// grid is cut: bands of R rows x TW columns, thread tiles (band row, ky,
// 4 input channels, TO output channels), `groups` blocks per band tile when
// the tiles exceed kWgMaxThreads (only when R == 1), `chunks` runs of `per`
// band tiles, one partial sum per chunk.
struct WgPlan {
  int TO, R, TW, nti, nto, threads, groups, per, chunks;
  long long tiles, smem;
};

WgPlan wg_plan(int B, int Hout, int Wout, int CI, int CO) {
  WgPlan p;
  p.TO = CO == 1 ? 1 : 4;
  p.nti = (int)cdiv(CI, 4);
  p.nto = (int)cdiv(CO, p.TO);
  const long long base = 3LL * p.nti * p.nto;
  p.R = (int)(256 / base);
  p.R = p.R < 1 ? 1 : (p.R > 8 ? 8 : p.R);
  p.TW = Wout < 32 ? Wout : 32;
  auto smem = [&]() {
    return (long long)sizeof(float) *
           ((long long)(p.R + 2) * (p.TW + 2) * p.nti * 4 + (long long)p.R * p.TW * p.nto * p.TO);
  };
  while (smem() > kWgMaxSmem && p.TW > 4) p.TW /= 2;
  // After the band tiles the same memory holds the band rows' sums (13 * TO
  // floats per thread tile) on their way to row 0's threads.
  const long long exchange = sizeof(float) * (p.R > 1 ? base * 13 * p.TO : 0);
  p.smem = smem() > exchange ? smem() : exchange;
  const long long n = p.R * base;
  const long long threads = n < kWgMaxThreads ? n : kWgMaxThreads;
  p.threads = (int)cdiv(threads, 32) * 32;
  p.groups = (int)cdiv(n, p.threads);
  p.tiles = (long long)B * cdiv(Hout, p.R) * cdiv(Wout, p.TW);
  long long chunks = kWgTargetBlocks / p.groups;
  chunks = chunks < 1 ? 1 : (chunks > p.tiles ? p.tiles : chunks);
  p.per = (int)cdiv(p.tiles, chunks);
  p.chunks = (int)cdiv(p.tiles, p.per);
  return p;
}

long long wg_partial_floats(int B, int Hout, int Wout, int CI, int CO) {
  const WgPlan p = wg_plan(B, Hout, Wout, CI, CO);
  return (long long)p.chunks * (9LL * CI * CO + CO);
}

template <int TO>
__device__ __forceinline__ void load_to(const float* p, float (&d)[TO]) {
  if constexpr (TO == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = p[0];
  }
}

// Partial gradient of y = conv3x3_reflect(UP ? up2(src) : src, w) w.r.t. w
// and the bias, over the band tiles [chunk * per, (chunk + 1) * per):
//   part_w[chunk][tap][ci][co] = sum over the chunk's pixels of
//                                src[read(q, tap), ci] * dz[q, co]
//   part_b[chunk][co]          = sum of dz[q, co] over the same pixels
// (each band row's sums kept apart, then added in row order)
// src (B, Hin, Win, CI), dz (B, Hout, Wout, CO); blockIdx.x = chunk * groups + group.
template <int TO, bool UP>
__global__ void __launch_bounds__(kWgMaxThreads)
weight_grad_kernel(const float* __restrict__ src, const float* __restrict__ dz,
                   float* __restrict__ part_w, float* __restrict__ part_b, int Hin, int Win,
                   int CI, int CO, WgPlan p) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  const int Hout = UP ? 2 * Hin : Hin, Wout = UP ? 2 * Win : Win;
  const int R = p.R, TW = p.TW, nti = p.nti, nto = p.nto;
  const int CIP = 4 * nti, COP = TO * nto;
  float* s_src = reinterpret_cast<float*>(smem4);  // [R + 2][TW + 2][CIP]
  float* s_dz = s_src + (R + 2) * (TW + 2) * CIP;  // [R][TW][COP]
  const int group = (int)(blockIdx.x % p.groups), chunk = (int)(blockIdx.x / p.groups);
  const int tid = threadIdx.x;
  const int tt = group * p.threads + tid;
  const bool active = tt < R * 3 * nti * nto;
  const int cot = tt % nto, cit = (tt / nto) % nti;
  const int ky = (tt / (nto * nti)) % 3, pl = tt / (nto * nti * 3);
  const int bands = (Hout + R - 1) / R, xtiles = (Wout + TW - 1) / TW;
  const bool src4 = (CI & 3) == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0;
  const bool dz4 = TO == 4 && (CO & 3) == 0 &&
                   (reinterpret_cast<unsigned long long>(dz) & 15) == 0;

  float acc[3][4][TO], bacc[TO];
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    bacc[o] = 0.f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[kx][i][o] = 0.f;
    }
  }

  const long long end = (long long)(chunk + 1) * p.per < p.tiles ? (long long)(chunk + 1) * p.per
                                                                  : p.tiles;
  for (long long bt = (long long)chunk * p.per; bt < end; ++bt) {
    const int xt = (int)(bt % xtiles);
    const long long rest = bt / xtiles;
    const int r0 = (int)(rest % bands) * R, x0 = xt * TW;
    const long long b = rest / bands;
    // The band's source rows r0 - 1 .. r0 + R and columns x0 - 1 .. x0 + TW,
    // reflected on the output grid (then halved through the upsample); zeros
    // past the reflected border, which only pixels off the grid read.
    const float* srcb = src + b * Hin * Win * CI;
    const int nsrc = (R + 2) * (TW + 2) * (src4 ? nti : CIP);
    for (int i = tid; i < nsrc; i += p.threads) {
      const int per_pix = src4 ? nti : CIP;
      const int c = i % per_pix, pix = i / per_pix;
      const int col = pix % (TW + 2), row = pix / (TW + 2);
      const int py = r0 + row - 1, px = x0 + col - 1;
      const bool in = py <= Hout && px <= Wout;
      int sy = in ? reflect(py, Hout) : 0, sx = in ? reflect(px, Wout) : 0;
      if (UP) {
        sy >>= 1;
        sx >>= 1;
      }
      const float* sp = srcb + (sy * Win + sx) * CI;
      if (src4) {
        const float4 v = in ? __ldg(reinterpret_cast<const float4*>(sp) + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(s_src + pix * CIP + 4 * c) = v;
      } else {
        s_src[pix * CIP + c] = in && c < CI ? __ldg(sp + c) : 0.f;
      }
    }
    // The band's dz, zeros off the grid and past CO.
    const float* dzb = dz + b * Hout * Wout * CO;
    const int ndz = R * TW * (dz4 ? nto : COP);
    for (int i = tid; i < ndz; i += p.threads) {
      const int per_pix = dz4 ? nto : COP;
      const int c = i % per_pix, pix = i / per_pix;
      const int col = pix % TW, row = pix / TW;
      const int qy = r0 + row, qx = x0 + col;
      const bool in = qy < Hout && qx < Wout;
      const float* dp = dzb + (qy * Wout + qx) * CO;
      if (dz4) {
        const float4 v = in ? __ldg(reinterpret_cast<const float4*>(dp) + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(s_dz + pix * COP + 4 * c) = v;
      } else {
        s_dz[pix * COP + c] = in && c < CO ? __ldg(dp + c) : 0.f;
      }
    }
    __syncthreads();
    if (active) {
      // Output pixel (r0 + pl, x0 + q) reads staged source column q + kx of
      // row pl + ky: a sliding window of three float4 along the row.
      const float* srow = s_src + (pl + ky) * (TW + 2) * CIP + 4 * cit;
      const float* drow = s_dz + pl * TW * COP + TO * cot;
      float s0[4], s1[4], s2[4];
      load_to<4>(srow, s0);
      load_to<4>(srow + CIP, s1);
#pragma unroll 3
      for (int q = 0; q < TW; ++q) {
        float d[TO];
        load_to<4>(srow + (q + 2) * CIP, s2);
        load_to<TO>(drow + q * COP, d);
#pragma unroll
        for (int o = 0; o < TO; ++o) {
          bacc[o] += d[o];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[0][i][o] = fmaf(s0[i], d[o], acc[0][i][o]);
            acc[1][i][o] = fmaf(s1[i], d[o], acc[1][i][o]);
            acc[2][i][o] = fmaf(s2[i], d[o], acc[2][i][o]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s0[i] = s1[i];
          s1[i] = s2[i];
        }
      }
    }
    __syncthreads();
  }

  // Band rows 1 .. R-1 hand their sums to row 0's thread of the same tile,
  // one row at a time (R > 1 only when the block holds every row).
  const int base = 3 * nti * nto, slot = tt - pl * base;
  float* s_x = s_src;  // [base][13 * TO]
  for (int r = 1; r < R; ++r) {
    if (active && pl == r) {
      float* x = s_x + slot * 13 * TO;
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        x[12 * TO + o] = bacc[o];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[(kx * 4 + i) * TO + o] = acc[kx][i][o];
        }
      }
    }
    __syncthreads();
    if (active && pl == 0) {
      const float* x = s_x + slot * 13 * TO;
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        bacc[o] += x[12 * TO + o];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[kx][i][o] += x[(kx * 4 + i) * TO + o];
        }
      }
    }
    __syncthreads();
  }

  if (!active || pl != 0) return;
  const long long part = chunk;
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    const int co = cot * TO + o;
    if (co >= CO) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = cit * 4 + i;
        if (ci < CI) part_w[((part * 9 + ky * 3 + kx) * CI + ci) * CO + co] = acc[kx][i][o];
      }
    }
    if (ky == 1 && cit == 0) part_b[part * CO + co] = bacc[o];
  }
}

// dw[co][ci][tap] = sum_k part_w[k][tap][ci][co] and db[co] = sum_k part_b[k][co]:
// a block takes 32 outputs, its 8 warps the partials k = warp (mod 8) each in
// order, then the 8 sums are added in order. The same bits every run.
constexpr int kRedSlices = kEwThreads / 32;

__global__ void __launch_bounds__(kEwThreads)
reduce_weight_grad_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                          float* __restrict__ dw, float* __restrict__ db, int nparts, int CI,
                          int CO) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* s_red = reinterpret_cast<float*>(smem4);  // [kRedSlices][32]
  const int n_w = 9 * CI * CO;
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < n_w + CO) {
    const float* src = e < n_w ? part_w + e : part_b + (e - n_w);
    const long long stride = e < n_w ? n_w : CO;
    for (int k = slice; k < nparts; k += kRedSlices) s += src[k * stride];
  }
  s_red[slice * 32 + lane] = s;
  __syncthreads();
  if (slice != 0 || e >= n_w + CO) return;
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kRedSlices; ++k) t += s_red[k * 32 + lane];
  if (e < n_w) {
    const int tap = e / (CI * CO);
    const int r = e - tap * CI * CO;
    const int ci = r / CO;
    const int co = r - ci * CO;
    dw[((long long)co * CI + ci) * 9 + tap] = t;
  } else {
    db[e - n_w] = t;
  }
}

template <bool UP>
cudaError_t launch_weight_grad(const float* src, const float* dz, float* part, float* dw,
                               float* db, int B, int Hin, int Win, int CI, int CO,
                               cudaStream_t s) {
  const int Hout = UP ? 2 * Hin : Hin, Wout = UP ? 2 * Win : Win;
  const WgPlan p = wg_plan(B, Hout, Wout, CI, CO);
  float* part_w = part;
  float* part_b = part + (long long)p.chunks * 9 * CI * CO;
  const long long grid = (long long)p.chunks * p.groups;
  const cudaError_t err =
      p.TO == 1 ? launch_1d(weight_grad_kernel<1, UP>, grid, p.threads, p.smem, s, src, dz,
                            part_w, part_b, Hin, Win, CI, CO, p)
                : launch_1d(weight_grad_kernel<4, UP>, grid, p.threads, p.smem, s, src, dz,
                            part_w, part_b, Hin, Win, CI, CO, p);
  if (err != cudaSuccess) return err;
  return launch_1d(reduce_weight_grad_kernel, cdiv(9LL * CI * CO + CO, 32), kEwThreads,
                   sizeof(float) * kEwThreads, s, (const float*)part_w, (const float*)part_b, dw,
                   db, p.chunks, CI, CO);
}

}  // namespace

// Floats of scratch that slowtv_decoder_stage_bwd_f32 needs for these shapes:
// dzo (B, 2H, 2W), dzb (B, 2H, 2W, CD), dza (B, H, W, CD), the input
// gradients' weight sets and the weight gradients' partial sums.
extern "C" long long slowtv_decoder_stage_bwd_scratch_floats(int B, int H, int W,
                                                             int CI, int CD) {
  const long long p = (long long)B * H * W;
  long long part = wg_partial_floats(B, 2 * H, 2 * W, CD, 1);
  const long long pb = wg_partial_floats(B, 2 * H, 2 * W, CD, CD);
  const long long pa = wg_partial_floats(B, H, W, CI, CD);
  if (pb > part) part = pb;
  if (pa > part) part = pa;
  long long sets = 16LL * CD;
  if (25LL * CD * CD > sets) sets = 25LL * CD * CD;
  if (16LL * CI * CD > sets) sets = 16LL * CI * CD;
  return round4(4 * p) + round4(4 * p * CD) + round4(p * CD) + round4(sets) + round4(part);
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
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p = (long long)B * H * W;
  long long sets_n = 16LL * CD;
  if (25LL * CD * CD > sets_n) sets_n = 25LL * CD * CD;
  if (16LL * CI * CD > sets_n) sets_n = 16LL * CI * CD;
  float* dzo = scratch;
  float* dzb = dzo + round4(4 * p);
  float* dza = dzb + round4(4 * p * CD);
  float* sets = dza + round4(p * CD);
  float* part = sets + round4(sets_n);

  err = launch_1d(sigmoid_grad_kernel, cdiv(4 * p, kEwThreads), kEwThreads, 0, s, g_disp, disp,
                  dzo, 4 * p);
  if (err != cudaSuccess) return (int)err;
  if (need & 8) {
    err = launch_weight_grad<false>(feat, dzo, part, dwo, dbo, B, 2 * H, 2 * W, CD, 1, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(need & 7)) return 0;
  err = launch_input_grad<false>(dzo, wo, sets, g_feat, feat, dzb, B, 2 * H, 2 * W, CD, 1, s);
  if (err != cudaSuccess) return (int)err;
  if (need & 4) {
    err = launch_weight_grad<true>(ha, dzb, part, dwb, dbb, B, H, W, CD, CD, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(need & 3)) return 0;
  err = launch_input_grad<true>(dzb, wb, sets, nullptr, ha, dza, B, H, W, CD, CD, s);
  if (err != cudaSuccess) return (int)err;
  if (need & 2) {
    err = launch_weight_grad<false>(x, dza, part, dwa, dba, B, H, W, CI, CD, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (need & 1) {
    err = launch_input_grad<false>(dza, wa, sets, nullptr, nullptr, dx, B, H, W, CI, CD, s);
  }
  return (int)err;
}
