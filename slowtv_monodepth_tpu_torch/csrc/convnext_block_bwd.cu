// Fused ConvNeXt block, backward: from x, dy and the nine parameters of
//
//     y = x + gamma * fc2(gelu(fc1(LN(u)))),   u = dwconv7x7(x) + b_dw
//
// the cotangent du of u and the gradients of b_dw, the LayerNorm, fc1, fc2 and
// gamma. The caller finishes with the two depthwise transposes (kernel 1 with
// flipped taps for dx = dy + dwconv(du), kernel 2 for the taps' gradient), as
// the JAX package's _block_core_bwd does. Float32, NHWC, parameters in
// PyTorch's layouts: taps (C, 1, 7, 7), fc1 (4C, C), fc2 (C, 4C).
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_convnext.py:
// _bwd_kernel (launched by _block_bwd_jit); entry point _block_core_bwd.
// 54 launches per KBR micro-step with the fused blocks on both nets.
//
// Bound on Hopper: operations. The TPU kernel's six matrix products are
// 48 * pixels * C^2 float32 operations against ~12 * pixels * C bytes of
// x, dy, du and the gradients. This kernel computes five of them (the sixth,
// o = hg @ fc2^T, is needed only for dgamma, which the identity
// dgamma[c] = sum_j fc2[c, j] * (dy^T hg)[c, j] + b2[c] * sum_p dy[p, c]
// takes from the dW2 product instead): 40 * pixels * C^2. All five are
// hand-written float32 FMA loops (no tensor cores: TF32 would change the
// exact-float32 recipe's numerics).
//
// Design. The TPU kernel walks a sequential grid and adds the eight parameter
// gradients into resident output blocks. Hopper's thread blocks run in no
// order, and dW1 / dW2 are products with K = pixels whose per-tile partials
// would be 8 C^2 floats each, so the work is split by what each part sums
// over, and every sum runs in a fixed order (no atomics: the gradients are
// bitwise the same from run to run):
// 1. rows: one thread block per tile of M consecutive flattened pixels (M in
//    {8, 16, 32}; the ragged last tile masked). Recomputes the taps and the
//    LayerNorm (xhat, rstd, xln; xln also to scratch), then for each chunk of
//    256 hidden columns: h1 = xln fc1[chunk]^T + b1 and gelu'(h1) in
//    registers, hg to scratch; dhg = (dy * gamma) fc2[:, chunk] (a transposed
//    read of fc2); dh1 = dhg * gelu'(h1) to shared memory and scratch;
//    dxln += dh1 fc1[chunk, :] (a transposed read of fc1). Then the
//    LayerNorm backward writes du. The vector gradients leave as per-tile
//    column sums (8C floats a tile: sum dxln * xhat, sum dxln, sum du,
//    sum dy, sum dh1).
// 2. atb: G = dy^T hg (C, 4C) and dW1 = dh1^T xln (4C, C), tiled over their
//    OUTPUTS (64 x 64 per block), K running over the pixels in order; where
//    the output tiles are too few to fill the card, the pixels are cut into a
//    fixed number of groups, each a partial.
// 3. finish: the per-tile vector partials summed over the tiles, and the
//    weight partials over the groups, in order and in double; dW2 = gamma * G,
//    dgamma from the identity above, db2 = gamma * sum dy.
// Scratch (from the caller's allocator): xln (P, C), hg and dh1 (P, 4C), the
// per-tile partials and the group partials; see scratch_layout.
#include "convnext_common.cuh"

namespace {

constexpr int kVec = 8;      // per-tile partials: 8C floats (see rows kernel)
constexpr int kAT = 64;      // atb: output tile (kAT x kAT) per block
constexpr int kAK = 16;      // atb: pixels per K step
constexpr int kFillBlocks = 264;  // atb: two blocks per SM of an H100 (132 SMs)
constexpr int kMaxGroup = 256;    // atb: at most this many pixels summed in one float chain

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// hg = gelu(h) and dg = gelu'(h), erf or tanh form (pallas_convnext.py:265-277).
__device__ __forceinline__ void gelu_grad(float h, bool approximate, float& hg, float& dg) {
  if (approximate) {
    const float a = 0.7978845608028654f, k3 = 0.044715f;
    const float t = tanhf(a * (h + k3 * h * h * h));
    hg = 0.5f * h * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * a * (1.f + 3.f * k3 * h * h);
  } else {
    const float t = erff(h * 0.7071067811865475f);
    hg = 0.5f * h * (1.f + t);
    dg = 0.5f * (1.f + t) + h * 0.3989422804014327f * expf(-0.5f * h * h);
  }
}

// Launch 1. Shared memory: xln, xhat, dh2 (dy * gamma, later du) and dxln,
// [M][C + 4] each; one hidden chunk [M][kHS]; the weight tile [256][kWS]; rstd [M].
template <int RM>
__global__ void __launch_bounds__(kThreads, 1)
convnext_block_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                               const float* __restrict__ dww, const float* __restrict__ dwb,
                               const float* __restrict__ lnw, const float* __restrict__ lnb,
                               const float* __restrict__ w1, const float* __restrict__ b1,
                               const float* __restrict__ w2, const float* __restrict__ gamma,
                               float* __restrict__ du, float* __restrict__ xln_g,
                               float* __restrict__ hg_g, float* __restrict__ dh1_g,
                               float* __restrict__ part, int B, int H, int W, int C,
                               int approximate) {
  constexpr int M = kTM * RM;
  SLOWTV_DYNAMIC_SMEM(smem4);
  const int ldx = C + 4;
  float* xln = reinterpret_cast<float*>(smem4);  // [M][ldx]: taps, then LN output
  float* xhat = xln + M * ldx;                   // [M][ldx]
  float* dh2 = xhat + M * ldx;                   // [M][ldx]: dy * gamma, then du
  float* dxln = dh2 + M * ldx;                   // [M][ldx]: running sum over chunks
  float* hs = dxln + M * ldx;                    // [M][kHS]: one chunk of dh1
  float* Ws = hs + M * kHS;                      // [256][kWS]: weight tile
  float* rstd = Ws + kNP * kWS;                  // [M]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long pixels = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * M;
  const int hidden = 4 * C;
  float* tile_part = part + (long long)blockIdx.x * kVec * C;

  taps_tile(x, dww, dwb, xln, ldx, p0, pixels, M, H, W, C, 0, 1);
  for (int idx = t; idx < M * C; idx += kThreads) {
    const int m = idx / C, c = idx - m * C;
    const long long p = p0 + m;
    dh2[m * ldx + c] = p < pixels ? __ldg(dy + p * C + c) * __ldg(gamma + c) : 0.f;
    dxln[m * ldx + c] = 0.f;
  }
  __syncthreads();

  // LayerNorm, one warp per pixel, two passes; xhat and rstd kept for its backward.
  for (int q = warp; q < M; q += kThreads / 32) {
    float* u = xln + q * ldx;
    const long long p = p0 + q;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += u[c];
    const float mean = warp_sum(s) / (float)C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = u[c] - mean;
      v = fmaf(d, d, v);
    }
    const float r = 1.f / sqrtf(warp_sum(v) / (float)C + kEps);
    for (int c = lane; c < C; c += 32) {
      const float xh = (u[c] - mean) * r;
      const float val = xh * __ldg(lnw + c) + __ldg(lnb + c);
      xhat[q * ldx + c] = xh;
      u[c] = val;
      if (p < pixels) xln_g[p * C + c] = val;
    }
    if (lane == 0) rstd[q] = r;
  }

  // The hidden chunks: h1 and gelu' (registers), dhg, dh1, dxln.
  const int tn = thread_col(t), tm = thread_row(t);
  float acc[RM][kRN], dg[RM][kRN];
  for (int j0 = 0; j0 < hidden; j0 += kNP) {
    const int nh = hidden - j0 < kNP ? hidden - j0 : kNP;
    gemm_panel<RM, false>(xln, ldx, w1 + (long long)j0 * C, C, nh, C, Ws, acc);
#pragma unroll
    for (int i = 0; i < kRN; ++i) {
      const int n = tn + kTN * i;
      if (n < nh) {
        const float bias = __ldg(b1 + j0 + n);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          float hg;
          gelu_grad(acc[r][i] + bias, approximate, hg, dg[r][i]);
          const long long p = p0 + tm + kTM * r;
          if (p < pixels) hg_g[p * hidden + j0 + n] = hg;
        }
      }
    }
    // dhg[m, n] = sum_c dh2[m, c] * fc2[c, j0 + n]
    gemm_panel<RM, true>(dh2, ldx, w2 + j0, hidden, nh, C, Ws, acc);
#pragma unroll
    for (int i = 0; i < kRN; ++i) {
      const int n = tn + kTN * i;
      if (n < nh) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int m = tm + kTM * r;
          const float v = acc[r][i] * dg[r][i];
          hs[m * kHS + n] = v;
          if (p0 + m < pixels) dh1_g[(p0 + m) * hidden + j0 + n] = v;
        }
      }
    }
    __syncthreads();
    for (int n = t; n < nh; n += kThreads) {  // this tile's sum of dh1 (db1)
      float s = 0.f;
      for (int m = 0; m < M; ++m) s += hs[m * kHS + n];
      tile_part[4 * C + j0 + n] = s;
    }
    // dxln[m, c] += sum_n dh1[m, n] * fc1[j0 + n, c]
    for (int c0 = 0; c0 < C; c0 += kNP) {
      const int nc = C - c0 < kNP ? C - c0 : kNP;
      gemm_panel<RM, true>(hs, kHS, w1 + (long long)j0 * C + c0, C, nc, nh, Ws, acc);
#pragma unroll
      for (int i = 0; i < kRN; ++i) {
        const int n = tn + kTN * i;
        if (n < nc) {
#pragma unroll
          for (int r = 0; r < RM; ++r) dxln[(tm + kTM * r) * ldx + c0 + n] += acc[r][i];
        }
      }
    }
  }
  __syncthreads();

  // LayerNorm backward, one warp per pixel: du = (dxhat - mean(dxhat) -
  // xhat * mean(dxhat * xhat)) * rstd, dxhat = dxln * lnw; du replaces dh2.
  for (int q = warp; q < M; q += kThreads / 32) {
    const long long p = p0 + q;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = dxln[q * ldx + c] * __ldg(lnw + c);
      s1 += d;
      s2 = fmaf(d, xhat[q * ldx + c], s2);
    }
    const float m1 = warp_sum(s1) / (float)C, m2 = warp_sum(s2) / (float)C;
    for (int c = lane; c < C; c += 32) {
      const float d = dxln[q * ldx + c] * __ldg(lnw + c);
      const float v = (d - m1 - xhat[q * ldx + c] * m2) * rstd[q];
      dh2[q * ldx + c] = v;
      if (p < pixels) du[p * C + c] = v;
    }
  }
  __syncthreads();

  // This tile's column sums, in pixel order.
  const int live = pixels - p0 < M ? (int)(pixels - p0) : M;
  for (int c = t; c < C; c += kThreads) {
    float a = 0.f, b = 0.f, d = 0.f, e = 0.f;
    for (int m = 0; m < live; ++m) {
      a = fmaf(dxln[m * ldx + c], xhat[m * ldx + c], a);
      b += dxln[m * ldx + c];
      d += dh2[m * ldx + c];
      e += __ldg(dy + (p0 + m) * C + c);
    }
    tile_part[c] = a;          // -> d ln weight
    tile_part[C + c] = b;      // -> d ln bias
    tile_part[2 * C + c] = d;  // -> d b_dw
    tile_part[3 * C + c] = e;  // -> sum dy (db2, dgamma)
  }
}

// Launch 2: part[g][a][b] = sum over group g's pixels p of A[p][a] * B[p][b]
// (A: (P, Na), B: (P, Nb), row-major, Na and Nb multiples of 4). One block per
// (64 x 64 output tile, group); a thread owns rows a0 + ty + 16 i and columns
// b0 + tx + 16 j, i, j < 4; K steps of 16 pixels through shared memory.
__global__ void __launch_bounds__(kThreads)
convnext_block_bwd_atb_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                              long long P, int Na, int Nb, int G, float* __restrict__ part) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  float(*As)[kAT] = reinterpret_cast<float(*)[kAT]>(smem4);  // [kAK][kAT] each
  float(*Bs)[kAT] = As + kAK;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int tilesB = (Nb + kAT - 1) / kAT;
  const int g = (int)(blockIdx.x % G), tile = (int)(blockIdx.x / G);
  const int a0 = (tile / tilesB) * kAT, b0 = (tile % tilesB) * kAT;
  const long long chunk = (P + G - 1) / G;
  const long long pbeg = g * chunk, pend = pbeg + chunk < P ? pbeg + chunk : P;
  const int lk = t >> 4, l4 = (t & 15) * 4;  // this thread's load: pixel row, 4 columns
  float acc[4][4] = {};
  for (long long pk = pbeg; pk < pend; pk += kAK) {
    const long long p = pk + lk;
    const bool row = p < pend;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 va =
        row && a0 + l4 < Na ? __ldg(reinterpret_cast<const float4*>(A + p * Na + a0 + l4)) : z;
    const float4 vb =
        row && b0 + l4 < Nb ? __ldg(reinterpret_cast<const float4*>(Bm + p * Nb + b0 + l4)) : z;
    __syncthreads();  // the last step's reads are done
    *reinterpret_cast<float4*>(&As[lk][l4]) = va;
    *reinterpret_cast<float4*>(&Bs[lk][l4]) = vb;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty + 16 * i];
        b[i] = Bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  float* out = part + (long long)g * Na * Nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      if (a < Na && b < Nb) out[(long long)a * Nb + b] = acc[i][j];
    }
  }
}

// Launch 3a: the per-tile partials summed over the tiles (8 lanes each take
// every 8th tile, then the 8 lane sums in order; double). Outputs: the
// LayerNorm's two gradients, d b_dw, db1, db2 = gamma * sum dy, and sum dy
// itself for dgamma.
__global__ void __launch_bounds__(kThreads)
convnext_block_bwd_vec_kernel(const float* __restrict__ part, int tiles, int C,
                              const float* __restrict__ gamma, float* __restrict__ dlnw,
                              float* __restrict__ dlnb, float* __restrict__ ddwb,
                              float* __restrict__ db1, float* __restrict__ db2,
                              float* __restrict__ sum_dy) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  double(*red)[32] = reinterpret_cast<double(*)[32]>(smem4);  // [kThreads / 32][32]
  const int t = threadIdx.x, lane = t & 31, row = t >> 5;
  const int col = blockIdx.x * 32 + lane, cols = kVec * C;
  double s = 0.0;
  if (col < cols) {
    for (int i = row; i < tiles; i += kThreads / 32) s += (double)part[(long long)i * cols + col];
  }
  red[row][lane] = s;
  __syncthreads();
  if (row != 0 || col >= cols) return;
  for (int r = 1; r < kThreads / 32; ++r) s += red[r][lane];
  const float v = (float)s;
  if (col < C) {
    dlnw[col] = v;
  } else if (col < 2 * C) {
    dlnb[col - C] = v;
  } else if (col < 3 * C) {
    ddwb[col - 2 * C] = v;
  } else if (col < 4 * C) {
    sum_dy[col - 3 * C] = v;
    db2[col - 3 * C] = __ldg(gamma + col - 3 * C) * v;
  } else {
    db1[col - 4 * C] = v;
  }
}

// Launch 3b: out[r][c] = scale[r] * sum_g part[g][r][c] (scale null: 1), one
// warp per row, groups in order, in double. With dotw: dot[r] = sum_c dotw[r][c]
// * (that sum) + dotb[r] * dots[r] (dgamma).
__global__ void __launch_bounds__(kThreads)
convnext_block_bwd_finish_kernel(const float* __restrict__ part, int G, int R, int N,
                                 const float* __restrict__ scale, float* __restrict__ out,
                                 const float* __restrict__ dotw, const float* __restrict__ dotb,
                                 const float* __restrict__ dots, float* __restrict__ dot) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const float sc = scale ? __ldg(scale + r) : 1.f;
  double d = 0.0;
  for (int c = lane; c < N; c += 32) {
    double v = 0.0;
    for (int g = 0; g < G; ++g) v += (double)part[((long long)g * R + r) * N + c];
    out[(long long)r * N + c] = sc * (float)v;
    if (dotw) d += (double)__ldg(dotw + (long long)r * N + c) * v;
  }
  if (!dotw) return;
  d = warp_sum_d(d);
  if (lane == 0) dot[r] = (float)(d + (double)__ldg(dotb + r) * (double)__ldg(dots + r));
}

// atb's pixel groups: enough (output tile, group) blocks to fill the card, no
// chain longer than kMaxGroup pixels, no group under 64 pixels.
int groups(long long pixels, int na, int nb) {
  const long long tiles = (long long)((na + kAT - 1) / kAT) * ((nb + kAT - 1) / kAT);
  long long g = (kFillBlocks + tiles - 1) / tiles;
  const long long chain = (pixels + kMaxGroup - 1) / kMaxGroup;
  if (chain > g) g = chain;
  const long long most = (pixels + 63) / 64;
  if (g > most) g = most;
  return g < 1 ? 1 : (int)g;
}

// Offsets (in floats) of the scratch buffers; the last is the total.
struct Layout {
  long long xln, hg, dh1, part, gpart, wpart, sum_dy, total;
  int tiles, g2, g1;
};

Layout scratch_layout(long long pixels, int C, int M) {
  Layout l;
  l.tiles = (int)((pixels + M - 1) / M);
  l.g2 = groups(pixels, C, 4 * C);
  l.g1 = groups(pixels, 4 * C, C);
  l.xln = 0;
  l.hg = l.xln + pixels * C;
  l.dh1 = l.hg + pixels * 4 * C;
  l.part = l.dh1 + pixels * 4 * C;
  l.gpart = l.part + (long long)l.tiles * kVec * C;
  l.wpart = l.gpart + (long long)l.g2 * 4 * C * C;
  l.sum_dy = l.wpart + (long long)l.g1 * 4 * C * C;
  l.total = l.sum_dy + C;
  return l;
}

template <class K, class... Args>
cudaError_t launch_plain(K kernel, unsigned grid, size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int RM>
cudaError_t launch_rows(const float* x, const float* dy, const float* dww, const float* dwb,
                        const float* lnw, const float* lnb, const float* w1, const float* b1,
                        const float* w2, const float* gamma, float* du, float* scratch,
                        const Layout& l, int B, int H, int W, int C, int approximate,
                        cudaStream_t s) {
  constexpr int M = kTM * RM;
  const size_t bytes = sizeof(float) * ((size_t)4 * M * (C + 4) + M * kHS + kNP * kWS + M);
  // Above 48 KB shared memory is dynamic and has to be asked for, or the
  // launch is refused.
  cudaError_t err = cudaFuncSetAttribute(convnext_block_bwd_rows_kernel<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  return launch_plain(convnext_block_bwd_rows_kernel<RM>, (unsigned)l.tiles, bytes, s, x, dy,
                      dww, dwb, lnw, lnb, w1, b1, w2, gamma, du, scratch + l.xln,
                      scratch + l.hg, scratch + l.dh1, scratch + l.part, B, H, W, C,
                      approximate);
}

}  // namespace

// Floats of scratch that slowtv_convnext_block_bwd_f32 needs for these shapes
// and pixel tile M.
extern "C" long long slowtv_convnext_block_bwd_scratch_floats(int B, int H, int W, int C,
                                                              int M) {
  return scratch_layout((long long)B * H * W, C, M).total;
}

// x, dy, du (B, H, W, C); dww (C, 1, 7, 7); dwb, lnw, lnb, b2, gamma and their
// gradients ddwb, dlnw, dlnb, db2, dgamma (C,); w1, dw1 (4C, C); b1, db1 (4C,);
// w2, dw2 (C, 4C); scratch of slowtv_convnext_block_bwd_scratch_floats floats;
// all float32, contiguous, on `device`, 16-byte aligned; C a multiple of 4. M
// (8, 16 or 32) is the pixel tile of launch 1:
// 4 * (4 * M * (C + 4) + 260 * M + 256 * 36 + M) bytes of shared memory must
// fit the block's 227 KB. Launches on `stream` and returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int slowtv_convnext_block_bwd_f32(
    const float* x, const float* dy, const float* dww, const float* dwb, const float* lnw,
    const float* lnb, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* gamma, float* du, float* ddwb, float* dlnw, float* dlnb, float* dw1,
    float* db1, float* dw2, float* db2, float* dgamma, float* scratch, int B, int H, int W,
    int C, int M, int approximate, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 4 != 0 || C <= 0 || (M != 8 && M != 16 && M != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = (long long)B * H * W;
  const Layout l = scratch_layout(pixels, C, M);
  switch (M) {
    case 8:
      err = launch_rows<2>(x, dy, dww, dwb, lnw, lnb, w1, b1, w2, gamma, du, scratch, l, B, H,
                           W, C, approximate, s);
      break;
    case 16:
      err = launch_rows<4>(x, dy, dww, dwb, lnw, lnb, w1, b1, w2, gamma, du, scratch, l, B, H,
                           W, C, approximate, s);
      break;
    default:
      err = launch_rows<8>(x, dy, dww, dwb, lnw, lnb, w1, b1, w2, gamma, du, scratch, l, B, H,
                           W, C, approximate, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles_g = ((C + kAT - 1) / kAT) * ((4 * C + kAT - 1) / kAT);
  // G = dy^T hg and dW1 = dh1^T xln, per pixel group.
  const size_t atb_smem = sizeof(float) * 2 * kAK * kAT, vec_smem = sizeof(double) * kThreads;
  err = launch_plain(convnext_block_bwd_atb_kernel, (unsigned)(tiles_g * l.g2), atb_smem, s, dy,
                     (const float*)(scratch + l.hg), pixels, C, 4 * C, l.g2, scratch + l.gpart);
  if (err != cudaSuccess) return (int)err;
  err = launch_plain(convnext_block_bwd_atb_kernel, (unsigned)(tiles_g * l.g1), atb_smem, s,
                     (const float*)(scratch + l.dh1), (const float*)(scratch + l.xln), pixels,
                     4 * C, C, l.g1, scratch + l.wpart);
  if (err != cudaSuccess) return (int)err;
  err = launch_plain(convnext_block_bwd_vec_kernel, (unsigned)((kVec * C + 31) / 32), vec_smem, s,
                     (const float*)(scratch + l.part), l.tiles, C, gamma, dlnw, dlnb, ddwb, db1,
                     db2, scratch + l.sum_dy);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = kThreads / 32;
  err = launch_plain(convnext_block_bwd_finish_kernel,
                     (unsigned)((C + rows_per_block - 1) / rows_per_block), 0, s,
                     (const float*)(scratch + l.gpart), l.g2, C, 4 * C, gamma, dw2, w2, b2,
                     (const float*)(scratch + l.sum_dy), dgamma);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_plain(convnext_block_bwd_finish_kernel,
                           (unsigned)((4 * C + rows_per_block - 1) / rows_per_block), 0, s,
                           (const float*)(scratch + l.wpart), l.g1, 4 * C, C,
                           (const float*)nullptr, dw1, (const float*)nullptr,
                           (const float*)nullptr, (const float*)nullptr, (float*)nullptr);
}
