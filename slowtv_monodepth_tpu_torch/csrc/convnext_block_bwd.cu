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
// 54 calls per KBR micro-step with the fused blocks on both nets.
//
// Bound on Hopper: operations. The TPU kernel's six matrix products are
// 48 * pixels * C^2 float32 operations against ~12 * pixels * C bytes of
// x, dy, du and the gradients. This kernel computes five of them (the sixth,
// o = hg @ fc2^T, is needed only for dgamma, which the identity
// dgamma[c] = sum_j fc2[c, j] * (dy^T hg)[c, j] + b2[c] * sum_p dy[p, c]
// takes from the dW2 product instead): 40 * pixels * C^2, all as float32 FMA
// on the CUDA cores (no tensor cores: TF32 would change the exact-float32
// recipe's numerics).
//
// Design. The five products are large-tile SIMT matrix products on ONE core,
// `gemm_run` (convnext_common.cuh, shared with the forward): a block of 256
// threads owns a 128 x 128 output tile, each thread an 8 x 8 register tile;
// both operands are staged as [k][128] slabs of 32 k by 16-byte cp.async
// copies in a ring of two (mlp) or three (products), one barrier a slab.
// Every operand is read K-major (row k holds the tile's columns): the
// products' natural NT and NN forms (h1 = xln fc1^T, dhg = (dy gamma) fc2,
// dxln = dh1 fc1) are turned into that form by writing xln, dy * gamma and
// dh1 also transposed, (C or 4C, pixels), and fc1 as fc1^T, in the launches
// that produce them. The per-pixel work sits in the passes around the
// products and in their epilogues:
// 1. prep (per tile of M pixels): the taps and the LayerNorm (xln, xhat,
//    rstd; xln^T), (dy * gamma)^T, this tile's sum of dy; extra blocks
//    transpose fc1.
// 2. mlp (tile: 128 pixels x 128 hidden): h1 = xln fc1^T + b1, whose
//    epilogue writes hg = gelu(h1) and keeps gelu'(h1) in registers; then
//    dhg = (dy * gamma) fc2 in the same ring, whose epilogue writes dh1 =
//    dhg * gelu'(h1), dh1^T and this tile's column sums of dh1 (db1).
// 3. products, two kinds of block in one launch: the weight gradients G =
//    dy^T hg (C x 4C) and dW1 = dh1^T xln (4C x C), K = the pixels, a block
//    taking `splits_w`'th of them; and dxln = dh1 fc1 (128 pixels x 128
//    channels, K = 4C, cut into `splits_x` ranges where the tiles are too
//    few for the card). Either sums its K in float32 chains of `group` (<=
//    256), each chain added into a double accumulator in shared memory; one
//    partial per split.
// 4. ln (per tile of M pixels): dxln = the sum of its partials in order,
//    the LayerNorm backward -> du, the tile's column sums of dxln * xhat,
//    dxln and du.
// 5. finish: the weight partials summed over the splits in order in double:
//    dW1, dW2 = gamma * G, dgamma from the identity above, db2 = gamma *
//    sum dy; the vector partials over the tiles in double: the LayerNorm's
//    two gradients, d b_dw, db1.
// No atomics: every sum runs in a fixed order, so the gradients are bitwise
// the same from run to run. The plan (M, group, splits) is made by the
// caller (ops/convnext_block.py bwd_plan) for the card's SM count. Scratch
// (from the caller's allocator): see scratch_layout.
#include "convnext_common.cuh"

namespace {

constexpr int kMlpStages = 2;            // slabs in the ring: mlp (measured best at 2)
constexpr int kProductsStages = 3;       // products (3 x 2 slabs and the double sums: 227 KB)
constexpr int kVec = 4;                  // per-pixel-tile partials: 4C floats

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

// out[(m0 + row) * ld + n0 + col] = v for this thread's rows < m_end, as
// float4 column quads (quads at or past n_end, a multiple of 4, skipped).
__device__ __forceinline__ void store_quads(float* __restrict__ out, long long ld, int m0,
                                            long long m_end, int n0, int n_end,
                                            const float (&v)[kTile][kTile]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const long long r = (long long)m0 + tile_row(i);
    if (r >= m_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + tile_col(4 * h);
      if (c < n_end) {
        *reinterpret_cast<float4*>(out + r * ld + c) =
            make_float4(v[i][4 * h], v[i][4 * h + 1], v[i][4 * h + 2], v[i][4 * h + 3]);
      }
    }
  }
}

// Launch 1. Blocks [0, tiles): one per tile of M pixels, shared memory u
// [M][C + 4]; then one per 32 x 32 tile of fc1 -> fc1^T.
__global__ void __launch_bounds__(kThreads)
convnext_block_bwd_prep_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                               const float* __restrict__ dww, const float* __restrict__ dwb,
                               const float* __restrict__ lnw, const float* __restrict__ lnb,
                               const float* __restrict__ gamma, const float* __restrict__ w1,
                               float* __restrict__ xln, float* __restrict__ xhat,
                               float* __restrict__ xlnT, float* __restrict__ dygT,
                               float* __restrict__ w1T, float* __restrict__ rstd,
                               float* __restrict__ part, int B, int H, int W, int C, int M,
                               int tiles) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* u = reinterpret_cast<float*>(smem4);
  const int ldu = C + 4, t = threadIdx.x;
  const long long pixels = (long long)B * H * W, ldp = (pixels + 3) / 4 * 4;
  if ((int)blockIdx.x >= tiles) {  // fc1 (4C, C) -> w1T (C, 4C)
    transpose_tile(w1, w1T, 4 * C, C, blockIdx.x - tiles, u);
    return;
  }
  const long long p0 = (long long)blockIdx.x * M;
  const int live = pixels - p0 < M ? (int)(pixels - p0) : M;

  taps_tile(x, dww, dwb, u, ldu, p0, pixels, M, H, W, C);
  __syncthreads();
  layer_norm_rows(  // xln back into u
      u, ldu, live, C, lnw, lnb,
      [&](int q, int c, float xh, float val) {
        const long long p = p0 + q;
        xhat[p * C + c] = xh;
        xln[p * C + c] = val;
        u[q * ldu + c] = val;
      },
      [&](int q, float r) { rstd[p0 + q] = r; });
  __syncthreads();
  // xln^T (C, ldp): threads along the pixels.
  for (int e = t; e < C * M; e += kThreads) {
    const int c = e / M, m = e - c * M;
    if (m < live) xlnT[c * ldp + p0 + m] = u[m * ldu + c];
  }
  __syncthreads();
  for (int e = t; e < M * C; e += kThreads) {  // dy, threads along the channels
    const int m = e / C, c = e - m * C;
    u[m * ldu + c] = m < live ? __ldg(dy + (p0 + m) * C + c) : 0.f;
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {  // this tile's sum of dy, in pixel order
    float e = 0.f;
    for (int m = 0; m < live; ++m) e += u[m * ldu + c];
    part[(long long)blockIdx.x * kVec * C + 3 * C + c] = e;
  }
  for (int e = t; e < C * M; e += kThreads) {  // (dy * gamma)^T (C, ldp)
    const int c = e / M, m = e - c * M;
    if (m < live) dygT[c * ldp + p0 + m] = u[m * ldu + c] * __ldg(gamma + c);
  }
}

// Launch 2, one block per (128 pixels, 128 hidden) tile, hidden tiles
// fastest: h1 = xln fc1^T + b1, then dhg = (dy * gamma) fc2 in the same ring
// of slabs (K = C each).
__global__ void __launch_bounds__(kThreads, 1)
convnext_block_bwd_mlp_kernel(const float* __restrict__ xlnT, const float* __restrict__ dygT,
                              const float* __restrict__ w1T, const float* __restrict__ b1,
                              const float* __restrict__ w2, float* __restrict__ hg,
                              float* __restrict__ dh1, float* __restrict__ dh1T,
                              float* __restrict__ db1_part, long long pixels, int C,
                              int approximate) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* ring = reinterpret_cast<float*>(smem4);
  const int hidden = 4 * C, tiles_n = (hidden + kBN - 1) / kBN, nk = (C + kBK - 1) / kBK;
  const int mt = blockIdx.x / tiles_n, m0 = mt * kBM, n0 = (blockIdx.x % tiles_n) * kBN;
  const int m_end = (int)(pixels < m0 + kBM ? pixels : m0 + kBM);
  const long long ldp = (pixels + 3) / 4 * 4;
  const Operand xa{xlnT, ldp, m0, m_end}, wa{w1T, hidden, n0, hidden};
  const Operand ya{dygT, ldp, m0, m_end}, wb{w2, hidden, n0, hidden};
  float acc[kTile][kTile], dg[kTile][kTile];
  gemm_run<kMlpStages>(
      2 * nk, nk, ring, acc,
      [&](int i, float* As, float* Bs) {
        if (i < nk) {
          stage_pair(As, Bs, xa, wa, i * kBK, C);
        } else {
          stage_pair(As, Bs, ya, wb, (i - nk) * kBK, C);
        }
      },
      [&](int i) {
        if (i + 1 != nk) return;
        // h1 -> hg stored, gelu'(h1) kept; acc restarts for dhg.
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const int n = n0 + tile_col(j);
          const float bias = n < hidden ? __ldg(b1 + n) : 0.f;
#pragma unroll
          for (int r = 0; r < kTile; ++r) gelu_grad(acc[r][j] + bias, approximate, acc[r][j], dg[r][j]);
        }
        store_quads(hg, hidden, m0, m_end, n0, hidden, acc);
        zero(acc);
      });

  // dh1 = dhg * gelu'(h1), stored as (pixels, 4C) and as its transpose.
  const int t = threadIdx.x;
  float cs[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    cs[j] = 0.f;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      acc[r][j] *= dg[r][j];
      if (m0 + tile_row(r) < m_end) cs[j] += acc[r][j];
    }
    cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 8);  // the warp's four row groups
    cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
  }
  store_quads(dh1, hidden, m0, m_end, n0, hidden, acc);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int n = n0 + tile_col(j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + tile_row(4 * h);  // four pixels from here, in a row padded to 4
      if (n < hidden && r < m_end) {
        *reinterpret_cast<float4*>(dh1T + (long long)n * ldp + r) = make_float4(
            acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
      }
    }
  }

  // This tile's column sums of dh1: the four warps of a column half in order.
  __syncthreads();  // the ring's last readers are done
  float* red = ring;  // [4][kBN]
  if ((t & 31) < 8) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) red[((t >> 5) & 3) * kBN + tile_col(j)] = cs[j];
  }
  __syncthreads();
  if (t < kBN && n0 + t < hidden) {
    db1_part[(long long)mt * hidden + n0 + t] =
        ((red[t] + red[kBN + t]) + red[2 * kBN + t]) + red[3 * kBN + t];
  }
}

// Launch 3. Blocks [0, 2 * tiles_w * splits_w): weight-gradient tiles (G's,
// then dW1's; splits fastest): G = dy^T hg (C x 4C) or dW1 = dh1^T xln (4C x
// C) over one split's pixels. Then dxln tiles (splits fastest): dxln = dh1 fc1
// (pixels x C) over one split of the hidden units. Either sums its K in float32
// chains of `group`, each chain added into a double accumulator (shared
// memory, after the ring: 64 per thread); one partial per split.
__global__ void __launch_bounds__(kThreads, 1)
convnext_block_bwd_products_kernel(const float* __restrict__ dy, const float* __restrict__ hg,
                                   const float* __restrict__ dh1, const float* __restrict__ dh1T,
                                   const float* __restrict__ xln, const float* __restrict__ w1,
                                   float* __restrict__ dx_part, float* __restrict__ w_part,
                                   long long pixels, int C, int group, int splits_w,
                                   int splits_x) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* ring = reinterpret_cast<float*>(smem4);
  double* dacc = reinterpret_cast<double*>(ring + ring_floats(kProductsStages));  // [64][kThreads]
  const int t = threadIdx.x, hidden = 4 * C;
  const int tiles_c = (C + kBM - 1) / kBM, tiles_h = (hidden + kBM - 1) / kBM;
  const int tiles_w = tiles_c * tiles_h;
  int b = blockIdx.x, m0, n0, m_end, n_end, k0, k1;
  Operand a, bo;
  float* out;
  long long ldo;
  if (b < 2 * tiles_w * splits_w) {
    const int split = b % splits_w, tile = b / splits_w;
    const bool g = tile < tiles_w;
    const int tt = g ? tile : tile - tiles_w, tn = g ? tiles_h : tiles_c;
    m_end = g ? C : hidden;
    n_end = ldo = g ? hidden : C;
    m0 = (tt / tn) * kBM;
    n0 = (tt % tn) * kBN;
    const long long len = split_len(pixels, splits_w), p0 = split * len;
    k0 = (int)(p0 < pixels ? p0 : pixels);
    k1 = (int)(p0 + len < pixels ? p0 + len : pixels);
    a = Operand{g ? dy : dh1, m_end, m0, m_end};
    bo = Operand{g ? hg : xln, n_end, n0, n_end};
    out = w_part + ((long long)(g ? 0 : splits_w) + split) * C * hidden;
  } else {
    b -= 2 * tiles_w * splits_w;
    const int split = b % splits_x, tile = b / splits_x;
    m0 = (tile / tiles_c) * kBM;
    n0 = (tile % tiles_c) * kBN;
    m_end = (int)(pixels < m0 + kBM ? pixels : m0 + kBM);
    n_end = ldo = C;
    const int len = (int)split_len(hidden, splits_x);
    k0 = split * len < hidden ? split * len : hidden;
    k1 = k0 + len < hidden ? k0 + len : hidden;
    a = Operand{dh1T, (pixels + 3) / 4 * 4, m0, m_end};
    bo = Operand{w1, C, n0, C};
    out = dx_part + split * pixels * C;
  }
  const int nk = (k1 - k0 + kBK - 1) / kBK, per = group / kBK;
  float acc[kTile][kTile];
  gemm_run<kProductsStages>(
      nk, per, ring, acc,
      [&](int i, float* As, float* Bs) { stage_pair(As, Bs, a, bo, k0 + i * kBK, k1); },
      [&](int i) {
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            double& d = dacc[(r * kTile + j) * kThreads + t];
            d = (i < per ? 0.0 : d) + (double)acc[r][j];
          }
        }
        zero(acc);
      });
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      acc[r][j] = nk > 0 ? (float)dacc[(r * kTile + j) * kThreads + t] : 0.f;
    }
  }
  store_quads(out, ldo, m0, m_end, n0, n_end, acc);
}

// Launch 4, one block per tile of M pixels. Shared memory: dxln [M][C + 4],
// then the two row means of each pixel.
__global__ void __launch_bounds__(kThreads)
convnext_block_bwd_ln_kernel(const float* __restrict__ dx_part, int splits_x,
                             const float* __restrict__ xhat, const float* __restrict__ rstd,
                             const float* __restrict__ lnw, float* __restrict__ du,
                             float* __restrict__ part, long long pixels, int C, int M) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  const int ldx = C + 4, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float* dx = reinterpret_cast<float*>(smem4);
  float* m1 = dx + M * ldx;
  float* m2 = m1 + M;
  const long long p0 = (long long)blockIdx.x * M, plane = pixels * C;
  const int live = pixels - p0 < M ? (int)(pixels - p0) : M;
  // dxln (its partials in order) and the row means of dxhat = dxln * lnw and
  // of dxhat * xhat, one warp per pixel.
  for (int q = warp; q < live; q += kWarps) {
    const long long p = p0 + q;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = dx_part[p * C + c];
      for (int s = 1; s < splits_x; ++s) v += dx_part[s * plane + p * C + c];
      dx[q * ldx + c] = v;
      const float d = v * __ldg(lnw + c);
      s1 += d;
      s2 = fmaf(d, xhat[p * C + c], s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m1[q] = s1 / (float)C;
      m2[q] = s2 / (float)C;
    }
  }
  __syncthreads();
  // du = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd, and this
  // tile's column sums in pixel order.
  for (int c = t; c < C; c += kThreads) {
    const float w = __ldg(lnw + c);
    float a = 0.f, b = 0.f, d = 0.f;
#pragma unroll 8
    for (int m = 0; m < live; ++m) {
      const long long p = p0 + m;
      const float g = dx[m * ldx + c], xh = xhat[p * C + c];
      const float v = (g * w - m1[m] - xh * m2[m]) * rstd[p];
      du[p * C + c] = v;
      a = fmaf(g, xh, a);
      b += g;
      d += v;
    }
    float* tp = part + (long long)blockIdx.x * kVec * C;
    tp[c] = a;          // -> d ln weight
    tp[C + c] = b;      // -> d ln bias
    tp[2 * C + c] = d;  // -> d b_dw
  }
}

// Launch 5. Blocks [0, ceil(C / 8)): rows of G, one warp each -> dW2, dgamma,
// db2; then rows of dW1 (one warp each); then columns of the vector
// gradients, 32 a block (the LayerNorm's two, d b_dw from the pixel tiles'
// partials; db1 from the mlp tiles'). Sums in double, in a fixed order.
__global__ void __launch_bounds__(kThreads)
convnext_block_bwd_finish_kernel(const float* __restrict__ w_part, int splits_w,
                                 const float* __restrict__ part, int tiles,
                                 const float* __restrict__ db1_part, int mtiles, int C,
                                 const float* __restrict__ w2, const float* __restrict__ b2,
                                 const float* __restrict__ gamma, float* __restrict__ dw1,
                                 float* __restrict__ dw2, float* __restrict__ dgamma,
                                 float* __restrict__ db2, float* __restrict__ dlnw,
                                 float* __restrict__ dlnb, float* __restrict__ ddwb,
                                 float* __restrict__ db1) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, hidden = 4 * C;
  const int g_blocks = (C + kWarps - 1) / kWarps, w_blocks = (hidden + kWarps - 1) / kWarps;
  const int b = blockIdx.x;
  if (b < g_blocks + w_blocks) {
    const bool g = b < g_blocks;
    const int r = (g ? b : b - g_blocks) * kWarps + warp, rows = g ? C : hidden;
    const int cols = g ? hidden : C;
    if (r >= rows) return;
    const float* src = w_part + (g ? 0 : (long long)splits_w * C * hidden) + (long long)r * cols;
    const float sc = g ? __ldg(gamma + r) : 1.f;
    float* out = (g ? dw2 : dw1) + (long long)r * cols;
    const long long step = (long long)rows * cols;  // from one split's partial to the next
    double d = 0.0;
#pragma unroll 4
    for (int c = 4 * lane; c < cols; c += 128) {  // a float4 of columns a lane
      double v[4] = {0.0, 0.0, 0.0, 0.0};
      for (int s = 0; s < splits_w; ++s) {
        const float4 q = *reinterpret_cast<const float4*>(src + s * step + c);
        v[0] += (double)q.x;
        v[1] += (double)q.y;
        v[2] += (double)q.z;
        v[3] += (double)q.w;
      }
      *reinterpret_cast<float4*>(out + c) =
          make_float4(sc * (float)v[0], sc * (float)v[1], sc * (float)v[2], sc * (float)v[3]);
      if (g) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(w2 + (long long)r * cols + c));
        d += (double)f.x * v[0] + (double)f.y * v[1] + (double)f.z * v[2] + (double)f.w * v[3];
      }
    }
    if (!g) return;
    d = warp_sum_d(d);
    double s = 0.0;  // sum of dy: every 32nd pixel tile a lane, then the lanes
#pragma unroll 8
    for (int i = lane; i < tiles; i += 32) s += (double)part[(long long)i * kVec * C + 3 * C + r];
    const float sum_dy = (float)warp_sum_d(s);
    if (lane == 0) {
      dgamma[r] = (float)(d + (double)__ldg(b2 + r) * (double)sum_dy);
      db2[r] = __ldg(gamma + r) * sum_dy;
    }
    return;
  }
  // Vector columns: [0, 3C) from the pixel tiles' partials, [3C, 3C + 4C) db1.
  double(*red)[32] = reinterpret_cast<double(*)[32]>(smem4);  // [kWarps][32]
  const int col = (b - g_blocks - w_blocks) * 32 + lane, cols = 3 * C + hidden;
  const bool vec = col < 3 * C;
  const float* src = vec ? part + col : db1_part + (col - 3 * C);
  const long long stride = vec ? (long long)kVec * C : hidden;
  const int n = vec ? tiles : mtiles;
  double s = 0.0;
  if (col < cols) {
    for (int i = warp; i < n; i += kWarps) s += (double)src[i * stride];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= cols) return;
  for (int w = 1; w < kWarps; ++w) s += red[w][lane];
  const float v = (float)s;
  if (col < C) {
    dlnw[col] = v;
  } else if (col < 2 * C) {
    dlnb[col - C] = v;
  } else if (col < 3 * C) {
    ddwb[col - 2 * C] = v;
  } else {
    db1[col - 3 * C] = v;
  }
}

// Offsets (in floats) of the scratch buffers; the last is the total. ldp:
// the pixels rounded up to 4, the row of the transposed activations. (dy *
// gamma)^T shares its buffer with dxln's partials (mlp reads the one before
// products writes the others).
struct Layout {
  long long ldp, xln, xhat, xlnT, dx_part, rstd, hg, dh1, dh1T, w1T, part, db1_part, w_part,
      total;
  int tiles, mtiles;
};

Layout scratch_layout(long long pixels, int C, int M, int splits_w, int splits_x) {
  Layout l;
  const long long plane = pixels * C, hidden = 4LL * C;
  const long long dx = splits_x * plane, dyg = C * ((pixels + 3) / 4 * 4);
  l.tiles = (int)((pixels + M - 1) / M);
  l.mtiles = (int)((pixels + kBM - 1) / kBM);
  l.ldp = (pixels + 3) / 4 * 4;
  l.xln = 0;
  l.xhat = l.xln + plane;
  l.xlnT = l.xhat + plane;
  l.dx_part = l.xlnT + C * l.ldp;
  l.rstd = l.dx_part + (dx > dyg ? dx : dyg);
  l.hg = l.rstd + l.ldp;
  l.dh1 = l.hg + pixels * hidden;
  l.dh1T = l.dh1 + pixels * hidden;
  l.w1T = l.dh1T + hidden * l.ldp;
  l.part = l.w1T + hidden * C;
  l.db1_part = l.part + (long long)l.tiles * kVec * C;
  l.w_part = l.db1_part + l.mtiles * hidden;
  l.total = l.w_part + 2LL * splits_w * C * hidden;
  return l;
}

}  // namespace

// Floats of scratch that slowtv_convnext_block_bwd_f32 needs for these shapes
// and plan.
extern "C" long long slowtv_convnext_block_bwd_scratch_floats(int B, int H, int W, int C, int M,
                                                              int splits_w, int splits_x) {
  return scratch_layout((long long)B * H * W, C, M, splits_w, splits_x).total;
}

// x, dy, du (B, H, W, C); dww (C, 1, 7, 7); dwb, lnw, lnb, b2, gamma and their
// gradients ddwb, dlnw, dlnb, db2, dgamma (C,); w1, dw1 (4C, C); b1, db1 (4C,);
// w2, dw2 (C, 4C); scratch of slowtv_convnext_block_bwd_scratch_floats floats;
// all float32, contiguous, on `device`, 16-byte aligned; C a multiple of 4.
// The plan: M (8, 16 or 32) pixels per tile of the per-pixel launches, whose
// 4 * (M * (C + 4) + 2 * M) bytes of shared memory must fit the block's
// 227 KB; `group` (a multiple of 32, at most 256) pixels per float32 chain of
// the weight gradients; splits_w >= 1 pixel splits of the weight gradients;
// splits_x >= 1 splits of dxln's K. Launches on `stream` and returns the
// first failing launch's cudaError_t (0 on success).
extern "C" int slowtv_convnext_block_bwd_f32(
    const float* x, const float* dy, const float* dww, const float* dwb, const float* lnw,
    const float* lnb, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* gamma, float* du, float* ddwb, float* dlnw, float* dlnb, float* dw1,
    float* db1, float* dw2, float* db2, float* dgamma, float* scratch, int B, int H, int W,
    int C, int M, int group, int splits_w, int splits_x, int approximate, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 4 != 0 || C <= 0 || (M != 8 && M != 16 && M != 32) || group % kBK != 0 ||
      group <= 0 || group > kMaxGroup || splits_w < 1 || splits_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = (long long)B * H * W;
  const int hidden = 4 * C;
  const Layout l = scratch_layout(pixels, C, M, splits_w, splits_x);
  float* xln = scratch + l.xln;
  float* xhat = scratch + l.xhat;
  float* xlnT = scratch + l.xlnT;
  float* dx_part = scratch + l.dx_part;  // (dy * gamma)^T first
  float* rstd = scratch + l.rstd;
  float* hg = scratch + l.hg;
  float* dh1 = scratch + l.dh1;
  float* dh1T = scratch + l.dh1T;
  float* w1T = scratch + l.w1T;
  float* part = scratch + l.part;
  float* db1_part = scratch + l.db1_part;
  float* w_part = scratch + l.w_part;
  const size_t row_smem = sizeof(float) * ((size_t)M * (C + 4) + 2 * M);
  const size_t prep_smem = row_smem > sizeof(float) * 32 * 33 ? row_smem : sizeof(float) * 32 * 33;
  const size_t mlp_smem = sizeof(float) * ring_floats(kMlpStages);
  const size_t products_smem =
      sizeof(float) * ring_floats(kProductsStages) + sizeof(double) * kTile * kTile * kThreads;
  const int tiles_h = (hidden + kBN - 1) / kBN, tiles_c = (C + kBN - 1) / kBN;

  err = launch(convnext_block_bwd_prep_kernel,
               (unsigned)(l.tiles + (hidden + 31) / 32 * ((C + 31) / 32)), prep_smem, 0, s, x,
               dy, dww, dwb, lnw, lnb, gamma, w1, xln, xhat, xlnT, dx_part, w1T, rstd, part, B,
               H, W, C, M, l.tiles);
  if (err != cudaSuccess) return (int)err;
  err = launch(convnext_block_bwd_mlp_kernel, (unsigned)(l.mtiles * tiles_h), mlp_smem, 0, s,
               (const float*)xlnT, (const float*)dx_part, (const float*)w1T, b1, w2, hg, dh1,
               dh1T, db1_part, pixels, C, approximate);
  if (err != cudaSuccess) return (int)err;
  const unsigned products = (unsigned)(2 * tiles_c * tiles_h * splits_w +
                                       l.mtiles * tiles_c * splits_x);
  err = launch(convnext_block_bwd_products_kernel, products, products_smem, 0, s, dy,
               (const float*)hg, (const float*)dh1, (const float*)dh1T, (const float*)xln, w1,
               dx_part, w_part, pixels, C, group, splits_w, splits_x);
  if (err != cudaSuccess) return (int)err;
  err = launch(convnext_block_bwd_ln_kernel, (unsigned)l.tiles, row_smem, 0, s,
               (const float*)dx_part, splits_x, (const float*)xhat, (const float*)rstd, lnw, du,
               part, pixels, C, M);
  if (err != cudaSuccess) return (int)err;
  const unsigned finish = (unsigned)((C + kWarps - 1) / kWarps + (hidden + kWarps - 1) / kWarps +
                                     (3 * C + hidden + 31) / 32);
  return (int)launch(convnext_block_bwd_finish_kernel, finish, sizeof(double) * kThreads, 0, s,
                     (const float*)w_part, splits_w, (const float*)part, l.tiles,
                     (const float*)db1_part, l.mtiles, C, w2, b2, gamma, dw1, dw2, dgamma, db2,
                     dlnw, dlnb, ddwb, db1);
}
