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
// decoder runs it for its two full-resolution stages (scales 1 and 0). The
// TPU kernel keeps ha on chip because its backward recomputes it; here ha is
// written, since the backward (decoder_stage_bwd.cu) reads it.
//
// Bound on Hopper: operations. At 16-64 channels each conv does 9 * CI
// multiply-adds per output value against 4 * CI bytes of input per pixel:
// the stage sits on the float32 pipe (exact float32, no tensor cores), above
// the bytes it must move (x in, feat and disp out: 0.044 ms per KBR
// micro-step at 3.35 TB/s). Counted as this kernel computes it (conv_b as
// four pre-summed taps, below), a KBR micro-step's two stages (B=4, 384x640)
// do 9.0 GFLOP: 0.134 ms at 67 TFLOP/s (0.209 ms for the 9-tap count, 14.0
// GFLOP). So the design is about FMAs per shared-memory load and about the
// 9-tap gather of the upsampled grid that it leaves out. On an H100 at 700 W
// it takes 0.449 ms per micro-step (tools/decoder_stage_bench.py).
//
// Design: three launches, one per conv, on the caller's stream.
// - Register-tiled direct convs. A block owns a tile of R rows x 32 columns of
//   the grid its threads walk (x's for conv_a, ha's for conv_b, feat's for
//   disp) and a run of output channels. Per chunk of at most 32 input
//   channels it copies the tile's input with a 1-pixel halo into shared
//   memory (16-byte cp.async when the channels come in fours from an aligned
//   pointer, else scalar loads with zeros past the last channel), folding the
//   conv's own padding into the copy, and the chunk's weights, reordered so
//   that a thread's weights for one input channel are contiguous. Shared
//   memory holds the input as [channel / 4][row][column][4]: the 32 lanes of a
//   warp (32 neighbouring columns) read 32 neighbouring float4s, which no two
//   lanes' banks share. The warps of a block split its rows and its output
//   channels, so every lane of a warp reads the same weights: a broadcast.
// - A thread owns P rows of one column x TO output channels and walks the
//   input channels four at a time: per tap column the P + 2 input float4s of
//   its rows feed all three tap rows (a sliding window down the column).
//   conv_a (P = 4, TO = 8): 30 shared loads per 384 FMAs; disp (P = 8, TO = 1):
//   39 per 288.
// - conv_b never builds the upsampled grid. Output (2y + py, 2x + px) reads u
//   rows 2y + py - 1 .. 2y + py + 1, i.e. two ha rows: for py = 0, ha[y - 1]
//   with tap {0} and ha[y] with taps {1, 2}; for py = 1, ha[y] with taps
//   {0, 1} and ha[y + 1] with tap {2} (tap_set); the same per column. Each of
//   the four parities is a 2 x 2 conv over ha with pre-summed weights: 16
//   matrices of CD x CD, which each block sums from wb as it stages them, in
//   place of a launch that would sum them into scratch: on an H100 the
//   pre-sums cost conv_b 0.0175 of its 0.195 ms per micro-step (a copy of
//   this file without them), less than such a launch could save after its
//   own two launches' cost. conv_b does 16 products per
//   ha pixel where the 9-tap gather of u did 36. Reflection on the upsampled
//   grid (u[-1] = u[1] = ha[0], u[2H] = u[2H - 2] = ha[H - 1]) is the same as
//   clamping the ha index, so the border rows and columns need no tap sets
//   of their own: the staged ha tile is clamped, and at y = 0 the {0} and
//   {1, 2} products both read ha[0]. A thread owns P = 4 ha rows of one
//   column x TO = 4 channels, all four parities (64 accumulators): 82 shared
//   loads per 1024 FMAs.
// - ha and feat leave through shared memory: a thread's own float4s lie 128
//   to 256 bytes apart in NHWC, so the block writes its output tile there
//   ([row][column][channel]) and copies it out with neighbouring threads on
//   neighbouring float4s. disp's lanes already store neighbouring floats.
// - disp is a launch of its own, not conv_b's epilogue: the epilogue would
//   need feat's 1-pixel ring around each tile, recomputed outside the
//   register tiles (148 ring pixels to 512 at stage 1's tiles of 4 ha rows).
// - Tile rows, channel warps and the channel chunk come from the host's plan
//   (ops/decoder_stage.py:fwd_plan, for the card's SM count); the shared
//   memory a plan needs is slowtv_decoder_stage_fwd_smem_bytes here, which
//   the plan mirrors. No atomics: two calls give the same bits.
//
// Launches go through cudaLaunchKernelEx and shared memory is dynamic
// (SLOWTV_DYNAMIC_SMEM), so tests/cuda_emu builds this file for the CPU.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTileW = 32;             // columns a block walks: one per lane
constexpr int kTileCols = kTileW + 2;  // with the halo
constexpr int kConvA = 0, kConvB = 1, kDisp = 2;

// Rows a thread owns (P), output channels a thread owns (TO) and weight
// matrices per input channel (NT: 9 taps, or 16 pre-summed parity taps).
template <int CONV> struct Conv;
template <> struct Conv<kConvA> { static constexpr int P = 4, TO = 8, NT = 9; };
template <> struct Conv<kConvB> { static constexpr int P = 4, TO = 4, NT = 16; };
template <> struct Conv<kDisp> { static constexpr int P = 8, TO = 1, NT = 9; };

struct ConvArgs {
  const float* in;
  const float* w;
  const float* bias;
  float* out;
  int H, W;        // the grid the threads walk (conv_b: ha's; its output is 2H x 2W)
  int CIN, COUT;
  int rg, cgb, cic;  // plan: row warps, channel warps, input channels per chunk
  int row_tiles, col_tiles, chan_tiles;
  int vec_in, vec_out;  // 16-byte input copies, float4 output stores
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The taps of one axis that read source offset a (0: the lower, 1: the upper
// of the two ha values) for output parity p, as a bit mask over taps 0, 1, 2.
__device__ __forceinline__ int tap_set(int p, int a) {
  return p == 0 ? (a == 0 ? 1 : 6) : (a == 0 ? 3 : 4);
}

// The source index of padded index i on an axis of n >= 2: reflected (x and
// feat on their own grids), or clamped (ha, which is reflection on the
// upsampled grid). Indices past n + 1 only feed outputs past the edge.
template <bool CLAMP>
__device__ __forceinline__ int src_index(int i, int n) {
  if (CLAMP) return i < 0 ? 0 : (i < n ? i : n - 1);
  return i < 0 ? -i : (i < n ? i : (i == n ? n - 2 : n - 1));
}

__device__ __forceinline__ float part(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A block's work split as (row, item of a row): a thread takes item k of rows
// r0, r0 + step, ...; (r0, k) from one division, the row loop free of them.
struct RowSplit {
  int r0, k, step;
};
__device__ __forceinline__ bool row_split(int t, int per_row, int threads, RowSplit& s) {
  s.step = threads >= per_row ? threads / per_row : 1;
  if (t >= per_row * s.step) return false;
  s.r0 = t / per_row;
  s.k = t - s.r0 * per_row;
  return true;
}

// The tile's input channels [c0, c0 + nc) of rows ys .. ys + rows - 1 and
// columns xs .. xs + kTileCols - 1 into s_in[c / 4][row][column][4], zeros
// past nc; a pixel's channels go to neighbouring threads.
template <bool CLAMP>
__device__ __forceinline__ void stage_tile(float* s_in, const ConvArgs& a, int b, int ys,
                                           int xs, int rows, int c0, int nc, int n4,
                                           int tile_c4, int threads) {
  RowSplit sp;
  for (int t = threadIdx.x; row_split(t, kTileCols * n4, threads, sp); t += threads) {
    const int c4 = sp.k % n4, col = sp.k / n4;
    const int sx = src_index<CLAMP>(xs + col, a.W);
    const float* src0 = a.in + ((long long)b * a.H * a.W + sx) * a.CIN + c0 + 4 * c4;
    const long long row_stride = (long long)a.W * a.CIN;
    float* dst0 = s_in + c4 * tile_c4 + col * 4;
    const int left = nc - 4 * c4;
    for (int r = sp.r0; r < rows; r += sp.step) {
      const float* src = src0 + src_index<CLAMP>(ys + r, a.H) * row_stride;
      float* dst = dst0 + r * kTileCols * 4;
      if (a.vec_in) {
        __pipeline_memcpy_async(dst, src, 16);
      } else {
        float4 v;
        v.x = __ldg(src);
        v.y = left > 1 ? __ldg(src + 1) : 0.f;
        v.z = left > 2 ? __ldg(src + 2) : 0.f;
        v.w = left > 3 ? __ldg(src + 3) : 0.f;
        *reinterpret_cast<float4*>(dst) = v;
      }
    }
  }
}

// The chunk's weights for the block's output channels [cb0, cb0 + cgb * TO)
// into s_w[ci / 4][channel warp][tap][ci % 4][TO], zeros past CIN and COUT:
// the 9 taps of w, or for conv_b the 16 pre-summed parity taps
// q = ((py * 2 + px) * 2 + a) * 2 + c.
template <int CONV>
__device__ __forceinline__ void stage_weights(float* s_w, const ConvArgs& a, int cb0, int c0,
                                              int nc, int n4, int threads) {
  constexpr int TO = Conv<CONV>::TO, NT = Conv<CONV>::NT;
  const int ncp = 4 * n4;
  if constexpr (CONV != kConvB) {
    // A thread copies the 9 taps of (co, ci), neighbouring threads neighbouring
    // ci: contiguous reads of OIHW, 4-byte cp.async copies.
    const int items = a.cgb * TO * ncp;
    for (int i = threadIdx.x; i < items; i += threads) {
      const int ci = i % ncp, co = i / ncp;
      const bool ok = cb0 + co < a.COUT && ci < nc;
      const float* src = a.w + ((long long)(cb0 + co) * a.CIN + c0 + ci) * 9;
      float* dst = s_w + (((ci >> 2) * a.cgb + co / TO) * NT * 4 + (ci & 3)) * TO + co % TO;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (ok) {
          __pipeline_memcpy_async(dst + tap * 4 * TO, src + tap, 4);
        } else {
          dst[tap * 4 * TO] = 0.f;
        }
      }
    }
  } else {
    const int items = a.cgb * TO * ncp;
#pragma unroll 4
    for (int i = threadIdx.x; i < items; i += threads) {
      const int ci = i % ncp, co = i / ncp;
      const bool ok = cb0 + co < a.COUT && ci < nc;
      const float* src = a.w + ((long long)(cb0 + co) * a.CIN + c0 + ci) * 9;
      float t[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) t[k] = ok ? __ldg(src + k) : 0.f;
      float* dst = s_w + (((ci >> 2) * a.cgb + co / TO) * NT * 4 + (ci & 3)) * TO + co % TO;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int my = tap_set(q >> 3, (q >> 1) & 1), mx = tap_set((q >> 2) & 1, q & 1);
        float s = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            if ((my >> ky & 1) && (mx >> kx & 1)) s += t[ky * 3 + kx];
          }
        }
        dst[q * 4 * TO] = s;
      }
    }
  }
}

// The TO weights of input channel j of the current four, at w[j][TO].
template <int TO>
__device__ __forceinline__ void load_weights(const float* w, float (&wv)[4][TO]) {
  if constexpr (TO == 1) {
    const float4 q = ld4(w);
    wv[0][0] = q.x; wv[1][0] = q.y; wv[2][0] = q.z; wv[3][0] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int o4 = 0; o4 < TO / 4; ++o4) {
        const float4 q = ld4(w + j * TO + 4 * o4);
        wv[j][4 * o4] = q.x; wv[j][4 * o4 + 1] = q.y;
        wv[j][4 * o4 + 2] = q.z; wv[j][4 * o4 + 3] = q.w;
      }
    }
  }
}

// acc[i][o] += sum over taps and four input channels of in[row i + ky][col + kx]
// * w[tap][o]: tp is the thread's column at its first row (tile row ry, the
// halo row above its first output row), wp its weights for these channels.
template <int P, int TO>
__device__ __forceinline__ void conv_products(float (&acc)[P][1][TO], const float* tp,
                                              const float* wp) {
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float4 v[P + 2];
#pragma unroll
    for (int r = 0; r < P + 2; ++r) v[r] = ld4(tp + (r * kTileCols + kx) * 4);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      float wv[4][TO];
      load_weights<TO>(wp + (ky * 3 + kx) * 4 * TO, wv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float xv = part(v[i + ky], j);
#pragma unroll
          for (int o = 0; o < TO; ++o) acc[i][0][o] = fmaf(xv, wv[j][o], acc[i][0][o]);
        }
      }
    }
  }
}

// conv_b: acc[i][py * 2 + px][o] += the four pre-summed parity taps over the
// 2 x 2 ha neighbourhood of output (2y + py, 2x + px), y the thread's ha row
// i: tile row i + py + a, tile column dc = px + c (the thread's ha column is
// dc = 1).
template <int P, int TO>
__device__ __forceinline__ void up_products(float (&acc)[P][4][TO], const float* tp,
                                            const float* wp) {
#pragma unroll
  for (int dc = 0; dc < 3; ++dc) {
    float4 v[P + 2];
#pragma unroll
    for (int r = 0; r < P + 2; ++r) v[r] = ld4(tp + (r * kTileCols + dc) * 4);
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      const int c = dc - px;
      if (c < 0 || c > 1) continue;
#pragma unroll
      for (int py = 0; py < 2; ++py) {
#pragma unroll
        for (int aa = 0; aa < 2; ++aa) {
          float wv[4][TO];
          load_weights<TO>(wp + (((py * 2 + px) * 2 + aa) * 2 + c) * 4 * TO, wv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < P; ++i) {
              const float xv = part(v[i + py + aa], j);
#pragma unroll
              for (int o = 0; o < TO; ++o) {
                acc[i][py * 2 + px][o] = fmaf(xv, wv[j][o], acc[i][py * 2 + px][o]);
              }
            }
          }
        }
      }
    }
  }
}

template <int CONV>
__device__ __forceinline__ void conv_block(const ConvArgs& a) {
  constexpr int P = Conv<CONV>::P, TO = Conv<CONV>::TO, NT = Conv<CONV>::NT;
  constexpr bool UP = CONV == kConvB;
  constexpr int NQ = UP ? 4 : 1;  // outputs per pixel and channel: the parities
  SLOWTV_DYNAMIC_SMEM(smem4);
  const int R = a.rg * P, threads = 32 * a.rg * a.cgb;
  const int tile_c4 = (R + 2) * kTileCols * 4;  // floats per four channels of the tile
  float* s_in = reinterpret_cast<float*>(smem4);
  float* s_w = s_in + (a.cic / 4) * tile_c4;

  // Block -> (image, tile row, tile column, channel tile), channel tiles fastest.
  int blk = blockIdx.x;
  const int ct = blk % a.chan_tiles;
  blk /= a.chan_tiles;
  const int tc = blk % a.col_tiles;
  blk /= a.col_tiles;
  const int tr = blk % a.row_tiles, b = blk / a.row_tiles;
  const int y0 = tr * R, x0 = tc * kTileW, cb0 = ct * a.cgb * TO;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = warp % a.cgb, ry = (warp / a.cgb) * P;
  const int co0 = cb0 + cg * TO;

  float acc[P][NQ][TO];
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    const float bias = co0 + o < a.COUT ? __ldg(a.bias + co0 + o) : 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[i][q][o] = bias;
    }
  }

  for (int c0 = 0; c0 < a.CIN; c0 += a.cic) {
    const int nc = a.CIN - c0 < a.cic ? a.CIN - c0 : a.cic, n4 = (nc + 3) / 4;
    stage_tile<UP>(s_in, a, b, y0 - 1, x0 - 1, R + 2, c0, nc, n4, tile_c4, threads);
    stage_weights<CONV>(s_w, a, cb0, c0, nc, n4, threads);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const float* tp = s_in + (ry * kTileCols + lane) * 4;
    const float* wp = s_w + cg * NT * 4 * TO;
    for (int c4 = 0; c4 < n4; ++c4, tp += tile_c4, wp += a.cgb * NT * 4 * TO) {
      if constexpr (UP) {
        up_products<P, TO>(acc, tp, wp);
      } else {
        conv_products<P, TO>(acc, tp, wp);
      }
    }
    __syncthreads();
  }

  const int Ho = UP ? 2 * a.H : a.H, Wo = UP ? 2 * a.W : a.W;
  if constexpr (TO == 1) {
    // disp: a lane's pixel, the warp's 32 neighbouring floats in one store.
    const int x = x0 + lane;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int y = y0 + ry + i;
      if (y < a.H && x < a.W) {
        a.out[((long long)b * Ho + y) * Wo + x] = 1.f / (1.f + expf(-acc[i][0][0]));
      }
    }
  } else {
    // ha and feat: the block's output tile through shared memory
    // [row][column][channel] (a pixel padded to CB + 4 floats), then out to
    // device memory with neighbouring threads on neighbouring float4s.
    constexpr int OR = UP ? 2 : 1;  // output rows and columns per walked pixel
    const int CB = a.cgb * TO, ps = CB + 4;
    const int orows = OR * R, ocols = OR * kTileW;
    float* s_out = reinterpret_cast<float*>(smem4);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float* sp = s_out + ((OR * (ry + i) + (q >> 1)) * ocols + OR * lane + (q & 1)) * ps + cg * TO;
#pragma unroll
        for (int o4 = 0; o4 < TO / 4; ++o4) {
          float z[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = acc[i][q][4 * o4 + k];
            z[k] = v > 0.f ? v : expm1f(v);
          }
          *reinterpret_cast<float4*>(sp + 4 * o4) = make_float4(z[0], z[1], z[2], z[3]);
        }
      }
    }
    __syncthreads();
    const int oy0 = OR * y0, ox0 = OR * x0;
    const int nrows = Ho - oy0 < orows ? Ho - oy0 : orows;
    const int ncols = Wo - ox0 < ocols ? Wo - ox0 : ocols;
    const int n4 = CB / 4;
    RowSplit sp;
    for (int t = threadIdx.x; row_split(t, ncols * n4, threads, sp); t += threads) {
      const int c4 = sp.k % n4, col = sp.k / n4, co = cb0 + 4 * c4;
      const float* sq = s_out + col * ps + 4 * c4;
      float* oq = a.out + (((long long)b * Ho + oy0) * Wo + ox0 + col) * a.COUT + co;
      for (int r = sp.r0; r < nrows; r += sp.step) {
        const float4 v = ld4(sq + r * ocols * ps);
        float* op = oq + (long long)r * Wo * a.COUT;
        if (a.vec_out && co + 4 <= a.COUT) {
          *reinterpret_cast<float4*>(op) = v;
        } else {
          if (co < a.COUT) op[0] = v.x;
          if (co + 1 < a.COUT) op[1] = v.y;
          if (co + 2 < a.COUT) op[2] = v.z;
          if (co + 3 < a.COUT) op[3] = v.w;
        }
      }
    }
  }
}

// Register budgets, as ptxas gave them on an H100 (chip_smoke.py prints them):
// conv_a and disp are asked for two 256-thread blocks an SM (at most 128
// registers; left to itself ptxas capped them at 80 and 64 and spilled);
// conv_b is not (it takes 126 and fits two blocks all the same; held to 128
// it spilled 24 bytes).
__global__ void __launch_bounds__(kMaxThreads, 2) decoder_stage_fwd_conv_a_kernel(ConvArgs a) {
  conv_block<kConvA>(a);
}

__global__ void __launch_bounds__(kMaxThreads) decoder_stage_fwd_conv_b_kernel(ConvArgs a) {
  conv_block<kConvB>(a);
}

__global__ void __launch_bounds__(kMaxThreads, 2) decoder_stage_fwd_disp_kernel(ConvArgs a) {
  conv_block<kDisp>(a);
}

// The larger of the staged input tile with the chunk's weights, and (conv_a,
// conv_b) the output tile of the epilogue, which reuses the same memory.
template <int CONV>
long long smem_bytes(int rg, int cgb, int cic) {
  using C = Conv<CONV>;
  const long long stage = 4LL * cic * ((rg * C::P + 2) * kTileCols + C::NT * cgb * C::TO);
  const int up = CONV == kConvB ? 2 : 1;
  const long long out = C::TO == 1 ? 0 : 4LL * up * rg * C::P * up * kTileW * (cgb * C::TO + 4);
  return stage > out ? stage : out;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

template <int CONV>
cudaError_t launch_conv(void (*kernel)(ConvArgs), ConvArgs a, int B, int rg, int cgb, int cic,
                        cudaStream_t s) {
  using C = Conv<CONV>;
  if (rg < 1 || cgb < 1 || 32 * rg * cgb > kMaxThreads || cic < 4 || cic % 4 != 0 ||
      (C::TO == 1 && cgb != 1)) {
    return cudaErrorInvalidValue;
  }
  a.rg = rg;
  a.cgb = cgb;
  a.cic = cic;
  a.row_tiles = (int)cdiv(a.H, rg * C::P);
  a.col_tiles = (int)cdiv(a.W, kTileW);
  a.chan_tiles = (int)cdiv(a.COUT, cgb * C::TO);
  a.vec_in = a.CIN % 4 == 0 && aligned16(a.in);
  a.vec_out = a.COUT % 4 == 0 && aligned16(a.out);
  const long long grid = (long long)B * a.row_tiles * a.col_tiles * a.chan_tiles;
  if (grid <= 0) return cudaSuccess;
  const long long smem = smem_bytes<CONV>(rg, cgb, cic);
  if (smem > 48 * 1024) {  // above 48 KB it has to be asked for, or the launch is refused
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)(32 * rg * cgb));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Shared memory of one block of conv `conv` (0: conv_a, 1: conv_b, 2: disp)
// on a plan of `rg` row warps, `cgb` channel warps and `cic` input channels
// per chunk; ops/decoder_stage.py:smem_bytes mirrors it.
extern "C" long long slowtv_decoder_stage_fwd_smem_bytes(int conv, int rg, int cgb, int cic) {
  return conv == kConvA ? smem_bytes<kConvA>(rg, cgb, cic)
                        : conv == kConvB ? smem_bytes<kConvB>(rg, cgb, cic)
                                         : smem_bytes<kDisp>(rg, cgb, cic);
}

// x (B, H, W, CI); wa (CD, CI, 3, 3), ba (CD); wb (CD, CD, 3, 3), bb (CD);
// wo (1, CD, 3, 3), bo (1); outputs ha (B, H, W, CD), feat (B, 2H, 2W, CD)
// and disp (B, 2H, 2W, 1). All float32, contiguous, on `device`; H, W >= 2.
// The plan (row warps, channel warps, channels per chunk) of conv_a (ra, ga,
// ka), conv_b (rb, gb, kb) and disp (ro, go, ko): see fwd_plan. Three launches
// on `stream`; returns the first failing cudaError_t, 0 on success.
extern "C" int slowtv_decoder_stage_fwd_f32(
    const float* x, const float* wa, const float* ba, const float* wb, const float* bb,
    const float* wo, const float* bo, float* ha, float* feat, float* disp, int B, int H, int W,
    int CI, int CD, int ra, int ga, int ka, int rb, int gb, int kb, int ro, int go, int ko,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ConvArgs conv_a = {x, wa, ba, ha, H, W, CI, CD};
  err = launch_conv<kConvA>(decoder_stage_fwd_conv_a_kernel, conv_a, B, ra, ga, ka, s);
  if (err != cudaSuccess) return (int)err;
  ConvArgs conv_b = {ha, wb, bb, feat, H, W, CD, CD};
  err = launch_conv<kConvB>(decoder_stage_fwd_conv_b_kernel, conv_b, B, rb, gb, kb, s);
  if (err != cudaSuccess) return (int)err;
  ConvArgs conv_o = {feat, wo, bo, disp, 2 * H, 2 * W, CD, 1};
  return (int)launch_conv<kDisp>(decoder_stage_fwd_disp_kernel, conv_o, B, ro, go, ko, s);
}
