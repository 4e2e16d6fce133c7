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
// Forward, bound on Hopper: memory. One read of x and one write of the output
// (8 bytes per output value) against K*K multiply-adds: 12 flop/byte at K=7,
// under the card's 20 float32 flop/byte, so the FMA pipe is close behind.
//
// Forward, design:
// - A thread owns one group of V channels (V = 4 as a float4 when C % 4 == 0
//   and x and out are 16-byte aligned; else V = 1, for ragged C and views that
//   start off alignment), a strip of S outputs along W and a band of `rows`
//   output rows, which it walks down. Each input row of the band and its K-1
//   halo rows is loaded ONCE, as S + K - 1 vectors, and feeds the up to K
//   output rows that read it: the thread keeps K rows of S output vectors in
//   registers as a ring (slot = output row mod K, made static by unrolling the
//   walk by K), writes a row when its last input row has been added and
//   reuses the slot. Loads per output vector: (S + K - 1) / S along W times
//   (rows + K - 1) / rows along H, against K * K for a direct gather.
// - A block (64 threads) covers 32 channels and 64 / (32 / V) work items;
//   its taps sit in shared memory as [K*K][32] (+ the bias), read as one
//   float4 per tap and group (conflict-free, at a constant offset per tap).
//   Staging them by coalesced loads into a layout whose stores do not
//   conflict was slower on an H100 (tools/dwconv_bench.py). A warp reads 8
//   (V = 4) or 32 (V = 1) neighbouring channel groups of a pixel: 128-byte
//   requests.
// - `rows` is picked on the host: the tallest band that still leaves
//   kTargetBlocks blocks (8 per SM of an H100's 132), so that the smallest
//   main-path shapes (B=1 at 24x40x512 and 12x20x1024) fill the card with
//   one-row bands (a direct walk, no ring), and the large ones (96x160) get
//   bands of several rows; bands of 2 or 3 rows fall back to one row.
// - Zero padding is a bounds test on each load. Index arithmetic inside an
//   image is 32-bit (the host refuses H*W*C >= 2^31); the image offset is 64.
// - The sum order is the plain one, the same as before this design: bias,
//   then taps row by row, column by column, one FMA chain per output.
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

constexpr int kLanes = 32;      // channels per block (the taps' shared tile)
constexpr int kFwdThreads = 64;
// Blocks the band height is picked to leave: 8 per SM of an H100 (132 SMs).
// (tools/dwconv_bench.py builds other values to time them; the library never
// defines the macro.)
#ifndef SLOWTV_DWCONV_TARGET_BLOCKS
#define SLOWTV_DWCONV_TARGET_BLOCKS 1056
#endif
constexpr int kTargetBlocks = SLOWTV_DWCONV_TARGET_BLOCKS;
constexpr int kStrip = 4;       // outputs per thread along W (the tap gradient's too)

// Outputs per thread along W in the forward: 4, or 2 at K = 9 to keep the
// ring of K x S vectors in registers.
template <int K>
__host__ __device__ constexpr int fwd_strip() { return K <= 7 ? 4 : 2; }

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// One input row's contribution to one output row: taps of row `dy`, S
// outputs from the S + K - 1 loaded columns.
template <int K, int S, int V>
__device__ __forceinline__ void add_row(float (&acc)[S][V], const float (&v)[S + K - 1][V],
                                        const float* s_w, int dy, int g) {
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
    float t[V];
    const float* tap = s_w + (dy * K + dx) * kLanes + g * V;
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(tap);
      t[0] = q.x;
      t[1] = q.y;
      t[2] = q.z;
      t[3] = q.w;
    } else {
      t[0] = tap[0];
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = fmaf(v[r + dx][e], t[e], acc[r][e]);
    }
  }
}

// Loads input row `row` (already offset to the thread's channels) at columns
// x0 - P .. x0 + S + K - 2, zeros outside [0, W).
template <int K, int S, int V>
__device__ __forceinline__ void load_row(float (&v)[S + K - 1][V], const float* row, int x0,
                                         int W, int C) {
  constexpr int P = K / 2;
#pragma unroll
  for (int j = 0; j < S + K - 1; ++j) {
    const int ix = x0 + j - P;
    if (ix >= 0 && ix < W) {
      load_vec<V>(row + ix * C, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = 0.f;
    }
  }
}

// x, out (B, H, W, C); one block per (chunk of 32 channels, run of work
// items); a work item is (b, band, strip); RING walks bands of `rows` > 1.
template <int K, int V, bool RING>
__global__ void __launch_bounds__(kFwdThreads)
dwconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                  int C, int rows, int bands, int strips, int items, int chunks) {
  constexpr int P = K / 2;
  constexpr int S = fwd_strip<K>();
  constexpr int G = kLanes / V;            // threads per pixel
  constexpr int kItems = kFwdThreads / G;  // work items per block
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* s_w = reinterpret_cast<float*>(smem4);  // [K * K][kLanes]
  float* s_b = s_w + K * K * kLanes;             // [kLanes]
  const int chunk = blockIdx.x % chunks;
  const int c0 = chunk * kLanes;
  const int tid = threadIdx.x;
  for (int i = tid; i < K * K * kLanes; i += kFwdThreads) {
    const int t = i / kLanes, cl = i - t * kLanes;
    s_w[i] = (c0 + cl < C) ? __ldg(w + (long long)(c0 + cl) * (K * K) + t) : 0.f;
  }
  if (tid < kLanes) s_b[tid] = (bias != nullptr && c0 + tid < C) ? __ldg(bias + c0 + tid) : 0.f;
  __syncthreads();

  const int g = tid % G;
  const int item = (int)(blockIdx.x / chunks) * kItems + tid / G;
  const int c = c0 + g * V;  // V = 4 only when C % 4 == 0: the whole group is in range
  if (item >= items || c >= C) return;
  const int x0 = (item % strips) * S;
  const int rest = item / strips;
  const int y0 = (rest % bands) * rows;
  const int b = rest / bands;
  const int nrows = rows < H - y0 ? rows : H - y0;
  const long long img = (long long)b * H * W * C;
  const float* xi = x + img + c;
  float* oi = out + img + c;
  float bv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) bv[e] = s_b[g * V + e];

  auto store_row = [&](const float (&acc)[S][V], int y) {
    float* o = oi + (y * W + x0) * C;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (x0 + r < W) store_vec<V>(o + r * C, acc[r]);
    }
  };

  if constexpr (!RING) {
    // One output row at a time: its K input rows, each loaded once.
    for (int y = y0; y < y0 + nrows; ++y) {
      float acc[S][V];
#pragma unroll
      for (int r = 0; r < S; ++r) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = bv[e];
      }
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int iy = y + dy - P;
        if (iy < 0 || iy >= H) continue;
        float v[S + K - 1][V];
        load_row<K, S, V>(v, xi + iy * W * C, x0, W, C);
        add_row<K, S, V>(acc, v, s_w, dy, g);
      }
      store_row(acc, y);
    }
  } else {
    // The band's input rows y0 - P + t, t = 0 .. nrows + K - 2, each loaded
    // once. Output row o (of the band) reads t = o .. o + K - 1 with tap row
    // t - o and lives in slot o % K; with t = t0 + j, t0 % K == 0, every
    // slot index below is a constant.
    float acc[K][S][V];
#pragma unroll
    for (int q = 0; q < K; ++q) {
#pragma unroll
      for (int r = 0; r < S; ++r) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][r][e] = bv[e];
      }
    }
    const int T = nrows + K - 1;
    for (int t0 = 0; t0 < T; t0 += K) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int t = t0 + j;
        if (t < T) {
          const int iy = y0 - P + t;
          if (iy >= 0 && iy < H) {
            float v[S + K - 1][V];
            load_row<K, S, V>(v, xi + iy * W * C, x0, W, C);
#pragma unroll
            for (int dy = 0; dy < K; ++dy) {
              const int o = t - dy;
              if (o >= 0 && o < nrows) add_row<K, S, V>(acc[(j - dy + K) % K], v, s_w, dy, g);
            }
          }
          // Output row t - K + 1 has all its input rows: write it, and start
          // its slot over for row t + 1.
          float (&done)[S][V] = acc[(j + 1) % K];
          if (t >= K - 1) store_row(done, y0 + t - (K - 1));
#pragma unroll
          for (int r = 0; r < S; ++r) {
#pragma unroll
            for (int e = 0; e < V; ++e) done[r][e] = bv[e];
          }
        }
      }
    }
  }
}

template <class Kern, class... Args>
cudaError_t launch_1d(Kern kernel, unsigned grid, unsigned threads, size_t smem,
                      cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <int K, int V>
cudaError_t launch_fwd(const float* x, const float* w, const float* bias, float* out, int B,
                       int H, int W, int C, cudaStream_t s) {
  constexpr int kItems = kFwdThreads / (kLanes / V);
  const long long chunks = cdiv(C, kLanes), strips = cdiv(W, fwd_strip<K>());
  auto blocks = [&](long long rows) {
    return chunks * cdiv(B * cdiv(H, rows) * strips, kItems);
  };
  int rows = H;  // the tallest band that leaves kTargetBlocks blocks (or 1)
  while (rows > 1 && blocks(rows) < kTargetBlocks) --rows;
  // Bands of 2 or 3 rows cost more in registers (the ring) than they save in
  // loads: on an H100 they were 10-25% slower than one-row bands
  // (tools/dwconv_bench.py).
  if (rows < 4) rows = 1;
#ifdef SLOWTV_DWCONV_ROWS  // tests/test_torch_dwconv_emu.py only: bands of a given height
  rows = SLOWTV_DWCONV_ROWS < H ? SLOWTV_DWCONV_ROWS : H;
#endif
  const long long bands = cdiv(H, rows), items = B * bands * strips;
  if (items >= (1LL << 31) || blocks(rows) >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (K * K + 1) * kLanes;
  if (rows == 1) {
    return launch_1d(dwconv_fwd_kernel<K, V, false>, (unsigned)blocks(rows), kFwdThreads, smem,
                     s, x, w, bias, out, H, W, C, rows, (int)bands, (int)strips, (int)items,
                     (int)chunks);
  }
  return launch_1d(dwconv_fwd_kernel<K, V, true>, (unsigned)blocks(rows), kFwdThreads, smem, s,
                   x, w, bias, out, H, W, C, rows, (int)bands, (int)strips, (int)items,
                   (int)chunks);
}

template <int K>
cudaError_t launch(const float* x, const float* w, const float* bias, float* out, int B, int H,
                   int W, int C, cudaStream_t s) {
  if ((long long)H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && (reinterpret_cast<unsigned long long>(x) & 15) == 0 &&
                   (reinterpret_cast<unsigned long long>(out) & 15) == 0;
  return vec ? launch_fwd<K, 4>(x, w, bias, out, B, H, W, C, s)
             : launch_fwd<K, 1>(x, w, bias, out, B, H, W, C, s);
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
// The result is the same from run to run. Blocks and grids are 1-D (lane =
// thread % 32, row = thread / 32; block = (group, blk)), launched through
// cudaLaunchKernelEx with dynamic shared memory, like the forward's.

constexpr int kDwRows = 8;  // work-item rows per block (warps per block)
constexpr int kDwThreads = kLanes * kDwRows;
constexpr int kSumThreads = 256;

template <int K>
__global__ void __launch_bounds__(kDwThreads)
dwconv_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ partial, int B, int H, int W, int C,
                         int nblk) {
  constexpr int P = K / 2;
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* s_sum = reinterpret_cast<float*>(smem4);  // [kDwRows][K][kLanes]
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int blk = blockIdx.x % nblk;
  const int c0 = (blockIdx.x / nblk) * kLanes;
  const int c = c0 + lane;
  const int strips = (W + kStrip - 1) / kStrip;
  const long long items = (long long)B * H * strips;

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

  if (c < C) {
    for (long long item = (long long)blk * kDwRows + row; item < items;
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
        const float* xrow = x + (row0 + iy) * W * (long long)C + c;
        float v[kStrip + K - 1];
#pragma unroll
        for (int j = 0; j < kStrip + K - 1; ++j) {
          const int ix = x0 + j - P;
          v[j] = (ix >= 0 && ix < W) ? __ldg(xrow + (long long)ix * C) : 0.f;
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
  const int tid = threadIdx.x;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) s_sum[(row * K + dx) * kLanes + lane] = acc[dy * K + dx];
    __syncthreads();
    for (int i = tid; i < K * kLanes; i += kDwThreads) {
      const int dx = i / kLanes, l = i - dx * kLanes;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kDwRows; ++r) s += s_sum[(r * K + dx) * kLanes + l];
      if (c0 + l < C) {
        partial[((long long)blk * K * K + dy * K + dx) * C + c0 + l] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSumThreads)
dwconv_dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, int nblk,
                     int KK, int C) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;  // t * C + c
  if (i >= (long long)KK * C) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += partial[(long long)b * KK * C + i];
  const int t = (int)(i / C), c = (int)(i - (long long)t * C);
  dw[(long long)c * KK + t] = s;
}

template <int K>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* dw,
                      int B, int H, int W, int C, int nblk, cudaStream_t s) {
  const long long blocks = (long long)nblk * cdiv(C, kLanes);
  cudaError_t err = launch_1d(dwconv_dw_partial_kernel<K>, (unsigned)blocks, kDwThreads,
                              sizeof(float) * kDwRows * K * kLanes, s, x, g, partial, B, H, W,
                              C, nblk);
  if (err != cudaSuccess) return err;
  const long long n = (long long)K * K * C;
  return launch_1d(dwconv_dw_sum_kernel, (unsigned)cdiv(n, kSumThreads), kSumThreads, 0, s,
                   (const float*)partial, dw, nblk, K * K, C);
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
