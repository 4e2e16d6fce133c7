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
// Tap gradient (second half of this file, its own design notes there):
// replaces the TPU kernel pallas_dwconv.py:_dw_kernel (launched by
// _dwconv_dw_jit); entry point dwconv_dw.
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
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds the sources for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = 32;      // channels per block (the taps' shared tile)
constexpr int kFwdThreads = 64;
// Blocks the band height is picked to leave: 8 per SM of an H100 (132 SMs).
// (tools/dwconv_bench.py builds other values to time them; the library never
// defines the macro.)
#ifndef SLOWTV_DWCONV_TARGET_BLOCKS
#define SLOWTV_DWCONV_TARGET_BLOCKS 1056
#endif
constexpr int kTargetBlocks = SLOWTV_DWCONV_TARGET_BLOCKS;

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
// Bound on Hopper: bytes. It reads x and g once each (8 bytes per element
// pair) for K*K multiply-adds: 12 flop/byte at K=7, under the card's 20
// float32 flop/byte, so the FMA pipe is close behind. Inside the SM, shared
// memory and instruction issue bound it before DRAM does: a thread that owned
// one tap row would load an x and a g value for every K multiply-adds, so a
// thread owns all K*K taps of its channel (below).
//
// Design. The TPU kernel carried the sum across its sequential grid in the
// resident output block; Hopper's blocks run in parallel and in no order.
// - Tiles: `rows` output rows by kDwCols columns of one image, for a group of
//   32 channels. A block stages a tile in shared memory, [pixel][32
//   channels]: its g (rows x kDwCols pixels) and the x it reads (rows + K - 1
//   by kDwCols + K - 1 pixels, the halo included), by cp.async copies of 16
//   bytes (4 for ragged C or an unaligned view), zeros outside the image.
//   Each x and g element crosses from global memory once per tile, plus the
//   tile's halo. Two buffers: tile t + 1 is copied in while tile t is summed.
// - kDwWarps warps split a tile's rows. Thread (warp, lane) owns channel c0 +
//   lane and ALL K*K taps (49 float sums at K=7). For output row r it walks
//   the tile along W with a K-wide register window over each of the x rows r
//   .. r + K - 1, so per column K new x values and one g value feed K*K
//   multiply-adds: acc[dy][dx] += x[r + dy][j + dx] * g[r][j]. The walk is
//   unrolled over the tile's kDwCols columns, so every window slot and sum
//   index is a constant (no stack frame). A warp reads 32 consecutive floats:
//   no bank conflicts.
// - A block takes a contiguous run of its channel group's tiles (`splits`
//   blocks per group, picked on the host: ops/dwconv.py:dw_plan), so its
//   float chains hold a few hundred products at most. At the end the
//   block's warps' sums and those of the `cluster` blocks of its thread-block
//   cluster (consecutive splits of one group, read through distributed
//   shared memory) are added in warp and rank order, in double, each block
//   one share, and written: one partial per cluster, [part][C][K*K] (dw's own
//   layout), or dw itself when a group has one cluster. Otherwise a second
//   launch adds the partials in part order, in double. No atomics: two calls
//   give bitwise-equal taps.
// Grids and blocks are 1-D, launched through cudaLaunchKernelEx with dynamic
// shared memory only, like the forward's.

constexpr int kDwCols = 20;       // tile width: divides every W of the main path (160 .. 20)
constexpr int kDwMaxCluster = 8;  // the portable cluster size
// Warps of a tap-gradient block (they split a tile's rows). A thread takes
// 127 registers and a block at 12 rows 181 KB of shared memory: one block per
// SM, as the host's plan assumes.
constexpr int kDwWarps = 8;
constexpr int kDwThreads = kDwWarps * kLanes;
constexpr int kSumThreads = 256;
constexpr int kMaxDevices = 64;  // devices the tap gradient keeps launch state for

// Shared memory of a tap-gradient block: two tile buffers, or its warps' float
// sums at the end, whichever is larger.
size_t dw_smem_bytes(int K, int rows) {
  const size_t tile = sizeof(float) * kLanes *
                      ((size_t)(rows + K - 1) * (kDwCols + K - 1) + (size_t)rows * kDwCols);
  const size_t sums = sizeof(float) * kDwWarps * kLanes * K * K;
  return 2 * tile > sums ? 2 * tile : sums;
}

// Starts copying rows iy0 .. iy0 + nrows - 1, columns ix0 .. ix0 + NC - 1 of
// one image (`img`, already offset to its channel group) into s[nrows][NC][32];
// zeros outside the image and past the group's `cn` channels in range.
// Asynchronous copies (cp.async): no registers hold them, so all of a
// thread's copies are in flight together; the caller commits and waits.
// Thread i copies channels V * (i % Q) .. of pixels i / Q, i / Q + PS, ...
// (row-major over the tile), stepping row and column without dividing.
template <int V, int NC>
__device__ __forceinline__ void stage_rows(float* s, const float* img, int iy0, int nrows,
                                           int ix0, int H, int W, int C, int cn) {
  constexpr int Q = kLanes / V, PS = kDwThreads / Q;  // copies per pixel, pixels per pass
  constexpr size_t kBytes = sizeof(float) * V;
  static_assert(kDwThreads % Q == 0, "a pass covers whole pixels");
  const int q = threadIdx.x % Q, n = nrows * NC;
  const bool chan = q * V < cn;
  int p = threadIdx.x / Q, r = p / NC, col = p - r * NC;
  for (float* d = s + p * kLanes + q * V; p < n; p += PS, d += PS * kLanes) {
    const int iy = iy0 + r, ix = ix0 + col;
    const bool in = chan && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
    // Outside: nothing is read, kBytes of zeros are written.
    __pipeline_memcpy_async(d, in ? img + (iy * W + ix) * C + q * V : img, kBytes,
                            in ? 0 : kBytes);
    r += PS / NC;
    col += PS % NC;
    if (col >= NC) {
      col -= NC;
      ++r;
    }
  }
}

// x, g (B, H, W, C) -> out: this cluster's partial [C][K*K] of part
// split / cluster (dw itself when there is one part). Block = (channel group,
// split); kDwWarps warps.
template <int K, int V>
__global__ void __launch_bounds__(kDwThreads)
dwconv_dw_tile_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ out, int B, int H, int W, int C, int rows,
                      int splits) {
  constexpr int P = K / 2, KK = K * K, XC = kDwCols + K - 1, XR = XC * kLanes;
  SLOWTV_DYNAMIC_SMEM(smem4);
  // Two buffers, each a tile's x rows [rows + K - 1][XC][kLanes] and g rows
  // [rows][kDwCols][kLanes]: tile t + 1 is copied in while tile t is summed.
  const int tile_floats = ((rows + K - 1) * XC + rows * kDwCols) * kLanes;
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int split = blockIdx.x % splits;
  const int c0 = (blockIdx.x / splits) * kLanes;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int bands = (H + rows - 1) / rows, cols = (W + kDwCols - 1) / kDwCols;
  // Tile t: band t % bands of strip t / bands (kDwCols columns of one image).
  const int tiles = B * cols * bands;
  const int t0 = (int)((long long)tiles * split / splits);
  const int t1 = (int)((long long)tiles * (split + 1) / splits);
  auto stage = [&](int t) {
    float* xs = reinterpret_cast<float*>(smem4) + (t - t0) % 2 * tile_floats;
    const int y0 = t % bands * rows, nr = rows < H - y0 ? rows : H - y0;
    const int strip = t / bands, x0 = strip % cols * kDwCols;
    const long long img = (long long)(strip / cols) * H * W * C + c0;
    stage_rows<V, XC>(xs, x + img, y0 - P, nr + K - 1, x0 - P, H, W, C, C - c0);
    stage_rows<V, kDwCols>(xs + (rows + K - 1) * XR, g + img, y0, nr, x0, H, W, C, C - c0);
    __pipeline_commit();
  };

  // Thread (warp, lane) sums every tap of channel c0 + lane over the rows
  // warp, warp + kDwWarps, ... of the block's tiles.
  float acc[K][K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) acc[dy][dx] = 0.f;
  }
  if (t0 < t1) stage(t0);
  for (int t = t0; t < t1; ++t) {
    // Buffer (t - t0 + 1) % 2 was last read for tile t - 1, before the
    // barrier that ended its turn.
    if (t + 1 < t1) {
      stage(t + 1);
    } else {
      __pipeline_commit();  // an empty batch, so that the wait below is the same
    }
    __pipeline_wait_prior(1);  // tile t's copies have landed
    __syncthreads();
    const float* xs = reinterpret_cast<const float*>(smem4) + (t - t0) % 2 * tile_floats;
    const float* gs = xs + (rows + K - 1) * XR;
    const int y0 = t % bands * rows, nr = rows < H - y0 ? rows : H - y0;
    for (int r = warp; r < nr; r += kDwWarps) {
      // Output row r reads x rows r .. r + K - 1 of the tile: a K-wide window
      // of each walks along W.
      const float* xr = xs + r * XR + lane;
      const float* gr = gs + r * kDwCols * kLanes + lane;
      float win[K][K];  // win[dy]: x columns j .. j + K - 1 of row r + dy
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int i = 1; i < K; ++i) win[dy][i] = xr[dy * XR + (i - 1) * kLanes];
      }
#pragma unroll
      for (int j = 0; j < kDwCols; ++j) {
        const float gv = gr[j * kLanes];
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
#pragma unroll
          for (int i = 0; i + 1 < K; ++i) win[dy][i] = win[dy][i + 1];
          win[dy][K - 1] = xr[dy * XR + (j + K - 1) * kLanes];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) acc[dy][dx] = fmaf(win[dy][dx], gv, acc[dy][dx]);
        }
      }
    }
    __syncthreads();  // this buffer is no longer read
  }

  // The block's warps' and the cluster's sums, in warp and rank order, in
  // double: block `rank` adds and writes entries rank * kDwThreads + i of the
  // group's 32 * K * K, stepping S * kDwThreads.
  __pipeline_wait_prior(0);
  float* sums = reinterpret_cast<float*>(smem4);  // [kDwWarps][kLanes][K][K]: dw's layout
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) sums[(warp * kLanes + lane) * KK + dy * K + dx] = acc[dy][dx];
  }
  if (S > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  float* dst = out + ((long long)(split / S) * C + c0) * KK;
  const int n = (C - c0 < kLanes ? C - c0 : kLanes) * KK;
  for (int i = rank * kDwThreads + (int)threadIdx.x; i < n; i += S * kDwThreads) {
    double v = 0.0;
    for (int q = 0; q < S; ++q) {
      const float* theirs = S > 1 ? cluster.map_shared_rank(sums, q) : sums;
#pragma unroll
      for (int w = 0; w < kDwWarps; ++w) v += theirs[w * kLanes * KK + i];
    }
    dst[i] = (float)v;
  }
  if (S > 1) cluster.sync();  // no block leaves while its shared memory is being read
}

// dw[i] = sum of partial[p][i] over p = 0 .. parts - 1 in order, in double.
__global__ void __launch_bounds__(kSumThreads)
dwconv_dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, int parts,
                     long long n) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int p = 0; p < parts; ++p) s += partial[p * n + i];
  dw[i] = (float)s;
}

template <int K, int V>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* dw, int B, int H,
                      int W, int C, int rows, int splits, int cluster, int device,
                      cudaStream_t s) {
  const size_t smem = dw_smem_bytes(K, rows);
  const int parts = splits / cluster;
  cudaError_t err = cudaSuccess;
  // Above 48 KB shared memory is dynamic and has to be asked for, or the
  // launch is refused; asking refuses more than the device allows. The most
  // asked so far is kept per device, so that a launch asks only when its
  // plan needs more (a host call per launch costs more than the smallest
  // launches run).
  static size_t asked[kMaxDevices] = {};
  if (smem > asked[device]) {
    err = cudaFuncSetAttribute(dwconv_dw_tile_kernel<K, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    asked[device] = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cdiv(C, kLanes) * splits));
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dwconv_dw_tile_kernel<K, V>, x, g, parts == 1 ? dw : partial,
                           B, H, W, C, rows, splits);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  const long long n = (long long)C * K * K;
  return launch_1d(dwconv_dw_sum_kernel, (unsigned)cdiv(n, kSumThreads), kSumThreads, 0, s,
                   (const float*)partial, dw, parts, n);
}

template <int K>
cudaError_t launch_dw(const float* x, const float* g, float* partial, float* dw, int B, int H,
                      int W, int C, int rows, int splits, int cluster, int device,
                      cudaStream_t s) {
  if (device < 0 || device >= kMaxDevices || rows < 1 || splits < 1 || cluster < 1 ||
      cluster > kDwMaxCluster || splits % cluster ||
      dw_smem_bytes(K, rows) >= (1ULL << 31) || (long long)H * W * C >= (1LL << 31) ||
      cdiv(C, kLanes) * splits >= (1LL << 31) || (splits > cluster && partial == nullptr) ||
      (long long)B * cdiv(H, rows) * cdiv(W, kDwCols) >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const bool vec = C % 4 == 0 && (reinterpret_cast<unsigned long long>(x) & 15) == 0 &&
                   (reinterpret_cast<unsigned long long>(g) & 15) == 0;
  return vec ? launch_dw<K, 4>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device, s)
             : launch_dw<K, 1>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device, s);
}

}  // namespace

// x, g (B, H, W, C) -> dw (C, 1, K, K); all float32, contiguous, on `device`.
// The plan (ops/dwconv.py:dw_plan): tiles of `rows` output rows, `splits`
// blocks per 32-channel group, clusters of `cluster` blocks; partial is
// (splits / cluster, C, K*K) scratch, unused (may be NULL) when splits ==
// cluster. One launch, or two with partials, on `stream`; returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int slowtv_dwconv_dw_f32(const float* x, const float* g, float* partial,
                                    float* dw, int B, int H, int W, int C, int K,
                                    int rows, int splits, int cluster, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return (int)launch_dw<1>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device,
                                 s);
    case 3:
      return (int)launch_dw<3>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device,
                                 s);
    case 5:
      return (int)launch_dw<5>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device,
                                 s);
    case 7:
      return (int)launch_dw<7>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device,
                                 s);
    case 9:
      return (int)launch_dw<9>(x, g, partial, dw, B, H, W, C, rows, splits, cluster, device,
                                 s);
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
