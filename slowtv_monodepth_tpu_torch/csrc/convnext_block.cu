// Fused ConvNeXt block, forward: one launch computes
//
//     y = x + gamma * fc2(gelu(fc1(LN(dwconv7x7(x) + b_dw))))
//
// Float32, NHWC activations, parameters in PyTorch's layouts: taps (C, 1, 7, 7),
// fc1 (4C, C), fc2 (C, 4C). Only y goes back to device memory; the (pixels, 4C)
// hidden activation lives in shared memory, 256 columns at a time.
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_convnext.py:
// _fwd_kernel (launched by _block_fwd_jit); entry point fused_convnext_block.
// 36 launches per ConvNeXt-B forward.
//
// Bound on Hopper: operations. 16 * pixels * C^2 float32 operations in the two
// matrix products against at most 8 * pixels * C bytes of x and y and 32 * C^2
// bytes of weights: 250 operations per byte and more at the ConvNeXt-B shapes.
// Both products are written here by hand as float32 FMA loops (no tensor
// cores: TF32 or bf16 would change the numerics of the exact-float32 recipe).
// 512 threads with half the register tile measured slower than 256.
//
// Design (what the TPU kernel's sequential (b, row-band) grid and its three
// clamped halo views become):
// - One tile of M consecutive pixels of the flattened (b, y, x) index, M in
//   {8, 16, 32}, per CLUSTER of S thread blocks (S = 1, 2, 4 or 8); each pixel
//   derives its own (b, y, x) and the ragged last tile is masked. With plenty
//   of pixels S = 1 and blocks share nothing. With few (a single image's deep
//   stages) one block per tile would leave most SMs idle, and smaller tiles
//   would make every block stream all the weights through L2 for a few pixels,
//   so the S blocks of a cluster split the tile's work instead: each computes
//   the taps and the LayerNorm of its share of the pixels and the others copy
//   the result out of its shared memory (distributed shared memory); each
//   runs the MLP over ITS share of the hidden chunks (every weight is read
//   once per tile, not once per block); at the end each sums, in block
//   order, the S partial sums of its share of the pixels out of the S shared
//   memories and writes y. Nothing but y reaches device memory and the sum
//   order is fixed. The caller picks M and S.
// - Phase A: the 49 taps + bias of the tile's M x C values into shared
//   memory, threads along C (one coalesced 128-byte read of x per warp;
//   neighbouring tiles' reads meet in L2), zeros outside the image. A thread
//   computes strips of 4 pixels of one image row from one window of 10 loads
//   per tap row (70 loads per 4 outputs, not 196), its channel's taps in
//   registers.
// - Phase B: LayerNorm per pixel, one warp per pixel, two passes over shared
//   memory (mean, then mean squared deviation: not E[x^2] - E[x]^2), in place.
// - Phase C: for each chunk of 256 hidden columns:
//       h   = gelu(xln @ fc1[chunk, :]^T + b1[chunk])     (M, 256), shared
//       acc += h @ fc2[:, chunk]^T                        (M, C),   shared
//   Both are the same routine, `gemm_panel`: a (M, K) operand in shared memory
//   times 256 rows of a K-contiguous weight matrix in device memory. PyTorch's
//   (out, in) layouts are K-contiguous for both products, so nothing is
//   transposed: every output is a dot product of two rows. 256 threads as
//   4 rows x 64 columns, each with an (M/4) x 4 register tile; weights stream
//   through a [256][32] shared tile (rows padded to 36 floats: conflict-free
//   128-bit reads), the next tile prefetched into registers during the
//   current one's FMAs; both operands are read as float4 along K, and a warp
//   (8 columns x 4 rows) shares its reads: 12 shared-memory wavefronts per
//   128 FMAs of a warp.
// - Epilogue: y = x + gamma * (b2 + the cluster's partial sums). Not in place:
//   a tile's taps read neighbouring tiles' x.
// Later work: 8 x 8 register tiles with fc2's sums kept in registers (the FMA
// loops run at about half the float32 peak), weight tiles multicast to a
// cluster by TMA, wgmma from the same shared tiles where TF32 is allowed.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory. (tests/cuda_emu builds this file for the
// CPU with its own definition.)
#ifndef SLOWTV_DYNAMIC_SMEM
#define SLOWTV_DYNAMIC_SMEM(name) extern __shared__ float4 name[]
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTN = 64;          // thread columns
constexpr int kTM = 4;           // thread rows (kTM * kTN threads)
constexpr int kRN = 4;           // output columns per thread (n = tn + 64 * i)
constexpr int kNP = kTN * kRN;   // panel width = hidden chunk = 256
constexpr int kKT = 32;          // K per weight tile
constexpr int kWS = kKT + 4;     // padded row stride of the weight tile
constexpr int kHS = kNP + 4;     // padded row stride of the hidden chunk
constexpr int kK = 7;            // depthwise taps per axis
constexpr int kFetch = 8;        // float4 per thread and weight tile (256 * 8 / 256)
constexpr int kStrip = 4;        // pixels per strip in phase A
constexpr float kEps = 1e-6f;    // the LayerNorm's epsilon (as the TPU kernel's)

// Timing aids, never defined in the library's build: each leaves one part of the
// kernel out (the result is then wrong), so that the package's
// tools/block_kernel_bench.py can say where the time goes.
#ifdef K9_NO_TAPS
constexpr bool kTaps = false;    // skip the 49 taps
#else
constexpr bool kTaps = true;
#endif
#ifdef K9_NO_FMA
constexpr bool kFma = false;     // skip the matrix products' FMAs
#else
constexpr bool kFma = true;
#endif
#ifdef K9_NO_STREAM
constexpr bool kStream = false;  // skip the weight tiles' loads, stores and barriers
#else
constexpr bool kStream = true;
#endif

__device__ __forceinline__ float gelu(float h, bool approximate) {
  if (approximate) {
    const float inner = 0.7978845608028654f * (h + 0.044715f * h * h * h);
    return 0.5f * h * (1.f + tanhf(inner));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865475f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread t's place in the 4 x 64 grid of register tiles: a warp covers 8
// columns x 4 rows. The thread owns rows tm + 4 * r and columns tn + 64 * i.
__device__ __forceinline__ int thread_col(int t) { return (t >> 5) * 8 + (t & 7); }
__device__ __forceinline__ int thread_row(int t) { return (t & 31) >> 3; }

// This thread's kFetch float4 of the [256][32] weight tile at k = kt: row
// ln + 32 * i, columns lk .. lk + 3. Rows >= N and columns >= K read as zero.
__device__ __forceinline__ void fetch_tile(float4 (&pre)[kFetch], const float* __restrict__ Wg,
                                           long long ldw, int N, int K, int kt, int ln,
                                           int lk) {
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    const int n = ln + 32 * i;
    pre[i] = (n < N && kt + lk < K)
                 ? __ldg(reinterpret_cast<const float4*>(Wg + n * ldw + kt + lk))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One step of 4 along K for this thread's RM x 4 register tile. FULL: all four
// of its columns are live (no test).
template <int RM, bool FULL>
__device__ __forceinline__ void mma_step(const float* Ar, int lda, const float* Wr, int k4,
                                         int ni, float (&acc)[RM][kRN]) {
  float4 w[kRN];
#pragma unroll
  for (int i = 0; i < kRN; ++i) {
    w[i] = *reinterpret_cast<const float4*>(&Wr[kTN * i * kWS + 4 * k4]);
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(&Ar[kTM * r * lda + 4 * k4]);
#pragma unroll
    for (int i = 0; i < kRN; ++i) {
      if (FULL || i < ni) {
        acc[r][i] = fmaf(a.x, w[i].x, acc[r][i]);
        acc[r][i] = fmaf(a.y, w[i].y, acc[r][i]);
        acc[r][i] = fmaf(a.z, w[i].z, acc[r][i]);
        acc[r][i] = fmaf(a.w, w[i].w, acc[r][i]);
      }
    }
  }
}

// One weight tile's worth of FMAs: nk4 steps; a whole tile (all but K's last
// one, when K is no multiple of 32) is straight-line code.
template <int RM, bool FULL>
__device__ __forceinline__ void mma_tile(const float* Ar, int lda, const float* Wr, int nk4,
                                         int ni, float (&acc)[RM][kRN]) {
  if (!kFma) return;
  if (nk4 == kKT / 4) {
#pragma unroll
    for (int k4 = 0; k4 < kKT / 4; ++k4) mma_step<RM, FULL>(Ar, lda, Wr, k4, ni, acc);
  } else {
    for (int k4 = 0; k4 < nk4; ++k4) mma_step<RM, FULL>(Ar, lda, Wr, k4, ni, acc);
  }
}

// acc[r][i] = sum_k A[tm + 4 * r][k] * Wg[(tn + 64 * i) * ldw + k], k < K, for
// the N <= 256 rows of Wg. A is in shared memory (row stride lda, 16-byte
// aligned rows), Wg in device memory (16-byte aligned rows, K % 4 == 0). Ws is
// the [256][kWS] staging tile. Every thread of the block must call it.
//
// A warp is 8 thread columns x 4 thread rows: a 128-bit read of the weight
// tile touches 8 rows (one 128-byte wavefront, the 4 thread rows share it) and
// one of A touches 4 rows (lda = 4 mod 32 keeps them on different banks).
template <int RM>
__device__ __forceinline__ void gemm_panel(const float* A, int lda,
                                           const float* __restrict__ Wg, long long ldw,
                                           int N, int K, float* Ws,
                                           float (&acc)[RM][kRN]) {
  const int t = threadIdx.x, tn = thread_col(t), tm = thread_row(t);
  const int ln = t >> 3, lk = (t & 7) * 4;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int i = 0; i < kRN; ++i) acc[r][i] = 0.f;
  }
  int ni = (N - tn + kTN - 1) / kTN;  // this thread's live columns
  ni = ni < 0 ? 0 : (ni > kRN ? kRN : ni);

  float4 pre[kFetch];
  if (kStream) fetch_tile(pre, Wg, ldw, N, K, 0, ln, lk);
  for (int kt = 0; kt < K; kt += kKT) {
    if (kStream || kt == 0) __syncthreads();  // the last tile's reads and A's writers are done
    if (kStream) {
#pragma unroll
      for (int i = 0; i < kFetch; ++i) {
        *reinterpret_cast<float4*>(&Ws[(ln + 32 * i) * kWS + lk]) = pre[i];
      }
      if (kt + kKT < K) fetch_tile(pre, Wg, ldw, N, K, kt + kKT, ln, lk);
      __syncthreads();
    }
    const int nk4 = (K - kt < kKT ? K - kt : kKT) / 4;
    const float* Ar = A + tm * lda + kt;
    const float* Wr = Ws + tn * kWS;
    if (ni == kRN) {
      mma_tile<RM, true>(Ar, lda, Wr, nk4, ni, acc);
    } else {
      mma_tile<RM, false>(Ar, lda, Wr, nk4, ni, acc);
    }
  }
}

// u[j] = bias + the 49 taps at pixel (py, px + j) of the image whose first row is
// row0 (= b * H), channel c, j < L; zeros outside the image. One row window of
// L + 6 loads feeds the 7 taps of all L outputs.
template <int L>
__device__ __forceinline__ void taps_strip(const float* __restrict__ x,
                                           const float (&wr)[kK * kK], float bias,
                                           long long row0, int py, int px, int H, int W,
                                           int C, int c, float (&u)[L]) {
  constexpr int P = kK / 2;
#pragma unroll
  for (int j = 0; j < L; ++j) u[j] = bias;
#pragma unroll
  for (int dy = 0; dy < kK; ++dy) {
    const int iy = py + dy - P;
    if (iy < 0 || iy >= H) continue;
    const float* row = x + (row0 + iy) * W * (long long)C + c;
    float v[L + kK - 1];
#pragma unroll
    for (int j = 0; j < L + kK - 1; ++j) {
      const int ix = px + j - P;
      v[j] = (ix >= 0 && ix < W) ? __ldg(row + (long long)ix * C) : 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < kK; ++dx) {
#pragma unroll
      for (int j = 0; j < L; ++j) u[j] = fmaf(v[j + dx], wr[dy * kK + dx], u[j]);
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(kThreads, 1)
convnext_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dww,
                          const float* __restrict__ dwb, const float* __restrict__ lnw,
                          const float* __restrict__ lnb, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, const float* __restrict__ gamma,
                          float* __restrict__ out, int B, int H, int W, int C,
                          int approximate) {
  constexpr int M = kTM * RM;
  SLOWTV_DYNAMIC_SMEM(smem4);
  const int ldx = C + 4;                         // padded: see gemm_panel
  float* xln = reinterpret_cast<float*>(smem4);  // [M][ldx]: taps, then LN in place
  float* accs = xln + M * ldx;                   // [M][C]: fc2's running sum
  float* hs = accs + M * C;                      // [M][kHS]: one hidden chunk
  float* Ws = hs + M * kHS;                      // [256][kWS]: weight tile
  const int t = threadIdx.x;
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long pixels = (long long)B * H * W;
  const long long p0 = (long long)(blockIdx.x / S) * M;
  // Strip k (pixels 4k .. 4k + 3 of the tile) belongs to block k % S of the
  // cluster: its taps, its LayerNorm and, at the end, its output.
  constexpr int kStrips = M / kStrip;
  const int owned = rank < kStrips ? (kStrips - rank + S - 1) / S : 0;

  // Phase A: depthwise 7x7 + bias. A thread keeps one channel's 49 taps in
  // registers and walks this block's strips; with fewer than 256 channels the
  // strips are dealt to 256 / C thread groups.
  const int groups = C >= kThreads ? 1 : kThreads / C;
  const int g = groups == 1 ? 0 : t / C;
  for (int c = groups == 1 ? t : t % C; c < C && g < groups; c += kThreads) {
    float wr[kK * kK];
#pragma unroll
    for (int i = 0; i < kK * kK; ++i) wr[i] = __ldg(dww + (long long)c * (kK * kK) + i);
    const float bias = __ldg(dwb + c);
    for (int k = rank + S * g; kTaps && k < kStrips; k += S * groups) {
      const int m = k * kStrip;
      const long long p = p0 + m;
      const int px = (int)(p % W);
      if (p + kStrip <= pixels && px + kStrip <= W) {  // one image row: share the loads
        const long long by = p / W;  // b * H + y
        const int py = (int)(by % H);
        float u[kStrip];
        taps_strip<kStrip>(x, wr, bias, by - py, py, px, H, W, C, c, u);
#pragma unroll
        for (int j = 0; j < kStrip; ++j) xln[(m + j) * ldx + c] = u[j];
      } else {  // the strip wraps a row or runs off the last pixel
        for (int j = 0; j < kStrip; ++j) {
          float u[1] = {0.f};
          if (p + j < pixels) {
            const long long by = (p + j) / W;
            const int py = (int)(by % H);
            taps_strip<1>(x, wr, bias, by - py, py, (int)((p + j) % W), H, W, C, c, u);
          }
          xln[(m + j) * ldx + c] = u[0];
        }
      }
    }
  }
  __syncthreads();

  // Phase B: LayerNorm over C of this block's pixels, one warp per pixel, two passes.
  const int lane = t & 31, warp = t >> 5;
  for (int q = warp; q < owned * kStrip; q += kThreads / 32) {
    float* u = xln + ((rank + S * (q / kStrip)) * kStrip + q % kStrip) * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += u[c];
    const float mean = warp_sum(s) / (float)C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = u[c] - mean;
      v = fmaf(d, d, v);
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / (float)C + kEps);
    for (int c = lane; c < C; c += 32) {
      u[c] = (u[c] - mean) * rstd * __ldg(lnw + c) + __ldg(lnb + c);
    }
  }
  for (int idx = t; idx < M * C; idx += kThreads) accs[idx] = 0.f;
  if (S > 1) {
    // The other blocks' pixels: copy their rows out of the owners' shared memory.
    cluster.sync();
    const int c4 = C / 4;
    for (int idx = t; idx < M * c4; idx += kThreads) {
      const int m = idx / c4, owner = (m / kStrip) % S;
      if (owner != rank) {
        const int off = m * ldx + (idx - m * c4) * 4;
        *reinterpret_cast<float4*>(xln + off) =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(xln, owner) + off);
      }
    }
  }
  // (gemm_panel's first barrier orders these writes before any read.)

  // Phase C: the MLP over this block's hidden chunks, 256 columns at a time.
  const int hidden = 4 * C;
  const int tn = thread_col(t), tm = thread_row(t);
  float acc[RM][kRN];
  for (int j0 = rank * kNP; j0 < hidden; j0 += S * kNP) {
    const int nh = hidden - j0 < kNP ? hidden - j0 : kNP;
    gemm_panel<RM>(xln, ldx, w1 + (long long)j0 * C, C, nh, C, Ws, acc);
#pragma unroll
    for (int i = 0; i < kRN; ++i) {
      const int n = tn + kTN * i;
      if (n < nh) {
        const float bias = __ldg(b1 + j0 + n);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          hs[(tm + kTM * r) * kHS + n] = gelu(acc[r][i] + bias, approximate);
        }
      }
    }
    for (int c0 = 0; c0 < C; c0 += kNP) {
      const int nc = C - c0 < kNP ? C - c0 : kNP;
      gemm_panel<RM>(hs, kHS, w2 + (long long)c0 * hidden + j0, hidden, nc, nh, Ws, acc);
#pragma unroll
      for (int i = 0; i < kRN; ++i) {
        const int n = tn + kTN * i;
        if (n < nc) {
#pragma unroll
          for (int r = 0; r < RM; ++r) accs[(tm + kTM * r) * C + c0 + n] += acc[r][i];
        }
      }
    }
  }
  __syncthreads();
  if (S > 1) cluster.sync();  // every block's partial sums are complete

  // Epilogue for this block's pixels: the S partial sums in block order, fc2's
  // bias, layer scale and residual.
  for (int idx = t; idx < owned * kStrip * C; idx += kThreads) {
    const int q = idx / C, c = idx - q * C;
    const int m = (rank + S * (q / kStrip)) * kStrip + q % kStrip;
    const long long p = p0 + m;
    if (p >= pixels) continue;
    float sum = __ldg(b2 + c);
    if (S == 1) {
      sum += accs[m * C + c];
    } else {
      for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(accs, r)[m * C + c];
    }
    out[p * C + c] = __ldg(x + p * C + c) + __ldg(gamma + c) * sum;
  }
  if (S > 1) cluster.sync();  // no block leaves while its shared memory is being read
}

template <int RM>
cudaError_t launch(const float* x, const float* dww, const float* dwb, const float* lnw,
                   const float* lnb, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* gamma, float* out, int B, int H, int W,
                   int C, int S, int approximate, cudaStream_t s) {
  constexpr int M = kTM * RM;
  const size_t bytes = sizeof(float) * ((size_t)M * (2 * C + 4) + M * kHS + kNP * kWS);
  // Above 48 KB shared memory is dynamic and has to be asked for, or the
  // launch is refused.
  cudaError_t err = cudaFuncSetAttribute(convnext_block_fwd_kernel<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const long long pixels = (long long)B * H * W;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((pixels + M - 1) / M) * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, convnext_block_fwd_kernel<RM>, x, dww, dwb, lnw, lnb, w1, b1,
                           w2, b2, gamma, out, B, H, W, C, approximate);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x, out (B, H, W, C); dww (C, 1, 7, 7); dwb, lnw, lnb, b2, gamma (C,); w1
// (4C, C); b1 (4C,); w2 (C, 4C); all float32, contiguous, on `device`; C a
// multiple of 4 and w1, w2 16-byte aligned. M (8, 16 or 32) is the pixel tile
// and S (1, 2, 4 or 8, at most the number of 256-column hidden chunks) the
// number of thread blocks of the cluster that shares it:
// 4 * (M * (2 * C + 4) + 260 * M + 256 * 36) bytes of shared memory must fit the
// block's 227 KB. Launches on `stream` and returns the launch's cudaError_t
// (0 on success).
extern "C" int slowtv_convnext_block_fwd_f32(
    const float* x, const float* dww, const float* dwb, const float* lnw, const float* lnb,
    const float* w1, const float* b1, const float* w2, const float* b2, const float* gamma,
    float* out, int B, int H, int W, int C, int M, int S, int approximate, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 4 != 0 || (S != 1 && S != 2 && S != 4 && S != 8) || (S - 1) * kNP >= 4 * C) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 8:
      return (int)launch<2>(x, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, B, H, W, C,
                            S, approximate, s);
    case 16:
      return (int)launch<4>(x, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, B, H, W, C,
                            S, approximate, s);
    case 32:
      return (int)launch<8>(x, dww, dwb, lnw, lnb, w1, b1, w2, b2, gamma, out, B, H, W, C,
                            S, approximate, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
