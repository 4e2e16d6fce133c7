// Fused ConvNeXt block, forward:
//
//     y = x + gamma * fc2(gelu(fc1(LN(dwconv7x7(x) + b_dw))))
//
// Float32, NHWC activations, parameters in PyTorch's layouts: taps (C, 1, 7, 7),
// fc1 (4C, C), fc2 (C, 4C).
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_convnext.py:
// _fwd_kernel (launched by _block_fwd_jit); entry point fused_convnext_block.
// 36 calls per ConvNeXt-B forward, 54 per KBR micro-step with the fused
// blocks on both nets.
//
// Bound on Hopper: operations. 16 * pixels * C^2 float32 operations in the two
// matrix products against 8 * pixels * C bytes of x and y and 32 * C^2 bytes
// of weights: 250 operations per byte and more at the ConvNeXt-B shapes. The
// products are float32 FMA on the CUDA cores (no tensor cores: TF32 or bf16
// would change the numerics of the exact-float32 recipe).
//
// Design: one C entry, three CUDA launches around the product core `gemm_run`
// of convnext_common.cuh (a 128 x 128 tile a block of 256 threads, 8 x 8 a
// thread, K-major [32][128] slabs by cp.async in a ring), which kernel 10
// shares. The core reads K-major operands only, so:
// 1. prep (per tile of M pixels): the 49 taps + bias and the LayerNorm into
//    shared memory, written out transposed as xln^T (C, pixels rounded up to
//    4); extra blocks of the same launch write fc1^T (C, 4C) and fc2^T
//    (4C, C).
// 2. fc1 (tile: 128 pixels x 128 hidden units, hidden tiles fastest, K = C):
//    h = xln fc1^T; the epilogue adds b1, applies the GELU and stores
//    hg^T (4C, pixels rounded up to 4).
// 3. fc2 (tile: 128 pixels x 128 channels, channel tiles fastest, K = 4C):
//    the epilogue writes y = x + gamma * (hg fc2^T + b2).
// A block sums its K in float32 chains of at most kMaxGroup (256), the chains
// added in order in registers, and passes the tile to its epilogue through
// shared memory (`product`). Where the tiles are too few for the card, the S
// blocks of a cluster (S = 2 to 8) split each tile's K; each leaves its
// partial tile in shared memory and sums its 1/S of the tile's values out of
// the S shared memories (distributed shared memory) in rank order before its
// share of the epilogue. No atomics: every sum runs in a fixed order, so two
// calls give the same bits. The plan (M, the two splits) is made by the
// caller (ops/convnext_block.py fwd_plan) for the card: its SMs, and how many
// blocks it runs at once in clusters of each size (cluster_blocks).
// Scratch (from the caller's allocator): xln^T, hg^T, fc1^T, fc2^T
// (scratch_floats).
#include "convnext_common.cuh"

namespace {

constexpr int kFc1Stages = 2;  // slabs in the ring of the fc1 launch (K = C)
constexpr int kFc2Stages = 3;  // of the fc2 launch (K = 4C)
constexpr int kLp = kBM + 4;   // padded row of the partial tile, [kBN][kLp]: part[n * kLp + m]
static_assert(ring_floats(2) >= kBN * kLp, "the partial tile fits the ring");

__device__ __forceinline__ float gelu(float h, bool approximate) {
  if (approximate) {
    const float inner = 0.7978845608028654f * (h + 0.044715f * h * h * h);
    return 0.5f * h * (1.f + tanhf(inner));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865475f));
}

// Launch 1. Blocks [0, tiles): one per tile of M pixels, shared memory u
// [M][C + 4]; then one per 32 x 32 tile of fc1 -> fc1^T, then of fc2 -> fc2^T.
__global__ void __launch_bounds__(kThreads)
convnext_block_fwd_prep_kernel(const float* __restrict__ x, const float* __restrict__ dww,
                               const float* __restrict__ dwb, const float* __restrict__ lnw,
                               const float* __restrict__ lnb, const float* __restrict__ w1,
                               const float* __restrict__ w2, float* __restrict__ xlnT,
                               float* __restrict__ w1T, float* __restrict__ w2T, int B, int H,
                               int W, int C, int M, int tiles) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  float* u = reinterpret_cast<float*>(smem4);
  const int ldu = C + 4, t = threadIdx.x, hidden = 4 * C;
  const long long pixels = (long long)B * H * W, ldp = (pixels + 3) / 4 * 4;
  if ((int)blockIdx.x >= tiles) {
    const int b = blockIdx.x - tiles, per = (hidden + 31) / 32 * ((C + 31) / 32);
    if (b < per) {
      transpose_tile(w1, w1T, hidden, C, b, u);  // fc1 (4C, C) -> (C, 4C)
    } else {
      transpose_tile(w2, w2T, C, hidden, b - per, u);  // fc2 (C, 4C) -> (4C, C)
    }
    return;
  }
  const long long p0 = (long long)blockIdx.x * M;
  const int live = pixels - p0 < M ? (int)(pixels - p0) : M;
  taps_tile(x, dww, dwb, u, ldu, p0, pixels, M, H, W, C);
  __syncthreads();
  layer_norm_rows(  // xln back into u
      u, ldu, live, C, lnw, lnb,
      [&](int q, int c, float, float val) { u[q * ldu + c] = val; }, [](int, float) {});
  __syncthreads();
  // xln^T (C, ldp): threads along the pixels.
  for (int e = t; e < C * M; e += kThreads) {
    const int c = e / M, m = e - c * M;
    if (m < live) xlnT[c * ldp + p0 + m] = u[m * ldu + c];
  }
}

// The tile's four values at part[off .. off + 3]: the S blocks' partials
// added in rank order.
__device__ __forceinline__ float4 cluster_sum(float* part, int S, int off) {
  const cg::cluster_group cluster = cg::this_cluster();
  float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + off);
  for (int s = 1; s < S; ++s) {
    const float4 q = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s) + off);
    v.x += q.x;
    v.y += q.y;
    v.z += q.z;
    v.w += q.w;
  }
  return v;
}

// A product launch: out(p, n) = sum_k A(k, p) B(k, n) over K, one 128 x 128
// tile (pixel tiles slowest) a cluster of S blocks; A the activations,
// K-major (K, ldp: the pixels rounded up to 4), B the weights, K-major (K, N).
// Rank r of the cluster takes rows [r * len, (r + 1) * len) of K, len =
// split_len(K, S) (none when that starts at or past K), in float32 chains of
// kMaxGroup added in order; each block leaves its partial tile in shared
// memory ([kBN][kLp], transposed: part[n * kLp + m]) and then sums its 1/S of
// the tile's quads (pixels p .. p + 3 of column n, p < pixels) out of the
// cluster's shared memories in rank order into epi(n, p, the four sums).
// PIXELS_FASTEST: its threads walk the quads along the pixels, else along the
// columns (coalesced stores in either layout).
template <int STAGES, bool PIXELS_FASTEST, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ A, long long pixels,
                                        const float* __restrict__ B, int N, int K, int S,
                                        float* smem, Epi&& epi) {
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tile = blockIdx.x / S, rank = blockIdx.x % S;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int m_end = (int)(pixels < m0 + kBM ? pixels : m0 + kBM);
  const int len = (int)split_len(K, S);
  const int k0 = rank * len < K ? rank * len : K, k1 = k0 + len < K ? k0 + len : K;
  const Operand a{A, (pixels + 3) / 4 * 4, m0, m_end}, b{B, N, n0, N};
  float acc[kTile][kTile], sum[kTile][kTile];
  zero(sum);
  gemm_run<STAGES>(
      (k1 - k0 + kBK - 1) / kBK, kMaxGroup / kBK, smem, acc,
      [&](int i, float* As, float* Bs) { stage_pair(As, Bs, a, b, k0 + i * kBK, k1); },
      [&](int) {
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
#pragma unroll
          for (int j = 0; j < kTile; ++j) sum[i][j] += acc[i][j];
        }
        zero(acc);
      });
  __syncthreads();  // the ring's last readers are done: the partial takes its place
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(smem + tile_col(j) * kLp + tile_row(4 * h)) = make_float4(
          sum[4 * h][j], sum[4 * h + 1][j], sum[4 * h + 2][j], sum[4 * h + 3][j]);
    }
  }
  const cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  constexpr int kQuads = kBN * kBM / 4;
  const int share = (kQuads + S - 1) / S;
  const int end = (rank + 1) * share < kQuads ? (rank + 1) * share : kQuads;
  for (int q = rank * share + threadIdx.x; q < end; q += kThreads) {
    const int n = PIXELS_FASTEST ? q / (kBM / 4) : q % kBN;
    const int m = (PIXELS_FASTEST ? q % (kBM / 4) : q / kBN) * 4;
    if (n0 + n >= N || m0 + m >= m_end) continue;
    epi(n0 + n, m0 + m,
        S == 1 ? *reinterpret_cast<const float4*>(smem + n * kLp + m)
               : cluster_sum(smem, S, n * kLp + m));
  }
  if (S > 1) cluster.sync();  // no block leaves while its partial is read
}

// Launch 2: h = xln fc1^T over tiles of 128 pixels x 128 hidden units (hidden
// tiles fastest), K = C; the epilogue stores hg^T = gelu(h + b1)^T (a quad
// that straddles the last pixel fills the padding of hg^T's row).
__global__ void __launch_bounds__(kThreads, 1)
convnext_block_fwd_fc1_kernel(const float* __restrict__ xlnT, const float* __restrict__ w1T,
                              const float* __restrict__ b1, float* __restrict__ hgT,
                              long long pixels, int C, int S, int approximate) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  const long long ldp = (pixels + 3) / 4 * 4;
  product<kFc1Stages, true>(
      xlnT, pixels, w1T, 4 * C, C, S, reinterpret_cast<float*>(smem4),
      [&](int n, int p, float4 v) {
        const float bias = __ldg(b1 + n);
        *reinterpret_cast<float4*>(hgT + n * ldp + p) =
            make_float4(gelu(v.x + bias, approximate), gelu(v.y + bias, approximate),
                        gelu(v.z + bias, approximate), gelu(v.w + bias, approximate));
      });
}

// Launch 3: y = x + gamma * (hg fc2^T + b2) over tiles of 128 pixels x 128
// channels (channel tiles fastest), K = 4C.
__global__ void __launch_bounds__(kThreads, 1)
convnext_block_fwd_fc2_kernel(const float* __restrict__ hgT, const float* __restrict__ w2T,
                              const float* __restrict__ b2, const float* __restrict__ gamma,
                              const float* __restrict__ x, float* __restrict__ out,
                              long long pixels, int C, int S) {
  SLOWTV_DYNAMIC_SMEM(smem4);
  product<kFc2Stages, false>(
      hgT, pixels, w2T, C, 4 * C, S, reinterpret_cast<float*>(smem4),
      [&](int c, int p, float4 v) {
        const float g = __ldg(gamma + c), bias = __ldg(b2 + c);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long i = (long long)(p + q) * C + c;
          if (p + q < pixels) out[i] = __ldg(x + i) + g * (vs[q] + bias);
        }
      });
}

// Offsets (in floats) of the scratch buffers; the last is the total. ldp: the
// pixels rounded up to 4, the row of the transposed activations.
struct Layout {
  long long ldp, xlnT, hgT, w1T, w2T, total;
};

Layout scratch_layout(long long pixels, int C) {
  Layout l;
  l.ldp = (pixels + 3) / 4 * 4;
  l.xlnT = 0;
  l.hgT = l.xlnT + C * l.ldp;
  l.w1T = l.hgT + 4LL * C * l.ldp;
  l.w2T = l.w1T + 4LL * C * C;
  l.total = l.w2T + 4LL * C * C;
  return l;
}

bool valid_split(int s) { return s >= 1 && s <= 8; }

// Clusters of `split` blocks of `kernel` (`smem` bytes of shared memory a
// block) that the card runs at once; 0 if the runtime cannot say.
template <class K>
int max_clusters(K kernel, size_t smem, int split) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    return 0;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

}  // namespace

// Thread blocks of the fc1 and fc2 launches (the fewer of the two) that the
// card runs at once in clusters of `split` blocks: one block an SM, but a
// cluster's blocks must share a GPC, so large clusters leave SMs out. 0 if
// the runtime cannot say.
extern "C" int slowtv_convnext_block_fwd_cluster_blocks(int split, int device) {
  if (cudaSetDevice(device) != cudaSuccess || !valid_split(split)) return 0;
  const int fc1 = max_clusters(convnext_block_fwd_fc1_kernel,
                               sizeof(float) * ring_floats(kFc1Stages), split);
  const int fc2 = max_clusters(convnext_block_fwd_fc2_kernel,
                               sizeof(float) * ring_floats(kFc2Stages), split);
  return (fc1 < fc2 ? fc1 : fc2) * split;
}

// Floats of scratch that slowtv_convnext_block_fwd_f32 needs for these shapes.
extern "C" long long slowtv_convnext_block_fwd_scratch_floats(int B, int H, int W, int C) {
  return scratch_layout((long long)B * H * W, C).total;
}

// x, out (B, H, W, C); dww (C, 1, 7, 7); dwb, lnw, lnb, b2, gamma (C,); w1
// (4C, C); b1 (4C,); w2 (C, 4C); scratch of
// slowtv_convnext_block_fwd_scratch_floats floats; all float32, contiguous, on
// `device`; out and scratch 16-byte aligned; C a multiple of 4. The
// plan: M (8, 16 or 32) pixels per tile of the prep launch, whose
// 4 * M * (C + 4) bytes of shared memory must fit the block's 227 KB; split1
// and split2 (1 to 8) blocks per cluster splitting the K of fc1 and of fc2.
// Launches on `stream` and returns the first failing launch's cudaError_t (0
// on success).
extern "C" int slowtv_convnext_block_fwd_f32(
    const float* x, const float* dww, const float* dwb, const float* lnw, const float* lnb,
    const float* w1, const float* b1, const float* w2, const float* b2, const float* gamma,
    float* out, float* scratch, int B, int H, int W, int C, int M, int split1, int split2,
    int approximate, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 4 != 0 || C <= 0 || (M != 8 && M != 16 && M != 32) || !valid_split(split1) ||
      !valid_split(split2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = (long long)B * H * W;
  const int hidden = 4 * C;
  const Layout l = scratch_layout(pixels, C);
  float* xlnT = scratch + l.xlnT;
  float* hgT = scratch + l.hgT;
  float* w1T = scratch + l.w1T;
  float* w2T = scratch + l.w2T;
  const int tiles = (int)((pixels + M - 1) / M), mtiles = (int)((pixels + kBM - 1) / kBM);
  const size_t row_smem = sizeof(float) * (size_t)M * (C + 4);
  const size_t prep_smem = row_smem > sizeof(float) * 32 * 33 ? row_smem : sizeof(float) * 32 * 33;

  err = launch(convnext_block_fwd_prep_kernel,
               (unsigned)(tiles + 2 * ((hidden + 31) / 32) * ((C + 31) / 32)), prep_smem, 0, s,
               x, dww, dwb, lnw, lnb, w1, w2, xlnT, w1T, w2T, B, H, W, C, M, tiles);
  if (err != cudaSuccess) return (int)err;
  err = launch(convnext_block_fwd_fc1_kernel,
               (unsigned)(mtiles * ((hidden + kBN - 1) / kBN) * split1),
               sizeof(float) * ring_floats(kFc1Stages), split1, s, (const float*)xlnT,
               (const float*)w1T, b1, hgT, pixels, C, split1, approximate);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(convnext_block_fwd_fc2_kernel,
                     (unsigned)(mtiles * ((C + kBN - 1) / kBN) * split2),
                     sizeof(float) * ring_floats(kFc2Stages), split2, s, (const float*)hgT,
                     (const float*)w2T, b2, gamma, x, out, pixels, C, split2);
}
