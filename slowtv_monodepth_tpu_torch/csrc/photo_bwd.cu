// The photometric error's analytic backward (kernel 8), float32, NHWC images,
// (M, H, W) cotangent.
//
// Replaces the TPU kernel slowtv_monodepth_tpu/ops/pallas_photo.py:_bwd_kernel
// (launched by _photo_bwd_jit); entry point photo_err_ssim, reached from
// losses/photometric.py:PhotoError. It is the VJP (dx, dy) of
//   err = sum_c (w_ssim S + (1 - w_ssim) |x - y|) / C
// for a cotangent g, with, per channel, c1 = 0.01^2, c2 = 0.03^2 and P the
// 3x3 mean pool over a reflect-padded image (photo.cu has the forward):
//   mx = P(x)  my = P(y)  a = 2 mx my + c1  t = 2 (P(xy) - mx my) + c2
//   q = mx^2 + my^2 + c1  r = (P(x^2) - mx^2) + (P(y^2) - my^2) + c2
//   S = clip((1 - u) / 2, 0, 1),  u = a t / (q r).
// At each pooled position the four maps V = G * du/d(stat), G = g w_ssim / C
// (-1/2) mask (mask 1 inside the clip, 0.5 at a tie, 0 outside: jnp.clip's
// VJP; du/dP(x^2) == du/dP(y^2)), go back through the pool's adjoint P^T:
//   dx = P^T(V_mx) + 2x P^T(V_x2) + y P^T(V_xy) + (1 - w_ssim) / C sign(x - y) g
// and dy likewise (sign(0) = 0).
//
// Bound on Hopper: latency and instruction issue, not memory or FLOPs. At
// the KBR step's (32, 384, 640, 3) it must move 409 MB (x, y, g in, dx, dy
// out: 0.122 ms at 3.35 TB/s) and does a few hundred operations per pixel and
// channel, most of them shared-memory loads and each pooled position's long
// chain of dependent statistics.
//
// Design: one block per tile of TH output rows x kTileW = 62 output columns x
// all C channels (C <= 4: RGB or grey) of one image, 64 C threads, one per
// float column of the tile's pooled grid (its 64 pixels with the 1-pixel
// halo, x C).
// - Staging. x and y rows of the tile with a 2-pixel halo, (kTileW + 4) C
//   floats each, are copied as they lie in memory: the in-image part of a row
//   is one contiguous run, copied by 16-byte cp.async into shared rows
//   shifted so that shared and global addresses agree mod 16 bytes (where x
//   and y are 16-byte aligned and W C % 4 == 0, so that every row has the
//   same shift; else float by float); only the halo pixels past the
//   image's edge go through the reflect index map.
//   g comes with a 1-pixel halo, zero outside the image. The channels stay
//   interleaved: thread j works on float j of a row, whose horizontal
//   neighbours lie C floats away, so a warp reads 32 neighbouring floats.
// - Statistics, once per position. Thread j walks down its column: per
//   staged row it forms the horizontal 3-sums of x, y, x^2, y^2 and xy,
//   keeps the last three rows' in registers, and their vertical sum is the
//   window's five sums (the TPU kernel's separable _pool). Each of the TH + 2
//   pooled rows then costs one window's statistics and one reciprocal (the
//   hardware's: no slow-path branch, so the unrolled walk is one straight
//   run of code whose rows overlap; a tie is tested as a t == q r, exactly).
//   The thread also sums the pool adjoint's vertical half in registers as
//   it walks: output row i takes V from pooled rows i - 1, i, i + 1 with
//   weights (1, 1, 1), 2 on a neighbour whose reflection lands on i as well
//   (fold_weight), and V == 0 outside the image. Every thread does the same
//   work.
// - Outputs, every kChunk rows. The finished rows of the four vertical sums
//   go to shared memory; after a barrier thread j takes the adjoint's
//   horizontal half for output float column j (three shared loads per map,
//   C floats apart, the same fold weights) with x, y and g from the staged
//   tile, and a warp stores 32 neighbouring floats of dx and of dy; a
//   second barrier, and the walk goes on, its registers intact. Keeping one
//   chunk of sums, not the tile's, lets five 16-row blocks share an SM: on
//   an H100 the kernel's time follows the warps an SM holds.
// The statistics use the TPU kernel's formulas in float32 (variances by
// cancellation, as the reference computes them) with explicitly rounded
// operations (fused multiply-adds among them) in one pattern for x and y and
// for each pair compared at a tie, so x == y over a window gives
// a t == q r exactly, u == 1, S == 0 and the tie mask 0.5, as the plain
// version does (u is the IEEE quotient there; elsewhere within 2 ulp of
// it). C is a template parameter, so that every shared address is a
// register plus a constant. The tile height (4 or 16 rows) is the host's plan
// (ops/photo.py:bwd_plan, for the card's SM count); the shared memory it
// needs is slowtv_photo_bwd_smem_bytes here, which the plan mirrors. No
// atomics, and every output's sums run in one order whatever the tile
// height: two calls give the same bits.
//
// The launch goes through cudaLaunchKernelEx and shared memory is dynamic
// (SLOWTV_DYNAMIC_SMEM), so tests/cuda_emu builds this file for the CPU. The
// row staging, the reflect map and the rounded operations are
// photo_common.cuh's, shared with the forward (photo.cu).
#include "photo_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPoolW = 64;             // pooled columns of a tile: outputs and their halo
constexpr int kTileW = kPoolW - 2;     // output columns of a tile
constexpr int kStageW = kPoolW + 2;    // staged columns: the 2-pixel halo

// The adjoint of a reflect-padded 3-tap box at output q takes its neighbour
// q - 1 (edge 1) or q + 1 (edge n - 2) twice where q is that edge: the
// neighbour's own pad reflects onto q. A neighbour outside the image carries
// V == 0, so its weight does not matter.
__device__ __forceinline__ float fold_weight(int q, int edge) { return q == edge ? 2.f : 1.f; }

struct BwdArgs {
  const float* x;
  const float* y;
  const float* g;
  float* dx;
  float* dy;
  int H, W;
  int row_tiles, col_tiles;
  float gs9;  // w_ssim / C * -1/2 * 1/9: G's factor with the pool's 1/9
  float gl;   // (1 - w_ssim) / C
  int vec;    // x and y 16-byte aligned and W C % 4 == 0: interiors by 16-byte cp.async
};

// Rows of the adjoint's vertical sums a block keeps in shared memory: the
// outputs go out every kChunk rows, so that a 16-row tile of C = 3 needs
// ~43 KB and, at 64 registers, five blocks fit an SM (per KBR micro-step on
// an H100: 0.2450 ms; with chunks of 4 rows 0.2628; held to three blocks an
// SM 0.2596; tools/photo_bench.py variants).
constexpr int kChunk = 2;

template <int TH, int C>
__global__ void __launch_bounds__(kMaxThreads, 4) photo_bwd_kernel(BwdArgs a) {
  constexpr int CH = TH < kChunk ? TH : kChunk;
  constexpr int SC = kPoolW * C;  // floats of a pooled row: one a thread
  constexpr int RS = row_floats(kStageW, C);
  SLOWTV_DYNAMIC_SMEM(smem);
  const int H = a.H, W = a.W;
  float* xs = reinterpret_cast<float*>(smem);  // [TH + 4][RS]
  float* ys = xs + (TH + 4) * RS;              // [TH + 4][RS]
  float* vs = ys + (TH + 4) * RS;              // [4][CH][SC]: the adjoint's vertical sums
  float* gt = vs + 4 * CH * SC;                // [TH + 2][kPoolW]

  const int tid = threadIdx.x, lane = tid & 31;
  int blk = blockIdx.x;
  const int tc = blk % a.col_tiles;
  blk /= a.col_tiles;
  const int tr = blk % a.row_tiles;
  const long long plane = (long long)(blk / a.row_tiles) * H;  // the image's first row
  const int oy = tr * TH, ox = tc * kTileW;
  // Staged row t starts at float sh of its shared row: the global float
  // index of staged pixel 0 mod 4, the same for every row since W C % 4 == 0
  // (16-byte copies land aligned), or 0 for the scalar copies.
  const int sh = a.vec ? ((ox - 2) * C) & 3 : 0;

  // Staging: a warp per row. (Rows copied in rounds, the walk waiting at
  // each chunk for that chunk's rows only, took as long on an H100: other
  // blocks on the SM hide the copies.)
  for (int t = tid >> 5; t < TH + 4; t += SC / 32) {
    const long long row_base = (plane + reflect(oy - 2 + t, H)) * W;
    stage_row<C, kStageW>(a.x, a.y, W, a.vec, row_base, ox - 2, xs + t * RS + sh,
                          ys + t * RS + sh, lane);
  }
  for (int s = tid >> 5; s < TH + 2; s += SC / 32) {
    const int row = oy - 1 + s;
    for (int k = lane; k < kPoolW; k += 32) {
      const int col = ox - 1 + k;
      gt[s * kPoolW + k] = row >= 0 && row < H && col >= 0 && col < W
                               ? __ldg(a.g + (plane + row) * W + col) : 0.f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Thread j walks pooled float column j (pixel kj = j / C, image column
  // ox - 1 + kj; staged taps j, j + C, j + 2C) and, after each chunk of
  // vertical sums, writes output float column j (pixel kj, image column
  // ox + kj) of the chunk's rows: its horizontal sums read vertical sums
  // j, j + C, j + 2C.
  const int j = tid, kj = j / C;
  const bool col_in = ox - 1 + kj >= 0 && ox - 1 + kj < W;
  const bool out_col = j < kTileW * C && ox + kj < W;
  const float wx0 = fold_weight(ox + kj, 1), wx2 = fold_weight(ox + kj, W - 2);
  const float* xj = xs + sh + j;
  const float* yj = ys + sh + j;
  const float* gj = gt + kj;
  float* vj = vs + j;
  const long long out0 = ((plane + oy) * W + ox) * C + j;  // output row 0 of column j
  float h[3][5];    // horizontal sums of the last three staged rows (x, y, x^2, y^2, xy)
  float acc[3][4];  // vertical sums in progress, by output row mod 3
#pragma unroll
  for (int t = 0; t < TH + 4; ++t) {
    const float x0 = xj[t * RS], x1 = xj[t * RS + C], x2 = xj[t * RS + 2 * C];
    const float y0 = yj[t * RS], y1 = yj[t * RS + C], y2 = yj[t * RS + 2 * C];
    float* ht = h[t % 3];
    ht[0] = add(add(x0, x1), x2);
    ht[1] = add(add(y0, y1), y2);
    ht[2] = fmadd(x0, x0, fmadd(x1, x1, mul(x2, x2)));
    ht[3] = fmadd(y0, y0, fmadd(y1, y1, mul(y2, y2)));
    ht[4] = fmadd(x0, y0, fmadd(x1, y1, mul(x2, y2)));
    if (t < 2) continue;
    const int s = t - 2;  // pooled row: image row oy - 1 + s
    float m[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      m[k] = mul(add(add(h[s % 3][k], h[(s + 1) % 3][k]), h[t % 3][k]), 1.f / 9.f);
    }
    // a = 2 mx my + c1, q = mx^2 + my^2 + c1, t = 2 cov + c2 and r = var_x +
    // var_y + c2, each pair in one pattern of rounded operations, so that at
    // mx == my, P(x^2) == P(y^2) == P(xy) they come out equal.
    const float mx = m[0], my = m[1];
    const float sa = fmadd(mx, my, fmadd(mx, my, kC1));
    const float sq = fmadd(mx, mx, fmadd(my, my, kC1));
    const float cov = fmadd(-mx, my, m[4]);
    const float st = add(cov, add(cov, kC2));
    const float sr = add(fmadd(-mx, mx, m[2]), add(fmadd(-my, my, m[3]), kC2));
    // u = n / d: at a tie (n == d exactly) 1 exactly, as the IEEE quotient
    // is; else by the hardware's reciprocal (2 ulp), which has no slow path,
    // so the unrolled walk stays one straight run of code.
    const float n = mul(sa, st), d = mul(sq, sr);
    const float rd = __fdividef(1.f, d);
    const float u = n == d ? 1.f : n * rd;
    const float raw = mul(sub(1.f, u), 0.5f);
    const float mask = (raw > 0.f && raw < 1.f) ? 1.f
                       : ((raw == 0.f || raw == 1.f) ? 0.5f : 0.f);
    const int row = oy - 1 + s;
    const bool inside = col_in && row >= 0 && row < H;
    const float gd = gj[s * kPoolW] * a.gs9 * mask * rd;
    const float ta = st - sa, rq = sr - sq;
    float v[4] = {gd * (2.f * my * ta - u * (2.f * mx * rq)),
                  gd * (2.f * mx * ta - u * (2.f * my * rq)), gd * (-u * sq), gd * (2.f * sa)};
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = inside ? v[k] : 0.f;  // a select, not a branch
    // Output row i (image row oy + i) sums pooled rows i, i + 1, i + 2.
    if (s >= 2) {
      const float w2 = fold_weight(oy + s - 2, H - 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) vj[(k * CH + (s - 2) % CH) * SC] = acc[(s - 2) % 3][k] + w2 * v[k];
    }
    if (s >= 1 && s - 1 < TH) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[(s - 1) % 3][k] += v[k];
    }
    if (s < TH) {
      const float w0 = fold_weight(oy + s, 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s % 3][k] = w0 * v[k];
    }
    if (s < 2 || (s - 2) % CH != CH - 1) continue;
    // A chunk of vertical sums is complete: its output rows go out.
    const int i0 = s - 2 - (CH - 1);
    __syncthreads();
#pragma unroll
    for (int i = i0; i < i0 + CH; ++i) {  // rows past the image: computed, not stored
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* vk = vj + (k * CH + i % CH) * SC;
        p[k] = wx0 * vk[0] + vk[C] + wx2 * vk[2 * C];
      }
      const float xq = xj[(i + 2) * RS + 2 * C];
      const float yq = yj[(i + 2) * RS + 2 * C];
      const float diff = xq - yq;
      const float l1 = a.gl * (float)((diff > 0.f) - (diff < 0.f)) * gj[(i + 1) * kPoolW + 1];
      const long long go = out0 + (long long)i * W * C;
      if (out_col && oy + i < H) {
        a.dx[go] = p[0] + p[2] * (2.f * xq) + p[3] * yq + l1;
        a.dy[go] = p[1] + p[2] * (2.f * yq) + p[3] * xq - l1;
      }
    }
    if (i0 + CH < TH) __syncthreads();  // the next chunk overwrites these sums
  }
}

long long smem_bytes(int rows, int C) {
  const int chunk = rows < kChunk ? rows : kChunk;
  return 4LL * (2LL * (rows + 4) * row_floats(kStageW, C) + 4LL * chunk * kPoolW * C +
                (rows + 2) * kPoolW);
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

template <int TH, int C>
cudaError_t launch(BwdArgs a, long long blocks, cudaStream_t s) {
  const long long smem = smem_bytes(TH, C);
  if (smem > 48 * 1024) {  // above 48 KB it has to be asked for, or the launch is refused
    const cudaError_t err = cudaFuncSetAttribute(
        photo_bwd_kernel<TH, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)(kPoolW * C));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, photo_bwd_kernel<TH, C>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int TH>
cudaError_t launch_c(BwdArgs a, int C, long long blocks, cudaStream_t s) {
  return C == 1 ? launch<TH, 1>(a, blocks, s)
                : C == 2 ? launch<TH, 2>(a, blocks, s)
                         : C == 3 ? launch<TH, 3>(a, blocks, s) : launch<TH, 4>(a, blocks, s);
}

}  // namespace

// Shared memory of one block of a tile `rows` high for C channels;
// ops/photo.py:smem_bytes mirrors it.
extern "C" long long slowtv_photo_bwd_smem_bytes(int rows, int C) { return smem_bytes(rows, C); }

// x, y (M, H, W, C), g (M, H, W) -> dx, dy (M, H, W, C); float32, contiguous,
// on `device`; H, W >= 2; C <= 4; gs = w_ssim / C, gl = (1 - w_ssim) / C;
// `rows` the tile height of the plan (4 or 16; ops/photo.py:bwd_plan). One
// launch on `stream`; returns its cudaError_t (0 on success).
extern "C" int slowtv_photo_bwd_f32(const float* x, const float* y, const float* g, float* dx,
                                    float* dy, int M, int H, int W, int C, float gs, float gl,
                                    int rows, int device, void* stream) {
  if (H < 2 || W < 2 || C < 1 || C > kMaxThreads / kPoolW || M < 0 || (rows != 4 && rows != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdArgs a = {x, y, g, dx, dy, H, W};
  a.row_tiles = (H + rows - 1) / rows;
  a.col_tiles = (W + kTileW - 1) / kTileW;
  a.gs9 = gs * -0.5f / 9.f;
  a.gl = gl;
  a.vec = aligned16(x) && aligned16(y) && (long long)W * C % 4 == 0;
  const long long blocks = (long long)M * a.row_tiles * a.col_tiles;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(rows == 16 ? launch_c<16>(a, C, blocks, s) : launch_c<4>(a, C, blocks, s));
}
