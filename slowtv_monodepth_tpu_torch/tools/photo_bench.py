"""Kernels 7 and 8 (the photometric error's forward and backward) on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench

Kernel 7 (`ops.photo.photo_fwd`) at the KBR micro-step's two photometric
shapes, the warped stack (2 supports x 4 scales x B=4, 384x640, RGB: (32,
384, 640, 3)) and the static stack (2 x B: (8, 384, 640, 3)), and at both
stacks at the training run's AR-aug buckets of 384x640 (224x832 and
480x384, `chip_smoke.run_buckets`); kernel 8 (`ops.photo.photo_bwd`) at the
warped stack's three shapes. Inputs are made from a seed with numpy (x
uniform, y a shifted noisy copy with a band of exact ties), float32. For
each call:
- its device time per call, 10 calls captured into one CUDA graph, CUDA
  events around one replay, divided by 10, held against the plain version
  in float64 as `chip_smoke.py` holds it (kernel 7: PHOTO_ATOL plus twice
  the plain float32 version's error; kernel 8: PHOTO_BWD_RTOL plus twice
  that, relative to the largest |gradient|);
- its CUDA launches by `torch.profiler` (device ms per call, by name);
- its bound: the bytes it must move (x and y in, the map out; kernel 8 also
  g in, dx and dy out) at 3.35 TB/s, beside 80 (kernel 7) or 250 (kernel 8)
  float32 operations per pixel and channel at 67 TFLOP/s
  (`chip_smoke._photo_case`'s counts);
- at the step's shapes, the plain version's time (`torch.profiler`'s device
  sum: the plain version copies host scalars, so a CUDA graph cannot hold it);
- where the checkout has kernel 8's plan (`ops.photo.bwd_plan`), kernel 8 on
  each tile height its C entry takes (kernel 7's other tile heights are
  `variants`).
Kernel 7's two launches per micro-step are also printed summed. It ends with
the `ptxas` lines (registers, stack frame, spills) of both kernels' launches
in the build log.

Of the package it uses only `ops.photo` (`photo_fwd`, `photo_bwd` and their
plain versions, and kernel 8's plan where it exists) and `tools/block_bwd_bench.py`
(`graph_ms`, `launch_split`), so a copy of this file placed in another
checkout's `tools/` times that checkout's kernels: run it in two checkouts
in turns (A, B, B, A) to compare them on one card.

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench digests

prints the sha256 of kernel 7's error map at the step's two photometric
shapes and of kernel 8's dx and dy at the warped stack's, on
`digest_inputs`: `chip_smoke.py` holds both kernels to the digests the
parent checkout printed (PHOTO_FWD_SHA256, PHOTO_BWD_SHA256).

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench variants

builds copies of `csrc/photo.cu` or `csrc/photo_bwd.cu` with one edit each,
patched in at build time (all nvcc runs started together; the library's
sources carry no such switches), and times each copy's C entry at the
step's shapes (kernel 8 on each tile height). Kernel 7 (each with its map's
sha256 on `digest_inputs` against the library's: the same bits, or not): the
IEEE divisions by 9 and by C of its first design in place of `div_rn`;
tiles of 4, 8 or 16 rows (the library's 6); tiles of 64 columns (16 blocks
an SM); u by the hardware's reciprocal with the tie tested as a t == q r
(other bits); kernel 8's pattern of operations (products by 1/9 and 1/C,
fused multiply-adds in the row sums of squares, that u: other bits); the
map's stores left out (a timing aid, wrong). Kernel 8: the IEEE division
and reciprocal (with their slow-path branches) in place of the tie test and
the hardware's reciprocal; launch bounds asking for 3 blocks an SM (the
library's ask for 4); the statistics in rounded multiplies and adds only;
chunks of 4 rows (the library's 2); the staging left out and the outputs'
stores left out (timing aids, wrong).

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench exact

builds a check of `photo_common.cuh`'s `div_rn<D>` (the divisions by 9 and
by C of kernel 7) against the IEEE division `__fdiv_rn(v, D)` over all 2^32
float32 bit patterns v but NaN, on the card, and prints the count of v
whose bits differ for D = 1, 2, 3, 4 and 9.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import photo
from .block_bwd_bench import PEAK_BYTES, PEAK_F32_FLOPS, graph_ms, launch_split

W_SSIM = 0.85
ATOL = 1e-5  # chip_smoke.py's PHOTO_ATOL
RTOL = 1e-5  # chip_smoke.py's PHOTO_BWD_RTOL
STEP = (32, 384, 640, 3)
STATIC = (8, 384, 640, 3)
SHAPES = (STEP, (32, 224, 832, 3), (32, 480, 384, 3))
FWD_SHAPES = tuple((m, h, w, 3) for h, w in ((384, 640), (224, 832), (480, 384)) for m in (32, 8))
FWD_ENTRY = 'slowtv_photo_fwd_f32'
ENTRY = 'slowtv_photo_bwd_f32'


def bench_inputs(shape, seed: int = 0):
    """x uniform in [0, 1); y x shifted by (1, 2) pixels plus noise, clamped,
    with y == x exactly on the left eighth of the columns (S == 0 there); g
    uniform. On the card."""
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    y = np.clip(np.roll(x, (1, 2), axis=(1, 2)) + 0.01 * rs.standard_normal(shape), 0, 1)
    y = y.astype(np.float32)
    y[:, :, : shape[2] // 8] = x[:, :, : shape[2] // 8]
    g = rs.rand(*shape[:3]).astype(np.float32)
    return tuple(torch.from_numpy(t).cuda() for t in (x, y, g))


def cost(shape, fwd: bool = False) -> tuple[float, float]:
    """(bytes, float32 operations) of one call. Kernel 7: x, y in, the map
    out, 80 operations per pixel and channel; kernel 8: x, y, g in, dx, dy
    out, 250."""
    m, h, w, c = shape
    px = m * h * w * c
    return (4 * (2 * px + m * h * w), 80 * px) if fwd else (4 * (4 * px + m * h * w), 250 * px)


def bound(shape, fwd: bool = False) -> str:
    n_bytes, flops = cost(shape, fwd)
    bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES, 1e3 * flops / PEAK_F32_FLOPS
    return f'{max(bytes_ms, ops_ms):.4f} (bytes {bytes_ms:.4f}, operations {ops_ms:.4f})'


def bound_ms(shape, fwd: bool = False) -> float:
    n_bytes, flops = cost(shape, fwd)
    return 1e3 * max(n_bytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)


def rel_err(got, want) -> float:
    scale = max(1.0, max(float(t.abs().max()) for t in want))
    return max(float((u.double() - t).abs().max()) for u, t in zip(got, want)) / scale


def check(fn, x, y, g) -> tuple[float, float]:
    """Kernel 8's (error, tolerance): against the plain version in float64,
    relative to the largest |gradient|."""
    want = photo.photo_bwd_plain(x.double(), y.double(), g.double(), W_SSIM)
    plain32 = rel_err(photo.photo_bwd_plain(x, y, g, W_SSIM), want)
    err = rel_err(fn(), want)
    del want
    torch.cuda.empty_cache()
    return err, RTOL + 2 * plain32


def fwd_check(fn, x, y) -> tuple[float, float]:
    """Kernel 7's (error, tolerance): against the plain version in float64."""
    want = photo.photo_fwd_plain(x.double(), y.double(), W_SSIM)
    plain32 = float((photo.photo_fwd_plain(x, y, W_SSIM).double() - want).abs().max())
    err = float((fn().double() - want).abs().max())
    del want
    torch.cuda.empty_cache()
    return err, ATOL + 2 * plain32


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _entry_call(lib, x, y, g, rows):
    """A call of `lib`'s kernel-8 entry with tiles `rows` high, into outputs
    made once -> (the call, (dx, dy))."""
    m, h, w, c = x.shape
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    tensors = (x, y, g, dx, dy)  # the call keeps them alive

    def call():
        _build.check(getattr(lib, ENTRY)(*(t.data_ptr() for t in tensors), m, h, w, c,
                                         W_SSIM / c, (1 - W_SSIM) / c, rows, x.device.index,
                                         _stream()), 'kernel 8')
        return dx, dy
    return call


def _fwd_entry_call(lib, x, y):
    """A call of `lib`'s kernel-7 entry into a map made once."""
    m, h, w, c = x.shape
    out = torch.empty((m, h, w), device=x.device)

    def call():
        _build.check(getattr(lib, FWD_ENTRY)(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, h,
                                             w, c, W_SSIM, 1 - W_SSIM, x.device.index,
                                             _stream()), 'kernel 7')
        return out
    return call


def _ptxas(log: str) -> None:
    entry = ''
    for line in log.splitlines():
        if 'Compiling entry' in line or 'Function properties for' in line:
            m = re.search(r'(photo_(?:fwd|bwd)_kernel)I((?:Li\d+E)+)', line)
            entry = f'{m.group(1)}<{", ".join(re.findall(r"Li(\d+)E", m.group(2)))}>' if m else ''
        elif entry and ('registers' in line or 'stack frame' in line):
            print(f'ptxas {entry}: {line.replace("ptxas info    :", "").strip()}')


def bench_fwd() -> None:
    """Kernel 7 at FWD_SHAPES, and per micro-step (both stacks at 384x640)."""
    step = {}
    for shape in FWD_SHAPES:
        x, y, _ = bench_inputs(shape)
        err, tol = fwd_check(lambda: photo.photo_fwd(x, y, W_SSIM), x, y)
        if not err <= tol:
            raise SystemExit(f'kernel 7 at {shape}: off the plain version in float64 by '
                             f'{err:.2e} (tol {tol:.2e})')
        ms = graph_ms(lambda: photo.photo_fwd(x, y, W_SSIM))
        split = launch_split(lambda: photo.photo_fwd(x, y, W_SSIM))
        n_bytes = cost(shape, fwd=True)[0]
        line = (f'{shape}: kernel 7 {ms:.4f} ms (err {err:.1e}, tol {tol:.1e}); bound '
                f'{bound(shape, fwd=True)}; {bound_ms(shape, fwd=True) / ms:.0%} of it; '
                f'{n_bytes / ms / 1e9:.2f} TB/s; launches (profiler): '
                + ', '.join(f'{k} {v:.4f}' for k, v in split.items()))
        if shape[1:3] == (384, 640):
            step[shape] = ms
            plain = launch_split(lambda: photo.photo_fwd_plain(x, y, W_SSIM))
            line += f'; plain {sum(plain.values()):.4f} (profiler)'
        print(line, flush=True)
        del x, y
        torch.cuda.empty_cache()
    total = sum(step.values())
    print(f'kernel 7 per KBR micro-step (both stacks at 384x640): {total:.4f} ms, bound '
          f'{sum(bound_ms(s, fwd=True) for s in step):.4f} ('
          + ', '.join(f'{s[0]}: {v:.4f}, {v / total:.0%}' for s, v in step.items()) + ')',
          flush=True)


def bench_bwd(lib, sms: int) -> None:
    """Kernel 8 at SHAPES."""
    has_plan = hasattr(photo, 'bwd_plan')
    for shape in SHAPES:
        x, y, g = bench_inputs(shape)
        err, tol = check(lambda: photo.photo_bwd(x, y, g, W_SSIM), x, y, g)
        if not err <= tol:
            raise SystemExit(f'kernel 8 at {shape}: off the plain version in float64 by '
                             f'{err:.2e} of max|grad| (tol {tol:.2e})')
        ms = graph_ms(lambda: photo.photo_bwd(x, y, g, W_SSIM))
        split = launch_split(lambda: photo.photo_bwd(x, y, g, W_SSIM))
        n_bytes = cost(shape)[0]
        line = (f'{shape}: kernel 8 {ms:.4f} ms (err {err:.1e}, tol {tol:.1e}); bound '
                f'{bound(shape)}; {bound_ms(shape) / ms:.0%} of it; '
                f'{n_bytes / ms / 1e9:.2f} TB/s; launches (profiler): '
                + ', '.join(f'{k} {v:.4f}' for k, v in split.items()))
        if has_plan:
            line += f'; plan {photo.bwd_plan(*shape, sms)} rows; by tile height: ' + ', '.join(
                f'{r} {graph_ms(_entry_call(lib, x, y, g, r)):.4f}' for r in photo.BWD_ROWS)
        if shape == STEP:
            plain = launch_split(lambda: photo.photo_bwd_plain(x, y, g, W_SSIM))
            line += f'; plain {sum(plain.values()):.4f} (profiler)'
        print(line, flush=True)
        del x, y, g
        torch.cuda.empty_cache()


def main() -> None:
    build = _build.build()
    lib = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bench_fwd()
    bench_bwd(lib, sms)
    _ptxas(build.log or build.path.with_suffix('.log').read_text())


def digest_inputs(shape):
    """Uniform x and y in [0, 1) and g from seed 7, on the card."""
    rs = np.random.RandomState(7)
    return tuple(torch.from_numpy(rs.rand(*s).astype(np.float32)).cuda()
                 for s in (shape, shape, shape[:3]))


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def fwd_digests(fwd=None) -> dict[str, str]:
    """sha256 of kernel 7's map at the step's two photometric shapes, by
    shape; `fwd(x, y)` in place of `photo_fwd` where given."""
    fwd = fwd or (lambda x, y: photo.photo_fwd(x, y, W_SSIM))
    out = {}
    for shape in (STEP, STATIC):
        x, y, _ = digest_inputs(shape)
        out[str(shape)] = sha256(fwd(x, y))
    return out


def bwd_digests() -> dict[str, str]:
    """sha256 of kernel 8's dx and dy at the warped stack's shape."""
    x, y, g = digest_inputs(STEP)
    dx, dy = photo.photo_bwd(x, y, g, W_SSIM)
    return {'dx': sha256(dx), 'dy': sha256(dy)}


def digests() -> None:
    for shape, digest in fwd_digests().items():
        print(f'photo_fwd {shape}: {digest}')
    bwd = bwd_digests()
    print(f'photo_bwd {STEP}: dx {bwd["dx"]}, dy {bwd["dy"]}')


SKIP = 'if (a.H < 0) '
BOUNDS = '__launch_bounds__(kMaxThreads, 4) photo_bwd_kernel'
FWD_BOUNDS = '__launch_bounds__(kTileW, 8) photo_fwd_kernel'
FWD_ROWS = 'constexpr int kRows = 6;'
FWD_COLS = 'constexpr int kTileW = 128;'
FWD_DIV9 = ('m[k] = div_rn<9>(add(add(h[i % 3][k], h[(i + 1) % 3][k]), ht[k]));',
            'm[k] = __fdiv_rn(add(add(h[i % 3][k], h[(i + 1) % 3][k]), ht[k]), 9.f);')
FWD_DIVC = ('acc[i] = add(acc[i], div_rn<C>(add(mul(a.w_ssim, s), mul(a.w_l1, d[(i + 1) % 3]))));',
            'acc[i] = add(acc[i], __fdiv_rn(add(mul(a.w_ssim, s), mul(a.w_l1, d[(i + 1) % 3])), '
            '(float)C));')
FWD_U = ('const float raw = mul(sub(1.f, __fdiv_rn(mul(sa, st), mul(sq, sr))), 0.5f);',
         'const float n = mul(sa, st), dd = mul(sq, sr); '
         'const float raw = mul(sub(1.f, n == dd ? 1.f : n * __fdividef(1.f, dd)), 0.5f);')
# name -> (source, edits (old, new) of it).
VARIANTS = {
    'kernel 7: IEEE divisions by 9 and C (its first design)': ('photo.cu', (FWD_DIV9, FWD_DIVC)),
    'kernel 7: tiles of 4 rows': ('photo.cu', ((FWD_ROWS, FWD_ROWS.replace('6', '4')),)),
    'kernel 7: tiles of 8 rows': ('photo.cu', (
        (FWD_ROWS, FWD_ROWS.replace('6', '8')), (FWD_BOUNDS, FWD_BOUNDS.replace(', 8)', ', 7)')))),
    'kernel 7: tiles of 16 rows': ('photo.cu', ((FWD_ROWS, FWD_ROWS.replace('6', '16')),)),
    'kernel 7: tiles of 64 columns': ('photo.cu', (
        (FWD_COLS, FWD_COLS.replace('128', '64')),
        (FWD_BOUNDS, FWD_BOUNDS.replace(', 8)', ', 16)')))),
    "kernel 7: u by the hardware's reciprocal, the tie tested (other bits)": ('photo.cu', (
        FWD_U,)),
    "kernel 7: kernel 8's pattern (other bits)": ('photo.cu', (
        (FWD_DIV9[0], 'm[k] = mul(add(add(h[i % 3][k], h[(i + 1) % 3][k]), ht[k]), 1.f / 9.f);'),
        (FWD_DIVC[0], 'acc[i] = add(acc[i], mul(add(mul(a.w_ssim, s), mul(a.w_l1, '
                      'd[(i + 1) % 3])), 1.f / C));'),
        FWD_U,
        ('ht[2] = add(add(mul(x0, x0), mul(x1, x1)), mul(x2, x2));',
         'ht[2] = fmadd(x0, x0, fmadd(x1, x1, mul(x2, x2)));'),
        ('ht[3] = add(add(mul(y0, y0), mul(y1, y1)), mul(y2, y2));',
         'ht[3] = fmadd(y0, y0, fmadd(y1, y1, mul(y2, y2)));'),
        ('ht[4] = add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2));',
         'ht[4] = fmadd(x0, y0, fmadd(x1, y1, mul(x2, y2)));'))),
    'kernel 7: no stores (wrong)': ('photo.cu', (
        ('if (oy + i < H) out[', 'if (a.H < 0) out['),)),
    'kernel 8: IEEE division and reciprocal': ('photo_bwd.cu', (
        ('const float rd = __fdividef(1.f, d);', 'const float rd = __frcp_rn(d);'),
        ('const float u = n == d ? 1.f : n * rd;', 'const float u = __fdiv_rn(n, d);'))),
    'kernel 8: launch bounds of 3 blocks an SM': ('photo_bwd.cu', (
        (BOUNDS, BOUNDS.replace(', 4)', ', 3)')),)),
    'kernel 8: statistics without fused multiply-adds': ('photo_bwd.cu', (
        ('ht[2] = fmadd(x0, x0, fmadd(x1, x1, mul(x2, x2)));',
         'ht[2] = add(add(mul(x0, x0), mul(x1, x1)), mul(x2, x2));'),
        ('ht[3] = fmadd(y0, y0, fmadd(y1, y1, mul(y2, y2)));',
         'ht[3] = add(add(mul(y0, y0), mul(y1, y1)), mul(y2, y2));'),
        ('ht[4] = fmadd(x0, y0, fmadd(x1, y1, mul(x2, y2)));',
         'ht[4] = add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2));'),
        ('const float sa = fmadd(mx, my, fmadd(mx, my, kC1));',
         'const float sa = add(mul(mul(2.f, mx), my), kC1);'),
        ('const float sq = fmadd(mx, mx, fmadd(my, my, kC1));',
         'const float sq = add(add(mul(mx, mx), mul(my, my)), kC1);'),
        ('const float st = add(cov, add(cov, kC2));',
         'const float st = add(mul(2.f, sub(m[4], mul(mx, my))), kC2);'),
        ('const float sr = add(fmadd(-mx, mx, m[2]), add(fmadd(-my, my, m[3]), kC2));',
         'const float sr = add(add(sub(m[2], mul(mx, mx)), sub(m[3], mul(my, my))), kC2);'))),
    'kernel 8: chunks of 4 rows': ('photo_bwd.cu', (
        ('constexpr int kChunk = 2;', 'constexpr int kChunk = 4;'),)),
    'kernel 8: no staging (wrong)': ('photo_bwd.cu', (
        ('stage_row<C, kStageW>(a.x, a.y, W,', SKIP + 'stage_row<C, kStageW>(a.x, a.y, W,'),)),
    'kernel 8: no output stores (wrong)': ('photo_bwd.cu', (
        ('if (out_col && oy + i < H) {', 'if (out_col && a.H < 0) {'),)),
}


def _build_variants() -> dict:
    """name -> ctypes library of each VARIANTS copy, all nvcc runs started together."""
    out = _build.BUILD_DIR / 'photo_bench'
    procs = {}
    for i, (name, (source, edits)) in enumerate(VARIANTS.items()):
        src = out / f'variant_{i}'
        src.mkdir(parents=True, exist_ok=True)
        for f in ('photo.cu', 'photo_bwd.cu', 'photo_common.cuh'):
            shutil.copy(_build.CSRC / f, src / f)
        text = (src / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'variant {name!r}: {old!r} is not in {source} once')
            text = text.replace(old, new)
        (src / source).write_text(text)
        path = src / 'photo.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(path), str(src / source)]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        entry = FWD_ENTRY if name.startswith('kernel 7') else ENTRY
        getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        libs[name] = lib
        print(f'{name}:')
        _ptxas(log)
    return libs


# Every float32 v but NaN through photo_common.cuh's div_rn<D> and through
# the IEEE division, on the card: the count of v whose bits differ.
EXACT_SOURCE = r'''
#include "photo_common.cuh"
template <int D>
__global__ void div_check(unsigned long long* bad) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * 256ull + threadIdx.x; i < (1ull << 32);
       i += gridDim.x * 256ull) {
    const float v = __uint_as_float((unsigned)i);
    n += v == v && __float_as_uint(__fdiv_rn(v, (float)D)) != __float_as_uint(div_rn<D>(v));
  }
  if (n) atomicAdd(bad, n);
}
extern "C" long long slowtv_div_check(int d) {
  unsigned long long* bad;
  unsigned long long n = 0;
  if (cudaMalloc(&bad, 8) || cudaMemset(bad, 0, 8)) return -1;
  switch (d) {
    case 1: div_check<1><<<1056, 256>>>(bad); break;
    case 2: div_check<2><<<1056, 256>>>(bad); break;
    case 3: div_check<3><<<1056, 256>>>(bad); break;
    case 4: div_check<4><<<1056, 256>>>(bad); break;
    case 9: div_check<9><<<1056, 256>>>(bad); break;
    default: return -1;
  }
  const bool ok = cudaMemcpy(&n, bad, 8, cudaMemcpyDeviceToHost) == cudaSuccess;
  cudaFree(bad);
  return ok ? (long long)n : -1;
}
'''
DIVISORS = (1, 2, 3, 4, 9)


def division_mismatches() -> dict[int, int]:
    """D -> the count of floats v (all 2^32 but NaN) for which div_rn<D>(v) and
    __fdiv_rn(v, D) differ in any bit, on the card."""
    out = _build.BUILD_DIR / 'photo_bench' / 'exact'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'exact.cu').write_text(EXACT_SOURCE)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f'-I{_build.CSRC}', '-shared', '-o',
           str(out / 'exact.so'), str(out / 'exact.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n'
                           f'{proc.stdout}{proc.stderr}')
    lib = ctypes.CDLL(str(out / 'exact.so'))
    lib.slowtv_div_check.argtypes, lib.slowtv_div_check.restype = [ctypes.c_int], ctypes.c_longlong
    return {d: lib.slowtv_div_check(d) for d in DIVISORS}


def bench_variants() -> None:
    libs = _build_variants()
    library = _build.load()
    fwd = {'kernel 7: library': library,
           **{k: v for k, v in libs.items() if k.startswith('kernel 7')}}
    bwd = {'kernel 8: library': library,
           **{k: v for k, v in libs.items() if k.startswith('kernel 8')}}
    want = fwd_digests()
    for name, lib in fwd.items():
        same = fwd_digests(lambda x, y: _fwd_entry_call(lib, x, y)()) == want
        line = []
        for shape in (STEP, STATIC):
            x, y, _ = bench_inputs(shape)
            call = _fwd_entry_call(lib, x, y)
            err, tol = fwd_check(call, x, y)
            if 'wrong' not in name and not err <= tol:
                raise SystemExit(f'{name}: off the plain version by {err:.2e} (tol {tol:.2e})')
            line.append(f'{shape} {graph_ms(call):.4f} ms (err {err:.1e})')
            del x, y
        print(f'{name}: ' + ', '.join(line) + f'; the library\'s bits: {same}', flush=True)
    x, y, g = bench_inputs(STEP)
    for name, lib in bwd.items():
        line = []
        for rows in photo.BWD_ROWS:
            call = _entry_call(lib, x, y, g, rows)
            err, tol = check(call, x, y, g)
            if 'wrong' not in name and not err <= tol:
                raise SystemExit(f'{name}: off the plain version by {err:.2e} (tol {tol:.2e})')
            line.append(f'{rows} rows {graph_ms(call):.4f} ms (err {err:.1e})')
        print(f'{name} {STEP}: ' + ', '.join(line), flush=True)


if __name__ == '__main__':
    if not torch.cuda.is_available():
        raise SystemExit('photo_bench needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    mode = sys.argv[1:]
    if mode == ['digests']:
        digests()
    elif mode == ['variants']:
        bench_variants()
    elif mode == ['exact']:
        print('floats v (all 2^32 but NaN) where div_rn<D>(v) and __fdiv_rn(v, D) differ: '
              + ', '.join(f'D = {d}: {n}' for d, n in division_mismatches().items()))
    else:
        main()
