"""Kernel 8 (the photometric error's backward) on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench

At the KBR micro-step's shape, the warped stack (2 supports x 4 scales x
B=4, 384x640, RGB: (32, 384, 640, 3)), and at the training run's AR-aug
buckets of it (224x832 and 480x384, `chip_smoke.run_buckets`), on inputs made
from a seed with numpy (x uniform, y a shifted noisy copy with a band of
exact ties), float32:
- kernel 8 (`ops.photo.photo_bwd`, one CUDA launch): its device time per
  call, 10 calls captured into one CUDA graph, CUDA events around one
  replay, divided by 10, held against the plain version in float64 as
  `chip_smoke.py` holds it (PHOTO_BWD_RTOL plus twice the plain float32
  version's error, relative to the largest |gradient|);
- its CUDA launches by `torch.profiler` (device ms per call, by name);
- its bound: the bytes it must move (x, y and g in, dx and dy out) at 3.35
  TB/s, beside 250 float32 operations per pixel and channel at 67 TFLOP/s
  (`chip_smoke._photo_case`'s count);
- the plain version's time at the step's shape (`torch.profiler`'s device
  sum: the plain version copies host scalars, so a CUDA graph cannot hold it);
- where the checkout has `ops.photo.bwd_plan`, the kernel on each tile
  height the C entry takes (4, 8, 16 rows), beside the plan's.
It ends with the `ptxas` lines (registers, stack frame, spills) of kernel
8's launches in the build log.

Of the package it uses only `ops.photo` (`photo_bwd`, `photo_bwd_plain`,
`photo_fwd`) and `tools/block_bwd_bench.py` (`graph_ms`, `launch_split`), so
a copy of this file placed in another checkout's `tools/` times that
checkout's kernel 8: run it in two checkouts in turns (A, B, B, A) to
compare them on one card.

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench digests

prints the sha256 of kernel 7's error map at the step's two photometric
shapes ((32, 384, 640, 3) and the static stack (8, 384, 640, 3)) and of
kernel 8's dx and dy at the first, on `digest_inputs`: `chip_smoke.py` holds
kernel 7's to the digests the parent checkout printed (PHOTO_FWD_SHA256).

    python -m slowtv_monodepth_tpu_torch.tools.photo_bench variants

builds copies of `csrc/photo_bwd.cu` with one edit each, patched in at build
time (all nvcc runs started together; the library's source carries no such
switches), and times each copy's C entry at the step's shape on each tile
height: the IEEE division and reciprocal (with their slow-path branches) in
place of the tie test and the hardware's reciprocal; launch bounds asking
for 3 blocks an SM (the library's ask for 4); the statistics in rounded
multiplies and adds only (the library fuses some, in one pattern for x and
y); chunks of 4 rows (the library's 2); and timing aids whose results are
wrong (the staging left out; the outputs' stores left out).
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import photo
from .block_bwd_bench import PEAK_BYTES, PEAK_F32_FLOPS, graph_ms, launch_split

W_SSIM = 0.85
RTOL = 1e-5  # chip_smoke.py's PHOTO_BWD_RTOL
STEP = (32, 384, 640, 3)
SHAPES = (STEP, (32, 224, 832, 3), (32, 480, 384, 3))
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


def cost(shape) -> tuple[float, float]:
    """(bytes, float32 operations) of one call: x, y, g in, dx, dy out; 250 per
    pixel and channel."""
    m, h, w, c = shape
    px = m * h * w * c
    return 4 * (4 * px + m * h * w), 250 * px


def rel_err(got, want) -> float:
    scale = max(1.0, max(float(t.abs().max()) for t in want))
    return max(float((u.double() - t).abs().max()) for u, t in zip(got, want)) / scale


def check(fn, x, y, g) -> tuple[float, float]:
    """(kernel's error, tolerance): against the plain version in float64,
    relative to the largest |gradient|."""
    want = photo.photo_bwd_plain(x.double(), y.double(), g.double(), W_SSIM)
    plain32 = rel_err(photo.photo_bwd_plain(x, y, g, W_SSIM), want)
    err = rel_err(fn(), want)
    del want
    torch.cuda.empty_cache()
    return err, RTOL + 2 * plain32


def _entry_call(lib, x, y, g, rows):
    """A call of `lib`'s kernel-8 entry with tiles `rows` high, into outputs
    made once -> (the call, (dx, dy))."""
    m, h, w, c = x.shape
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    tensors = (x, y, g, dx, dy)  # the call keeps them alive

    def call():
        _build.check(getattr(lib, ENTRY)(*(t.data_ptr() for t in tensors), m, h, w, c,
                                         W_SSIM / c, (1 - W_SSIM) / c, rows, x.device.index,
                                         torch.cuda.current_stream().cuda_stream), 'kernel 8')
        return dx, dy
    return call


def _ptxas(log: str) -> None:
    entry = ''
    for line in log.splitlines():
        if 'Compiling entry' in line or 'Function properties for' in line:
            m = re.search(r'photo_bwd_kernel(ILi(\d+)E)?', line)
            entry = f'photo_bwd_kernel<{m.group(2)}>' if m else ''
        elif entry and ('registers' in line or 'stack frame' in line):
            print(f'ptxas {entry}: {line.replace("ptxas info    :", "").strip()}')


def main() -> None:
    build = _build.build()
    lib = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    has_plan = hasattr(photo, 'bwd_plan')
    for shape in SHAPES:
        x, y, g = bench_inputs(shape)
        err, tol = check(lambda: photo.photo_bwd(x, y, g, W_SSIM), x, y, g)
        if not err <= tol:
            raise SystemExit(f'kernel 8 at {shape}: off the plain version in float64 by '
                             f'{err:.2e} of max|grad| (tol {tol:.2e})')
        ms = graph_ms(lambda: photo.photo_bwd(x, y, g, W_SSIM))
        split = launch_split(lambda: photo.photo_bwd(x, y, g, W_SSIM))
        n_bytes, flops = cost(shape)
        bytes_ms, ops_ms = 1e3 * n_bytes / PEAK_BYTES, 1e3 * flops / PEAK_F32_FLOPS
        line = (f'{shape}: kernel 8 {ms:.4f} ms (err {err:.1e}, tol {tol:.1e}); bound '
                f'{max(bytes_ms, ops_ms):.4f} ({max(bytes_ms, ops_ms) / ms:.0%}; bytes '
                f'{bytes_ms:.4f}, operations {ops_ms:.4f}); {n_bytes / ms / 1e9:.2f} TB/s; '
                'launches (profiler): ' + ', '.join(f'{k} {v:.4f}' for k, v in split.items()))
        if has_plan:
            plan = photo.bwd_plan(*shape, sms)
            line += f'; plan {plan} rows; by tile height: ' + ', '.join(
                f'{r} {graph_ms(_entry_call(lib, x, y, g, r)):.4f}' for r in photo.BWD_ROWS)
        if shape == STEP:  # not capturable (host scalars): torch.profiler's device sum
            plain = launch_split(lambda: photo.photo_bwd_plain(x, y, g, W_SSIM))
            line += f'; plain {sum(plain.values()):.4f} (profiler)'
        print(line, flush=True)
        del x, y, g
        torch.cuda.empty_cache()
    _ptxas(build.log or build.path.with_suffix('.log').read_text())


def digest_inputs(shape):
    """Uniform x and y in [0, 1) and g from seed 7, on the card."""
    rs = np.random.RandomState(7)
    return tuple(torch.from_numpy(rs.rand(*s).astype(np.float32)).cuda()
                 for s in (shape, shape, shape[:3]))


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def fwd_digests() -> dict[str, str]:
    """sha256 of kernel 7's map at the step's two photometric shapes, by shape."""
    out = {}
    for m in (32, 8):
        x, y, _ = digest_inputs((m, 384, 640, 3))
        out[str((m, 384, 640, 3))] = sha256(photo.photo_fwd(x, y, W_SSIM))
    return out


def digests() -> None:
    for shape, digest in fwd_digests().items():
        print(f'photo_fwd {shape}: {digest}')
    x, y, g = digest_inputs(STEP)
    dx, dy = photo.photo_bwd(x, y, g, W_SSIM)
    print(f'photo_bwd {STEP}: dx {sha256(dx)}, dy {sha256(dy)}')


SKIP = 'if (a.H < 0) '
BOUNDS = '__launch_bounds__(kMaxThreads, 4) photo_bwd_kernel'
# name -> edits of csrc/photo_bwd.cu (old, new).
VARIANTS = {
    'IEEE division and reciprocal': (
        ('const float rd = __fdividef(1.f, d);', 'const float rd = __frcp_rn(d);'),
        ('const float u = n == d ? 1.f : n * rd;', 'const float u = __fdiv_rn(n, d);')),
    'launch bounds of 3 blocks an SM': ((BOUNDS, BOUNDS.replace(', 4)', ', 3)')),),
    'statistics without fused multiply-adds': (
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
         'const float sr = add(add(sub(m[2], mul(mx, mx)), sub(m[3], mul(my, my))), kC2);')),
    'chunks of 4 rows': (('constexpr int kChunk = 2;', 'constexpr int kChunk = 4;'),),
    'no staging (wrong)': (('stage_row<C>(a, row_base,', SKIP + 'stage_row<C>(a, row_base,'),),
    'no output stores (wrong)': (('if (out_col && oy + i < H) {', 'if (out_col && a.H < 0) {'),),
}


def bench_variants() -> None:
    out = _build.BUILD_DIR / 'photo_bench'
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = out / f'variant_{i}'
        src.mkdir(parents=True, exist_ok=True)
        text = (_build.CSRC / 'photo_bwd.cu').read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'variant {name!r}: {old!r} is not in photo_bwd.cu once')
            text = text.replace(old, new)
        (src / 'photo_bwd.cu').write_text(text)
        path = src / 'kernel8.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(path),
               str(src / 'photo_bwd.cu')]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {'library': _build.load()}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        getattr(lib, ENTRY).argtypes = _build.SIGNATURES[ENTRY]
        libs[name] = lib
        print(f'{name}:')
        _ptxas(log)
    x, y, g = bench_inputs(STEP)
    for name, lib in libs.items():
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
    digests() if mode == ['digests'] else bench_variants() if mode == ['variants'] else main()
