"""Kernels 5 and 6 (the warp on float32 and on bfloat16 sources) on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.warp_bench

Kernel 5 (`ops.sample.warp_bilinear` on a float32 source) and kernel 6 (the
same on the source rounded to bfloat16) at:
- the KBR micro-step's view-synthesis stack (2 supports x 4 scales x B=4,
  384x640, RGB: (32, 384, 640, 3)) at near-identity coords (x + 2 + N(0, 1),
  y + N(0, 1/4), clamped: `chip_smoke.py`'s);
- the aspect-ratio augmentation's resamples of the training run: the B=4
  targets and the 2 x 4 supports, (4 or 8, 720, 1280, 3), onto the buckets of
  two centre crops (345x1141 -> 224x832, 620x496 -> 480x384), at the coords
  `core.aspect_ratio.crop_grid` gives.
Inputs are made from a seed with numpy. For each call:
- its device time per call, 10 calls captured into one CUDA graph, CUDA
  events around one replay, divided by 10; each output held against the
  plain version in float64 within `chip_smoke.py`'s WARP_ATOL;
- its bound: the bytes it must move (the source, 8 bytes of coords a pixel
  and the three float32 outputs, each once) at 3.35 TB/s, as `chip_smoke.py`
  counts them, and the same with only the source pixels that the coords
  touch (a resample reads only its crop of the source);
- the same timing of the plain version (at the step's stack) and of
  `F.grid_sample` (border mode, the sample only: not the same function,
  since it gives no ddx, ddy; on the source widened in the call for kernel 6).
It ends with the `ptxas` lines (registers, stack frame, spills) of the
warp kernels in the build log.

Of the package it uses only `ops.sample`, `core.aspect_ratio` and
`tools/block_bwd_bench.py` (`graph_ms`), so a copy of this file placed in
another checkout's `tools/` times that checkout's kernels: run it in two
checkouts in turns (A, B, B, A) to compare them on one card.

    python -m slowtv_monodepth_tpu_torch.tools.warp_bench digests

prints the sha256 of out, ddx and ddy of both kernels at the step's stack
and at the supports' resample onto 224x832, on `digest_inputs`:
`chip_smoke.py` holds the kernels to the digests the parent checkout of
their redesign printed (WARP_SHA256).

    python -m slowtv_monodepth_tpu_torch.tools.warp_bench variants

builds copies of `csrc/warp.cu` with one edit each, patched in at build
time (all nvcc runs started together; the library's source carries no such
switches), and times both of each copy's C entries at the step's stack, with
the outputs' sha256 against the library's: runs of 256 or 1024 pixels a
block (C or 4 C floats a thread; the library's 512: 2 C), the coords read
float by float (no 16-byte loads), launch bounds asking for 8 blocks an SM.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..core.aspect_ratio import crop_grid, sample_resize
from ..ops import sample
from .block_bwd_bench import PEAK_BYTES, graph_ms

ATOL = 1e-5  # chip_smoke.py's WARP_ATOL
STEP = (32, 384, 640, 3)
SOURCE = (720, 1280)        # SlowTV's native frames
CROPS = ((345, 1141), (620, 496))  # chip_smoke.RUN_CROPS: buckets 224x832 and 480x384
REF_SHAPE = (384, 640)      # the recipe's aspect_ratio_ref_shape
ENTRIES = {'warp': 'slowtv_warp_bilinear_f32', 'warp_packed': 'slowtv_warp_bilinear_packed_bf16'}


def step_inputs(seed: int = 0):
    """(img, fx, fy) of the step's stack: img uniform in [0, 1), near-identity coords."""
    rs = np.random.RandomState(seed)
    m, h, w, c = STEP
    img = rs.rand(m, h, w, c).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing='ij')
    fx = np.clip(xs + 2 + rs.standard_normal((m, h, w)).astype(np.float32), 0, w - 1)
    fy = np.clip(ys + 0.5 * rs.standard_normal((m, h, w)).astype(np.float32), 0, h - 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32)).cuda()
                 for t in (img, fx, fy))


def resample_inputs(b: int, crop, seed: int = 0):
    """(img, fx, fy): a (b, 720, 1280, 3) source uniform in [0, 1) and the
    coords of its centre crop `crop` resized onto the run's bucket for it."""
    rs = np.random.RandomState(seed)
    img = torch.from_numpy(rs.rand(b, *SOURCE, 3).astype(np.float32)).cuda()
    bucket = sample_resize(crop, REF_SHAPE, eps=0.8)
    # The coords on the CPU, so that they are the same bits on any card.
    grid = crop_grid(torch.empty((1, *SOURCE, 3)), crop, bucket)
    fx, fy = sample.border_coords(grid, *SOURCE)
    return img, fx.expand(b, -1, -1).contiguous().cuda(), fy.expand(b, -1, -1).contiguous().cuda()


def cases():
    """(name, thunk of (img, fx, fy)) of every shape the bench times."""
    out = [(f'step {STEP} near-identity', step_inputs)]
    for crop in CROPS:
        for b in (4, 8):
            bucket = sample_resize(crop, REF_SHAPE, eps=0.8)
            out.append((f'AR-aug ({b}, {SOURCE[0]}, {SOURCE[1]}, 3) crop {crop} -> {bucket}',
                        lambda b=b, crop=crop: resample_inputs(b, crop)))
    return out


def cost_bytes(img: torch.Tensor, fx: torch.Tensor, src_pixels: int | None = None) -> int:
    """The source (its own dtype; `src_pixels` of it where given, else all),
    the coords and the three float32 outputs, each once."""
    b, h, w, c = img.shape
    src = (b * h * w if src_pixels is None else src_pixels) * c * img.element_size()
    return src + 4 * (2 * fx.numel() + 3 * fx.numel() * c)


def touched_pixels(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> int:
    """The source pixels that some output's four corners read."""
    b, h, w, _ = img.shape
    x0 = fx.floor().long().clamp(0, w - 1)
    y0 = fy.floor().long().clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    base = (torch.arange(b, device=fx.device) * (h * w))[:, None, None]
    seen = torch.zeros(b * h * w, dtype=torch.bool, device=fx.device)
    for y in (y0, y1):
        for x in (x0, x1):
            seen[(base + y * w + x).reshape(-1)] = True
    return int(seen.sum())


def _err(got, im, fx, fy) -> float:
    want = sample.warp_bilinear_plain(im.double(), fx.double(), fy.double())
    err = max(float((g.double() - t).abs().max()) for g, t in zip(got, want))
    del want
    torch.cuda.empty_cache()
    return err


def library_call(im, fx, fy):
    """`F.grid_sample` (border mode) on the same samples: the sample only."""
    h, w = im.shape[1:3]
    grid = torch.stack([(2 * fx + 1) / w - 1, (2 * fy + 1) / h - 1], -1)
    return lambda: F.grid_sample(im.float().permute(0, 3, 1, 2), grid, mode='bilinear',
                                 padding_mode='border', align_corners=False)


def bench() -> None:
    total = {'warp': 0.0, 'warp_packed': 0.0}
    for name, make in cases():
        img, fx, fy = make()
        for kernel, im in (('warp', img), ('warp_packed', img.to(torch.bfloat16))):
            got = sample.warp_bilinear(im, fx, fy)
            err = _err(got, im, fx, fy)
            del got
            if not err <= ATOL:
                raise SystemExit(f'{kernel} at {name}: off the plain version in float64 by '
                                 f'{err:.2e} (tol {ATOL:.0e})')
            ms = graph_ms(lambda: sample.warp_bilinear(im, fx, fy))
            n_bytes = cost_bytes(im, fx)
            bound = 1e3 * n_bytes / PEAK_BYTES
            touched = touched_pixels(im, fx, fy)
            needed = 1e3 * cost_bytes(im, fx, touched) / PEAK_BYTES
            line = (f'{kernel} {name}: {ms:.4f} ms (err {err:.1e}); bound {bound:.4f} (bytes); '
                    f'{bound / ms:.0%} of it; {n_bytes / ms / 1e9:.2f} TB/s; on the '
                    f'{touched / (im.numel() // im.shape[3]):.1%} of the source it reads: bound '
                    f'{needed:.4f}, {needed / ms:.0%} of it; F.grid_sample '
                    f'{graph_ms(library_call(im, fx, fy)):.4f}')
            if name.startswith('step'):
                total[kernel] = ms
                line += f'; plain {graph_ms(lambda: sample.warp_bilinear_plain(im, fx, fy)):.4f}'
            print(line, flush=True)
            torch.cuda.empty_cache()
        del img, fx, fy
        torch.cuda.empty_cache()
    print('per KBR micro-step (one launch at the step\'s stack): '
          + ', '.join(f'{k} {v:.4f} ms' for k, v in total.items()), flush=True)


def _ptxas(log: str) -> None:
    """The build log's ptxas lines of every warp kernel instance."""
    entry = ''
    for line in log.splitlines():
        if 'Compiling entry' in line or 'Function properties for' in line:
            m = re.search(r'(warp_bilinear(?:_packed)?_kernel)(?:I([ft])Li(\d+)E)?', line)
            entry = '' if m is None else m.group(1) + (
                f'<{"float" if m.group(2) == "f" else "unsigned short"}, {m.group(3)}>'
                if m.group(2) else '')
        elif entry and ('registers' in line or 'stack frame' in line):
            print(f'ptxas {entry}: {line.replace("ptxas info    :", "").strip()}')


def main() -> None:
    build = _build.build()
    bench()
    _ptxas(build.log or build.path.with_suffix('.log').read_text())


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def digest_inputs():
    """(case, (img, fx, fy)) of the digests: the step's stack and the 2 x 4
    supports' resample onto 224x832, from seed 7."""
    return (('step', step_inputs(7)), ('resample', resample_inputs(8, CROPS[0], 7)))


def digests(warp=None) -> dict[str, str]:
    """'kernel case output' -> sha256 of each output of kernels 5 and 6 (the
    source rounded to bfloat16) on `digest_inputs`; `warp(entry, img, fx,
    fy)` in place of the library's wrappers where given."""
    out = {}
    for case, (img, fx, fy) in digest_inputs():
        for kernel, im in (('warp', img), ('warp_packed', img.to(torch.bfloat16))):
            got = warp(ENTRIES[kernel], im, fx, fy) if warp else sample.warp_bilinear(im, fx, fy)
            for name, t in zip(('out', 'ddx', 'ddy'), got):
                out[f'{kernel} {case} {name}'] = sha256(t)
    return out


def _entry_call(lib, entry, img, fx, fy):
    """A call of `lib`'s C entry `entry` into outputs made once."""
    b, h, w, c = img.shape
    ho, wo = fx.shape[1:]
    outs = tuple(torch.empty((b, ho, wo, c), device=img.device) for _ in range(3))

    def call():
        _build.check(getattr(lib, entry)(*(t.data_ptr() for t in (img, fx, fy, *outs)), b, h,
                                         w, c, ho, wo, img.device.index,
                                         torch.cuda.current_stream().cuda_stream), entry)
        return outs
    return call


PIXELS = 'constexpr int kPixels = 512;'
# name -> edits (old, new) of warp.cu.
VARIANTS = {
    'runs of 256 pixels (C floats a thread)': ((PIXELS, PIXELS.replace('512', '256')),),
    'runs of 1024 pixels (4 C floats a thread)': ((PIXELS, PIXELS.replace('512', '1024')),),
    'coords float by float': (('a.vec = aligned16(fx)', 'a.vec = false && aligned16(fx)'),),
    'launch bounds of 8 blocks an SM': (('__launch_bounds__(kThreads) warp_bilinear_kernel',
                                         '__launch_bounds__(kThreads, 8) warp_bilinear_kernel'),),
}


def _build_variants() -> dict:
    """name -> ctypes library of each VARIANTS copy, all nvcc runs started together."""
    out = _build.BUILD_DIR / 'warp_bench'
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = out / f'variant_{i}'
        src.mkdir(parents=True, exist_ok=True)
        text = (_build.CSRC / 'warp.cu').read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'variant {name!r}: {old!r} is not in warp.cu once')
            text = text.replace(old, new)
        (src / 'warp.cu').write_text(text)
        path = src / 'warp.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(path), str(src / 'warp.cu')]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES.values():
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        libs[name] = lib
        print(f'{name}:')
        _ptxas(log)
    return libs


def bench_variants() -> None:
    libs = {'library': _build.load(), **_build_variants()}
    want = digests()
    img, fx, fy = step_inputs()
    for name, lib in libs.items():
        same = digests(lambda entry, *args: _entry_call(lib, entry, *args)()) == want
        line = []
        for kernel, im in (('warp', img), ('warp_packed', img.to(torch.bfloat16))):
            call = _entry_call(lib, ENTRIES[kernel], im, fx, fy)
            err = _err(call(), im, fx, fy)
            if not err <= ATOL:
                raise SystemExit(f'{name} {kernel}: off the plain version by {err:.2e}')
            line.append(f'{kernel} {graph_ms(call):.4f} ms')
        print(f'{name} {STEP}: ' + ', '.join(line) + f'; the library\'s bits: {same}', flush=True)


if __name__ == '__main__':
    if not torch.cuda.is_available():
        raise SystemExit('warp_bench needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    mode = sys.argv[1:]
    if mode == ['digests']:
        for key, digest in digests().items():
            print(f'{key}: {digest}')
    elif mode == ['variants']:
        bench_variants()
    else:
        main()
