"""Where the fused ConvNeXt block kernel's time goes, on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.block_kernel_bench

Two tables at the eight ConvNeXt-B block shapes of a 384x640 request (B=1)
and batch (B=4), float32:
1. parts: `csrc/convnext_block.cu` built four more times with one part left
   out by its timing aids (`-DK9_NO_TAPS`, `-DK9_NO_FMA`, `-DK9_NO_STREAM`,
   and the last two together), at the tile and cluster `tile_pixels` picks;
   the differences say what the 49 taps, the FMA loops and the weight tiles'
   trip through registers and barriers cost. Such a build computes nonsense:
   only its time is read.
2. tiles: the library's kernel at every (pixels per tile, blocks per cluster)
   pair that fits, beside the pair `tile_pixels` picks, its plain version and
   its bound (float32 operations at 67 TFLOP/s).
Times are CUDA-event means over 10 back-to-back launches after 2 warm ones.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from .. import _build
from ..ops import convnext_block as cb

STAGES = ((96, 160, 128), (48, 80, 256), (24, 40, 512), (12, 20, 1024))
PARTS = {'whole': (), 'no taps': ('-DK9_NO_TAPS',), 'no FMA': ('-DK9_NO_FMA',),
         'no stream': ('-DK9_NO_STREAM',), 'no FMA, no stream': ('-DK9_NO_FMA', '-DK9_NO_STREAM')}
ENTRY = 'slowtv_convnext_block_fwd_f32'


def _build_parts() -> dict:
    """One shared library per entry of `PARTS`, all nvcc runs started together."""
    out = _build.BUILD_DIR / 'block_kernel_bench'
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / 'convnext_block.cu'
    procs = {}
    for i, (name, flags) in enumerate(PARTS.items()):
        path = out / f'part_{i}.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, '-shared', '-o', str(path), str(src)]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        getattr(lib, ENTRY).argtypes = _build.SIGNATURES[ENTRY]
        libs[name] = lib
    return libs


def _args(rs, b, h, w, c) -> tuple:
    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()
    return (rand(b, h, w, c), rand(c, 1, 7, 7, scale=1 / 7), rand(c, scale=0.1),
            1 + rand(c, scale=0.1), rand(c, scale=0.1), rand(4 * c, c, scale=c ** -0.5),
            rand(4 * c, scale=0.1), rand(c, 4 * c, scale=(4 * c) ** -0.5), rand(c, scale=0.1),
            rand(c, scale=0.5))


def _launch(lib, args, m: int, s: int) -> torch.Tensor:
    x = args[0]
    out = torch.empty_like(x)
    err = getattr(lib, ENTRY)(*(t.data_ptr() for t in args), out.data_ptr(), *x.shape, m, s, 0,
                              x.device.index, torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'convnext-block kernel')
    return out


def _ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('block_kernel_bench needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    parts, lib = _build_parts(), _build.load()
    rs = np.random.RandomState(0)
    cases = [((b, h, w, c), _args(rs, b, h, w, c)) for b in (1, 4) for h, w, c in STAGES]

    print('parts: ms with one part of the kernel compiled out')
    for shape, args in cases:
        m, s = cb.tile_pixels(shape[0] * shape[1] * shape[2], shape[3])
        times = {name: _ms(lambda: _launch(part, args, m, s)) for name, part in parts.items()}
        print(f'  {shape} tile {m} x {s}: ' + ', '.join(f'{k} {v:.4f}' for k, v in times.items())
              + f'; taps {times["whole"] - times["no taps"]:.4f}, weight tiles\' trip '
              f'{times["whole"] - times["no stream"]:.4f}')

    print('tiles: ms per (pixels per tile, blocks per cluster)')
    for shape, args in cases:
        pixels, c = shape[0] * shape[1] * shape[2], shape[3]
        want = cb.fused_convnext_block_plain(*(t.double() for t in args))
        err = float((cb.fused_convnext_block(*args).double() - want).abs().max() / want.abs().max())
        line = (f'  {shape}: bound {16e3 * pixels * c * c / 67e12:.4f}, plain '
                f'{_ms(lambda: cb.fused_convnext_block_plain(*args)):.4f}, picked '
                f'{cb.tile_pixels(pixels, c)} {_ms(lambda: cb.fused_convnext_block(*args)):.4f} '
                f'(err {err:.1e} of max|y|);')
        for m in (8, 16, 32):
            for s in (1, 2, 4, 8):
                if cb._smem_bytes(m, c) <= cb._SMEM and (s - 1) * 256 < 4 * c:
                    line += f' ({m}, {s}) {_ms(lambda: _launch(lib, args, m, s)):.3f}'
        print(line)


if __name__ == '__main__':
    main()
