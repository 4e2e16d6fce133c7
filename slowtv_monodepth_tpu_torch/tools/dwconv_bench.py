"""Kernel 1 (the depthwise conv forward) against cuDNN, by device time, on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.dwconv_bench

`csrc/dwconv.cu` is built once per value of the number of blocks its band
height is picked to leave (`-DSLOWTV_DWCONV_TARGET_BLOCKS`; the library's is
1056), all nvcc runs started together. Each build is timed at the block shapes
of a KBR micro-step (ConvNeXt-B at B=4, ConvNeXt-T at B=8, each launched twice
per block: forward and input gradient) and of a ConvNeXt-B forward at B=2 and
B=1, beside cuDNN's depthwise conv (`groups=C`, the plain version) on the same
inputs, float32, 7x7 taps. Times are device times: 20 calls captured into one
CUDA graph, CUDA events around one replay, divided by 20. Each row also gives
the band height the build picks and the byte bound (x read once, out written
once, at 3.35 TB/s). The printed totals weight each shape by its launches.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from .. import _build
from ..ops.dwconv import depthwise_conv_plain

TARGETS = (132, 264, 528, 1056, 2112)
ENTRY = 'slowtv_dwconv_fwd_f32'
PEAK_BYTES = 3.35e12
# (b, h, w, c, launches): the micro-step's blocks x 2, then the forwards.
CASES = {'KBR micro-step (108 launches)': [
    (4, 96, 160, 128, 6), (4, 48, 80, 256, 6), (4, 24, 40, 512, 54), (4, 12, 20, 1024, 6),
    (8, 96, 160, 96, 6), (8, 48, 80, 192, 6), (8, 24, 40, 384, 18), (8, 12, 20, 768, 6)],
    'ConvNeXt-B forward, B=2 (36 launches)': [
    (2, 96, 160, 128, 3), (2, 48, 80, 256, 3), (2, 24, 40, 512, 27), (2, 12, 20, 1024, 3)],
    'ConvNeXt-B forward, B=1 (36 launches)': [
    (1, 96, 160, 128, 3), (1, 48, 80, 256, 3), (1, 24, 40, 512, 27), (1, 12, 20, 1024, 3)]}


def _build_targets() -> dict:
    out = _build.BUILD_DIR / 'dwconv_bench'
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / 'dwconv.cu'
    procs = {}
    for t in TARGETS:
        path = out / f'dwconv_{t}.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f'-DSLOWTV_DWCONV_TARGET_BLOCKS={t}', '-shared',
               '-o', str(path), str(src)]
        procs[t] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for t, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        getattr(lib, ENTRY).argtypes = _build.SIGNATURES[ENTRY]
        libs[t] = lib
    return libs


def _graph_ms(fn, iters: int = 20) -> float:
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            for _ in range(iters):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rows(b: int, h: int, w: int, c: int, target: int) -> int:
    """The band height `launch_fwd` picks for float4 channels at K = 7."""
    items_per_block, strip = 8, 4
    chunks, strips = -(-c // 32), -(-w // strip)
    rows = h
    while rows > 1 and chunks * -(-(b * -(-h // rows) * strips) // items_per_block) < target:
        rows -= 1
    return rows if rows >= 4 else 1


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('dwconv_bench needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    libs = _build_targets()
    rs = np.random.RandomState(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    print(f'{torch.cuda.get_device_name(0)}; device ms per launch (graph replay of 20)')
    for title, cases in CASES.items():
        totals = dict.fromkeys([*TARGETS, 'cudnn', 'bound'], 0.0)
        print(f'\n{title}')
        print('(b, h, w, c) x launches | ' + ' | '.join(f'{t} blocks (rows)' for t in TARGETS)
              + ' | cuDNN | bound')
        for b, h, w, c, n in cases:
            x = torch.from_numpy(rs.standard_normal((b, h, w, c)).astype(np.float32)).cuda()
            wt = torch.from_numpy((rs.standard_normal((c, 1, 7, 7)) / 7).astype(np.float32)).cuda()
            bias = torch.from_numpy(0.1 * rs.standard_normal(c).astype(np.float32)).cuda()
            out = torch.empty_like(x)
            want = depthwise_conv_plain(x.double(), wt.double(), bias.double())
            cells = []
            for t, lib in libs.items():
                def call(lib=lib):
                    _build.check(getattr(lib, ENTRY)(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                                                     out.data_ptr(), b, h, w, c, 7, 0, stream()),
                                 'dwconv kernel')
                call()
                torch.cuda.synchronize()
                err = float((out.double() - want).abs().max())
                if not err <= 1e-5:
                    raise SystemExit(f'{(b, h, w, c)} at {t} blocks: off by {err:.2e}')
                ms = _graph_ms(call)
                totals[t] += n * ms
                cells.append(f'{ms:.5f} ({_rows(b, h, w, c, t)})')
            ms = _graph_ms(lambda: depthwise_conv_plain(x, wt, bias))
            bound = 1e3 * 4 * (2 * x.numel() + 50 * c) / PEAK_BYTES
            totals['cudnn'] += n * ms
            totals['bound'] += n * bound
            print(f'{(b, h, w, c)} x{n} | ' + ' | '.join(cells) + f' | {ms:.5f} | {bound:.5f}')
        print('total ms | ' + ' | '.join(f'{totals[t]:.4f}' for t in TARGETS)
              + f' | {totals["cudnn"]:.4f} | {totals["bound"]:.4f}')


if __name__ == '__main__':
    main()
