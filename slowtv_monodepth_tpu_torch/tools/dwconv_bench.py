"""Kernels 1 and 2 (the depthwise conv and its tap gradient) against cuDNN, by
device time, on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.dwconv_bench [1] [2] [wrapper]

Kernel 1 (`1`): `csrc/dwconv.cu` is built once per value of the number of blocks its band
height is picked to leave (`-DSLOWTV_DWCONV_TARGET_BLOCKS`; the library's is
1056), all nvcc runs started together. Each build is timed at the block shapes
of a KBR micro-step (ConvNeXt-B at B=4, ConvNeXt-T at B=8, each launched twice
per block: forward and input gradient) and of a ConvNeXt-B forward at B=2 and
B=1, beside cuDNN's depthwise conv (`groups=C`, the plain version) on the same
inputs, float32, 7x7 taps. Times are device times: 20 calls captured into one
CUDA graph, CUDA events around one replay, divided by 20. Each row also gives
the band height the build picks and the byte bound (x read once, out written
once, at 3.35 TB/s). The printed totals weight each shape by its launches.

Kernel 2 (`2`), the tap gradient, at the eight block shapes of a KBR
micro-step (54 launches: one per block), through its C entry, beside cuDNN's
weight gradient (the plain version `dwconv_dw_plain`) and the byte bound (x
and g read once, the taps written once). `csrc/dwconv.cu` is built as the
library builds it and as copies with one edit each, patched in at build time:
4 warps a block; no staging (the tiles' arithmetic on whatever shared memory
holds); no arithmetic (staging and the sums alone); neither (launches,
barriers and the sums of partials). Each build runs the library's plan
(`ops.dwconv.dw_plan`); the library's build also runs plans of tiles of at
most 8, 6 and 4 rows, a second wave ('132 blocks') and one partial per
group. The library's build and the 4-warp one are held to float64 within
1e-5 on every plan, and two calls must be bitwise equal.

`wrapper` times `ops.dwconv.dwconv_dw` alone at the same eight shapes, as a
user calls it. Of the package it uses only `dwconv_dw` and `dwconv_dw_plain`,
so a copy of this file placed in another checkout's `tools/` times that
checkout's kernel 2: run it in two checkouts in turns (A, B, B, A) to compare
them on one card.

With no argument it runs `1` and `2`.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import dwconv

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


# Kernel 2: the micro-step's block shapes, each launched once per block.
DW_CASES = [(b, h, w, c, n // 2) for b, h, w, c, n in CASES['KBR micro-step (108 launches)']]


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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def bench_forward() -> None:
    libs = _build_targets()
    rs = np.random.RandomState(0)
    stream = _stream
    print(f'{torch.cuda.get_device_name(0)}; kernel 1, device ms per launch (graph replay of 20)')
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
            want = dwconv.depthwise_conv_plain(x.double(), wt.double(), bias.double())
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
            ms = _graph_ms(lambda: dwconv.depthwise_conv_plain(x, wt, bias))
            bound = 1e3 * 4 * (2 * x.numel() + 50 * c) / PEAK_BYTES
            totals['cudnn'] += n * ms
            totals['bound'] += n * bound
            print(f'{(b, h, w, c)} x{n} | ' + ' | '.join(cells) + f' | {ms:.5f} | {bound:.5f}')
        print('total ms | ' + ' | '.join(f'{totals[t]:.4f}' for t in TARGETS)
              + f' | {totals["cudnn"]:.4f} | {totals["bound"]:.4f}')


def _dw_inputs(rs, b, h, w, c):
    """x and a cotangent scaled so that the taps are O(1)."""
    x = torch.from_numpy(rs.standard_normal((b, h, w, c)).astype(np.float32)).cuda()
    g = torch.from_numpy((rs.standard_normal((b, h, w, c)) / np.sqrt(b * h * w))
                         .astype(np.float32)).cuda()
    return x, g


def _build_variants(variants: dict) -> dict:
    """Builds `csrc/dwconv.cu` with each variant's text replacements, all nvcc
    runs started together -> name: its C entry `slowtv_dwconv_dw_f32`."""
    out = _build.BUILD_DIR / 'dwconv_bench'
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / 'dwconv.cu').read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f'{name}: {old!r} is not in csrc/dwconv.cu once')
            src = src.replace(old, new)
        cu, path = out / f'dwconv_dw_{i}.cu', out / f'dwconv_dw_{i}.so'
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f'-I{_build.CSRC}', '-shared', '-o', str(path),
               str(cu)]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        regs = sorted(set(re.findall(r'dwconv_dw_tile_kernelILi7ELi4E.*?Used (\d+) registers',
                                     log, re.S)))
        print(f'{name}: K=7 float4 instance {regs} registers')
        fn = getattr(ctypes.CDLL(str(path)), 'slowtv_dwconv_dw_f32')
        fn.argtypes, fn.restype = _build.SIGNATURES['slowtv_dwconv_dw_f32'], ctypes.c_int
        entries[name] = fn
    return entries


# Kernel 2's builds: the library's source, and copies with one edit each.
_NO_STAGE = [(line, '') for line in (
    '    stage_rows<V, XC>(xs, x + img, y0 - P, nr + K - 1, x0 - P, H, W, C, C - c0);\n',
    '    stage_rows<V, kDwCols>(xs + (rows + K - 1) * XR, g + img, y0, nr, x0, H, W, C, C - c0);\n')]
_NO_MATH = [('for (int r = warp; r < nr; r += kDwWarps)', 'for (int r = warp; r < 0; r += kDwWarps)')]
DW_BUILDS = {'library': [], '4 warps': [('constexpr int kDwWarps = 8;', 'constexpr int kDwWarps = 4;')],
             'no staging': _NO_STAGE, 'no arithmetic': _NO_MATH, 'neither': _NO_STAGE + _NO_MATH}


def _dw_plans(b: int, h: int, w: int, c: int, sms: int) -> dict:
    """name -> (build, plan): the library's plan (`dw_plan`) on every build;
    on the library's build also tiles of at most 8, 6 and 4 rows, a second
    wave to give at least one block per SM where the tiles allow ('132
    blocks'), and one cluster of all of a group's blocks where they are 8 or
    fewer ('one partial': no second launch)."""
    rows, splits, cluster = plan = dwconv.dw_plan(b, h, w, c, 7, sms)
    plans = {name: (name, plan) for name in DW_BUILDS}
    for most in (8, 6, 4):
        r = -(-h // -(-h // most))
        plans[f'rows <= {most}'] = ('library', (r, *dwconv.dw_split(b, h, w, c, 7, r, sms)))
    tiles = b * -(-h // rows) * -(-w // 20)
    plans['132 blocks'] = ('library', (rows, max(splits, min(tiles, -(-sms // -(-c // 32)))), 1))
    plans['one partial'] = ('library', (rows, splits, splits if splits <= 8 else cluster))
    return plans


def bench_tap_gradient() -> None:
    entries = _build_variants(DW_BUILDS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rs = np.random.RandomState(1)
    names = list(_dw_plans(1, 1, 1, 1, sms))
    print(f'\n{torch.cuda.get_device_name(0)} ({sms} SMs); kernel 2 (tap gradient), KBR '
          'micro-step (54 launches), device ms per call (graph replay of 20) and plan (rows, '
          'splits, cluster)')
    print('(b, h, w, c) x launches | ' + ' | '.join(names) + ' | cuDNN | bound')
    totals = dict.fromkeys([*names, 'cudnn', 'bound'], 0.0)
    for b, h, w, c, n in DW_CASES:
        x, g = _dw_inputs(rs, b, h, w, c)
        want = dwconv.dwconv_dw_plain(x.double(), g.double(), 7)
        cells = []
        for name, (build, plan) in _dw_plans(b, h, w, c, sms).items():
            out = torch.empty((c, 1, 7, 7), device='cuda')
            partial = torch.empty((plan[1] // plan[2], c, 49), device='cuda')

            def call(entry=entries[build], plan=plan, out=out, partial=partial):
                _build.check(entry(x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                   b, h, w, c, 7, *plan, 0, _stream()), 'dwconv tap-gradient kernel')
                return out

            first = call().clone()
            torch.cuda.synchronize()
            if build in ('library', '4 warps'):  # the others leave out part of the work
                err = float((first.double() - want).abs().max())
                if not err <= 1e-5:
                    raise SystemExit(f'{(b, h, w, c)}, {name} {plan}: off by {err:.2e}')
                if not torch.equal(call(), first):
                    raise SystemExit(f'{(b, h, w, c)}, {name} {plan}: two calls differ')
            ms = _graph_ms(call)
            totals[name] += n * ms
            cells.append(f'{ms:.5f} {plan}')
        ms = _graph_ms(lambda: dwconv.dwconv_dw_plain(x, g, 7))
        bound = 1e3 * 4 * (2 * x.numel() + 49 * c) / PEAK_BYTES
        totals['cudnn'] += n * ms
        totals['bound'] += n * bound
        print(f'{(b, h, w, c)} x{n} | ' + ' | '.join(cells) + f' | {ms:.5f} | {bound:.5f}')
    print('total ms | ' + ' | '.join(f'{totals[k]:.4f}' for k in totals))


def bench_wrapper() -> None:
    rs = np.random.RandomState(1)
    total = 0.0
    print(f'{torch.cuda.get_device_name(0)}; ops.dwconv.dwconv_dw ({dwconv.__file__}), '
          'device ms per call (graph replay of 20)')
    for b, h, w, c, n in DW_CASES:
        x, g = _dw_inputs(rs, b, h, w, c)
        want = dwconv.dwconv_dw_plain(x.double(), g.double(), 7)
        err = float((dwconv.dwconv_dw(x, g, 7).double() - want).abs().max())
        if not err <= 1e-5:
            raise SystemExit(f'{(b, h, w, c)}: off by {err:.2e}')
        ms = _graph_ms(lambda: dwconv.dwconv_dw(x, g, 7))
        total += n * ms
        print(f'{(b, h, w, c)} x{n}: {ms:.5f}')
    print(f'KBR micro-step (54 launches): {total:.4f} ms')


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('dwconv_bench needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    what = sys.argv[1:] or ['1', '2']
    if 'wrapper' in what:
        bench_wrapper()
    if '1' in what:
        bench_forward()
    if '2' in what:
        bench_tap_gradient()


if __name__ == '__main__':
    main()
