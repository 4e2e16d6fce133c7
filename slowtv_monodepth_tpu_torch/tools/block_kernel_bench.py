"""Kernel 9 (the fused ConvNeXt block's forward) launch by launch, on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.block_kernel_bench

At the ConvNeXt-B block shapes of a 384x640 request at B=1 and at B=4 (36
blocks each) and the eight block shapes of a KBR micro-step (ConvNeXt-B at
B=4, ConvNeXt-T at B=8; 54 blocks), float32:
- kernel 9 (`ops.convnext_block.fused_convnext_block`, one C entry that makes
  several CUDA launches): its device time per call, 10 calls captured into
  one CUDA graph, CUDA events around one replay, divided by 10, beside its
  bound (16 C^2 + 98 C float32 operations per pixel at 67 TFLOP/s, or x in, y
  out and the parameters at 3.35 TB/s, whichever is larger);
- the split of that time between its CUDA launches: `torch.profiler`'s
  device time per kernel name over 10 eager calls, divided by 10;
- both summed per request and per micro-step, each shape weighted by its
  blocks;
- kernel 10 (`tools/block_bwd_bench.py`'s `kernel10`) per micro-step, timed
  the same way: it shares kernel 9's product core.
It ends with the `ptxas` lines (registers, stack frame, spills) of the
kernel-9 instances in the build log.

Of the package it uses only `ops.convnext_block.fused_convnext_block` and
`tools/block_bwd_bench.py` (its timers and kernel 10's call), so a copy of
this file and of `block_bwd_bench.py` placed in another checkout's `tools/`
times that checkout's kernels 9 and 10: run it in two checkouts in turns
(A, B, B, A) to compare them on one card.

    python -m slowtv_monodepth_tpu_torch.tools.block_kernel_bench variants

builds `csrc/convnext_block.cu` as the library does and as copies of it and
of `csrc/convnext_common.cuh` with one edit each, patched in at build time
(all nvcc runs started together; the library's sources carry no such
switches), and times each copy's C entry at the shapes of a request at B=1
and of the micro-step in the same way, on the library's plan
(`ops.convnext_block.fwd_plan`) or on another plan: other ring lengths,
other splits, another prep tile, and timing aids whose results are
wrong: the products' FMAs left out, their staging copies left out, fc1's
GELU left out, the prep's taps left out, the prep's weight transposes left
out. The others' outputs are held to the plain version in float64 within
5e-6 of max|y|.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import convnext_block as cb
from .block_bwd_bench import (PEAK_BYTES, PEAK_F32_FLOPS, STEP_BLOCKS, graph_ms, kernel10,
                              launch_split)
from .block_bwd_bench import block_args as bwd_block_args

CONVNEXT_B = ((96, 160, 128, 3), (48, 80, 256, 3), (24, 40, 512, 27), (12, 20, 1024, 3))
RTOL = 5e-6  # chip_smoke.py's BLOCK_RTOL


def block_args(rs, b, h, w, c) -> tuple:
    """x and the block's nine parameters on the card, fan-in scaled."""
    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()
    return (rand(b, h, w, c), rand(c, 1, 7, 7, scale=1 / 7), rand(c, scale=0.1),
            1 + rand(c, scale=0.1), rand(c, scale=0.1), rand(4 * c, c, scale=c ** -0.5),
            rand(4 * c, scale=0.1), rand(c, 4 * c, scale=(4 * c) ** -0.5), rand(c, scale=0.1),
            rand(c, scale=0.5))


def bound_ms(b, h, w, c) -> float:
    """Kernel 9's bound: the two products and the taps (16 C^2 + 98 C float32
    operations per pixel), or x in, y out and the parameters once, whichever
    takes longer."""
    p = b * h * w
    flops = 16 * p * c * c + 98 * p * c
    return 1e3 * max(flops / PEAK_F32_FLOPS, 4 * (2 * p * c + 8 * c * c + 58 * c) / PEAK_BYTES)


def _err(y, args) -> float:
    want = cb.fused_convnext_block_plain(*(t.double() for t in args))
    return float((y.double() - want).abs().max() / want.abs().max())


ENTRY = 'slowtv_convnext_block_fwd_f32'
# name -> (edits of csrc/convnext_block.cu or csrc/convnext_common.cuh, (file,
# old, new) each; the plan from the library's plan (m, split1, split2)).
VARIANTS = {
    'library': ((), None),
    'no splits': ((), lambda m, s1, s2: (m, 1, 1)),
    'splits at most 4': ((), lambda m, s1, s2: (m, min(s1, 4), min(s2, 4))),
    'splits of powers of 2': ((), lambda m, s1, s2: (m, 1 << (s1.bit_length() - 1),
                                                     1 << (s2.bit_length() - 1))),
    'prep tile 8': ((), lambda m, s1, s2: (8, s1, s2)),
    'prep tile 32': ((), lambda m, s1, s2: (32, s1, s2)),
    'fc1 ring of 3': ((('convnext_block.cu', 'constexpr int kFc1Stages = 2;',
                        'constexpr int kFc1Stages = 3;'),), None),
    'fc2 ring of 2': ((('convnext_block.cu', 'constexpr int kFc2Stages = 3;',
                        'constexpr int kFc2Stages = 2;'),), None),
    'prep without taps (wrong)': ((('convnext_block.cu',
                                    '  taps_tile(x, dww, dwb, u, ldu, p0, pixels, M, H, W, C);',
                                    ''),), None),
    'prep without transposes (wrong)': ((('convnext_block.cu',
                                          '    const int b = blockIdx.x - tiles, per',
                                          '    if (tiles > 0) return;\n'
                                          '    const int b = blockIdx.x - tiles, per'),), None),
    'fc1 without GELU (wrong)': ((('convnext_block.cu',
                                   'gelu(v.x + bias, approximate), gelu(v.y + bias, approximate),\n'
                                   '                        gelu(v.z + bias, approximate), '
                                   'gelu(v.w + bias, approximate)',
                                   'v.x + bias, v.y + bias, v.z + bias, v.w + bias'),), None),
    'no FMA (wrong)': ((('convnext_common.cuh', '    mma_slab(slab, slab + kSlab, acc);',
                         '    if (nk < 0) mma_slab(slab, slab + kSlab, acc);'),), None),
    'no staging (wrong)': ((('convnext_common.cuh', '    if (s < nk) stage(',
                             '    if (s < nk && nk < 0) stage('),
                            ('convnext_common.cuh', '    if (next < nk) stage(',
                             '    if (next < nk && nk < 0) stage(')), None),
}


def _build_variants() -> dict:
    """One library per entry of `VARIANTS` with edits (the others share the
    library's build), all nvcc runs started together."""
    out = _build.BUILD_DIR / 'block_kernel_bench'
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        if not edits:
            continue
        src = out / f'variant_{i}'
        src.mkdir(parents=True, exist_ok=True)
        for file in ('convnext_block.cu', 'convnext_common.cuh'):
            text = (_build.CSRC / file).read_text()
            for f, old, new in edits:
                if f == file:
                    if text.count(old) != 1:
                        raise RuntimeError(f'variant {name!r}: {old!r} is not in {f} once')
                    text = text.replace(old, new)
            (src / file).write_text(text)
        path = src / 'kernel9.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(path),
               str(src / 'convnext_block.cu')]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {name: _build.load() for name, (edits, _) in VARIANTS.items() if not edits}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        getattr(lib, ENTRY).argtypes = _build.SIGNATURES[ENTRY]
        lib.slowtv_convnext_block_fwd_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.slowtv_convnext_block_fwd_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def _entry_call(lib, args, plan):
    """A call of `lib`'s kernel-9 entry on `block_args`' tensors and `plan`,
    into an output and scratch made once -> (the call, y)."""
    x = args[0]
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    scratch = torch.empty(lib.slowtv_convnext_block_fwd_scratch_floats(b, h, w, c),
                          device=x.device)
    tensors = (*args, out, scratch)  # the call keeps them alive

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, ENTRY)(*(t.data_ptr() for t in tensors), b, h, w, c, *plan,
                                         0, x.device.index, stream), 'kernel 9')
    return call, out


def bench_variants() -> None:
    libs = _build_variants()
    rs = np.random.RandomState(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = cb._cluster_blocks(0)
    print(f'{sms} SMs; blocks at once in clusters of {cb._FWD_SPLITS}: {slots}')
    totals = {name: 0.0 for name in libs}
    splits = {name: {} for name in libs}
    request = {name: 0.0 for name in libs}
    for b, h, w, c, n in [(1, *s) for s in CONVNEXT_B] + STEP_BLOCKS:
        args = block_args(rs, b, h, w, c)
        line = []
        for name, lib in libs.items():
            plan = cb.fwd_plan(b, h, w, c, sms, slots)
            if VARIANTS[name][1] is not None:
                plan = VARIANTS[name][1](*plan)
            call, out = _entry_call(lib, args, plan)
            call()
            torch.cuda.synchronize()
            err = _err(out, args)
            if 'wrong' not in name and not err <= RTOL:
                raise SystemExit(f'{name} at {(b, h, w, c)}: off the plain version in float64 '
                                 f'by {err:.1e} of max|y|')
            ms = graph_ms(call)
            if b == 1:
                request[name] += n * ms
            else:
                totals[name] += n * ms
                for k, v in launch_split(call).items():
                    k = k.replace('convnext_block_fwd_', '').replace('_kernel', '')
                    splits[name][k] = splits[name].get(k, 0.0) + n * v
            line.append(f'{name} {plan} {ms:.4f}')
            del call, out
        print(f'({b}, {h}, {w}, {c}) x{n}, device ms: ' + ', '.join(line))
        del args
    for name in libs:
        print(f'{name}: per request at B=1 {request[name]:.3f} ms; per KBR micro-step '
              f'{totals[name]:.3f} ms: '
              + ', '.join(f'{k} {v:.3f}' for k, v in splits[name].items()))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('block_kernel_bench needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    if sys.argv[1:] == ['variants']:
        bench_variants()
        return
    build = _build.build()
    _build.load()
    rs = np.random.RandomState(0)
    paths = {'a 384x640 request at B=1 (36 blocks)': [(1, *s) for s in CONVNEXT_B],
             'a 384x640 request at B=4 (36 blocks)': [(4, *s) for s in CONVNEXT_B],
             'a KBR micro-step (54 blocks)': STEP_BLOCKS}
    for path, shapes in paths.items():
        total = bound_total = 0.0
        path_split: dict[str, float] = {}
        for b, h, w, c, n in shapes:
            args = block_args(rs, b, h, w, c)
            err = _err(cb.fused_convnext_block(*args), args)
            ms = graph_ms(lambda: cb.fused_convnext_block(*args))
            split = launch_split(lambda: cb.fused_convnext_block(*args))
            bound = bound_ms(b, h, w, c)
            total += n * ms
            bound_total += n * bound
            for k, v in split.items():
                path_split[k] = path_split.get(k, 0.0) + n * v
            print(f'({b}, {h}, {w}, {c}) x{n}: kernel 9 {ms:.4f} ms (bound {bound:.4f}, '
                  f'{bound / ms:.0%}; err {err:.1e} of max|y|); launches (profiler): '
                  + ', '.join(f'{k} {v:.4f}' for k, v in split.items())
                  + f'; sum {sum(split.values()):.4f}')
            del args
        print(f'per {path}: kernel 9 {total:.3f} ms, bound {bound_total:.3f} ms '
              f'({bound_total / total:.0%}); launches (profiler): '
              + ', '.join(f'{k} {v:.3f}' for k, v in path_split.items())
              + f'; sum {sum(path_split.values()):.3f}')
    # Kernel 10 shares kernel 9's product core: its time beside kernel 9's.
    k10 = 0.0
    for b, h, w, c, n in STEP_BLOCKS:
        args = bwd_block_args(rs, b, h, w, c)
        k10 += n * graph_ms(lambda: kernel10(args))
        del args
    print(f'per a KBR micro-step (54 blocks): kernel 10 {k10:.3f} ms')
    log = build.log or build.path.with_suffix('.log').read_text()
    entry = ''
    for line in log.splitlines():
        if 'Compiling entry' in line or 'Function properties for' in line:
            entry = next((k for k in ('fwd_prep', 'fwd_fc1', 'fwd_fc2', 'fwd_kernel')
                          if f'convnext_block_{k}' in line), '')
        elif entry and ('registers' in line or 'stack frame' in line):
            print(f'ptxas convnext_block_{entry}: '
                  f'{line.replace("ptxas info    :", "").strip()}')


if __name__ == '__main__':
    main()
