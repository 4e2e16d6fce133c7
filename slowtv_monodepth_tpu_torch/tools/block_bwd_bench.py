"""Kernel 10 (the fused ConvNeXt block's backward) launch by launch, on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.block_bwd_bench

At the eight block shapes of a KBR micro-step (ConvNeXt-B at B=4 and
ConvNeXt-T at B=8, 384x640; 54 blocks), float32:
- kernel 10 alone (`ops.convnext_block.block_bwd_kernel`, one C entry that
  makes several CUDA launches): its device time per call, 10 calls captured
  into one CUDA graph, CUDA events around one replay, divided by 10 (as
  `chip_smoke.cuda_ms` times it), beside its bound (40 C^2 float32 operations
  per pixel at 67 TFLOP/s, or its bytes at 3.35 TB/s, whichever is larger);
- the split of that time between its CUDA launches: `torch.profiler`'s
  device time per kernel name over 10 eager calls, divided by 10;
- both summed over the micro-step, each shape weighted by its blocks.
It ends with the `ptxas` lines (registers, stack frame, spills) of the
kernel-10 instances in the build log.

Of the package it uses only `ops.convnext_block.block_bwd_kernel` and
`_build`, so a copy of this file placed in another checkout's `tools/` times
that checkout's kernel 10: run it in two checkouts in turns (A, B, B, A) to
compare them on one card.

    python -m slowtv_monodepth_tpu_torch.tools.block_bwd_bench variants

builds `csrc/convnext_block_bwd.cu` as the library does and as copies of it
and of `csrc/convnext_common.cuh` with one edit each, patched in at build
time (all nvcc runs started together; the library's sources carry no such
switches), and times each copy's C entry on
the library's plan (`ops.convnext_block.bwd_plan`) in the same way: other
slab depths and ring lengths, and three timing aids whose results are
wrong: the products' FMAs left out, their staging copies left out, the
prep's taps left out. The others'
eight parameter gradients are held to the plain backward in float64 within
1e-5 of each one's largest magnitude.

    python -m slowtv_monodepth_tpu_torch.tools.block_bwd_bench digests

prints a digest of each of kernel 10's outputs at the eight shapes on seeded
inputs: run it in two checkouts to see that they give the same bits.
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
from ..ops import convnext_block as cb

# (b, h, w, c, blocks per KBR micro-step at B=4, 384x640)
STEP_BLOCKS = [(4, 96, 160, 128, 3), (4, 48, 80, 256, 3), (4, 24, 40, 512, 27),
               (4, 12, 20, 1024, 3), (8, 96, 160, 96, 3), (8, 48, 80, 192, 3),
               (8, 24, 40, 384, 9), (8, 12, 20, 768, 3)]
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def block_args(rs, b, h, w, c) -> tuple:
    """x, dy and the block's nine parameters on the card, fan-in scaled."""
    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()
    return (rand(b, h, w, c), rand(b, h, w, c), rand(c, 1, 7, 7, scale=1 / 7),
            rand(c, scale=0.1), 1 + rand(c, scale=0.1), rand(c, scale=0.1),
            rand(4 * c, c, scale=c ** -0.5), rand(4 * c, scale=0.1),
            rand(c, 4 * c, scale=(4 * c) ** -0.5), rand(c, scale=0.1), rand(c, scale=0.5))


def bound_ms(b, h, w, c) -> float:
    """Kernel 10's bound: 40 C^2 + 98 C float32 operations per pixel (the
    forward's fc1 product again, two input-gradient and two weight-gradient
    products, the 49 taps), or x and dy in, du out, the parameters in and
    their gradients out, whichever takes longer."""
    p = b * h * w
    params = 8 * c * c + 9 * c
    flops = 40 * p * c * c + 98 * p * c
    return 1e3 * max(flops / PEAK_F32_FLOPS, 4 * (3 * p * c + 2 * params + 49 * c) / PEAK_BYTES)


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms per call: `iters` calls in one CUDA graph, events around one replay."""
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
    del graph
    return start.elapsed_time(end) / iters


def _short(name: str) -> str:
    """A CUDA kernel's name without its return type, namespace and arguments."""
    name = name.replace('(anonymous namespace)::', '').split('(')[0].split()
    return name[-1].split('::')[-1] if name else '?'


def _ptxas_name(line: str) -> str:
    """The kernel-10 function a `ptxas -v` line names (mangled), e.g. `mlp_kernel`."""
    m = re.search(r'\d(convnext_block_bwd_[a-z]+_kernel)(ILi(\d+)E)?', line)
    return m.group(1) + (f'<{m.group(3)}>' if m.group(3) else '') if m else ''


def launch_split(fn, iters: int = 10) -> dict[str, float]:
    """Device ms per call of each CUDA kernel `fn` launches, by kernel name,
    from `torch.profiler` over `iters` calls after two warm ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            key = _short(e.key)
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def kernel10(args):
    """One call of kernel 10 on `block_args`' tensors."""
    x, dy, *params = args
    return cb.block_bwd_kernel(x, dy, *params)


ENTRY = 'slowtv_convnext_block_bwd_f32'
# name -> edits of csrc/convnext_block_bwd.cu or csrc/convnext_common.cuh,
# (file, old, new) each.
VARIANTS = {
    'library': (),
    'products ring of 2': (('convnext_block_bwd.cu', 'constexpr int kProductsStages = 3;',
                            'constexpr int kProductsStages = 2;'),),
    'mlp ring of 3': (('convnext_block_bwd.cu', 'constexpr int kMlpStages = 2;',
                       'constexpr int kMlpStages = 3;'),),
    '16-deep slabs': (('convnext_common.cuh', 'constexpr int kBK = 32;',
                       'constexpr int kBK = 16;'),),
    'prep without taps (wrong)': (
        ('convnext_block_bwd.cu', '  taps_tile(x, dww, dwb, u, ldu, p0, pixels, M, H, W, C);', ''),),
    'no FMA (wrong)': (('convnext_common.cuh', '    mma_slab(slab, slab + kSlab, acc);',
                        '    if (nk < 0) mma_slab(slab, slab + kSlab, acc);'),),
    'no staging (wrong)': (('convnext_common.cuh', '    if (s < nk) stage(',
                            '    if (s < nk && nk < 0) stage('),
                           ('convnext_common.cuh', '    if (next < nk) stage(',
                            '    if (next < nk && nk < 0) stage(')),
}


def _build_variants() -> dict:
    """One library per entry of `VARIANTS`, all nvcc runs started together."""
    out = _build.BUILD_DIR / 'block_bwd_bench'
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = out / f'variant_{i}'
        src.mkdir(parents=True, exist_ok=True)
        for file in ('convnext_block_bwd.cu', 'convnext_common.cuh'):
            text = (_build.CSRC / file).read_text()
            for f, old, new in edits:
                if f == file:
                    if text.count(old) != 1:
                        raise RuntimeError(f'variant {name!r}: {old!r} is not in {f} once')
                    text = text.replace(old, new)
            (src / file).write_text(text)
        path = src / 'kernel10.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(path),
               str(src / 'convnext_block_bwd.cu')]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        getattr(lib, ENTRY).argtypes = _build.SIGNATURES[ENTRY]
        lib.slowtv_convnext_block_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.slowtv_convnext_block_bwd_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def _entry_call(lib, args):
    """A call of `lib`'s kernel-10 entry on `block_args`' tensors and the
    library's plan, into outputs made once -> (the call, du and the eight
    parameter gradients)."""
    x, dy, *params = args
    b, h, w, c = x.shape
    plan = cb.bwd_plan(b, h, w, c, torch.cuda.get_device_properties(0).multi_processor_count)
    m, group, splits_w, splits_x = plan
    du = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in params[1:]]
    scratch = torch.empty(
        lib.slowtv_convnext_block_bwd_scratch_floats(b, h, w, c, m, splits_w, splits_x),
        device=x.device)
    tensors = (x, dy, *params, du, *grads, scratch)  # the call keeps them alive

    def call():
        _build.check(getattr(lib, ENTRY)(*(t.data_ptr() for t in tensors), b, h, w, c, *plan, 0,
                                         x.device.index, torch.cuda.current_stream().cuda_stream),
                     'kernel 10')
    return call, (du, *grads)


def bench_variants() -> None:
    libs = _build_variants()
    rs = np.random.RandomState(0)
    totals = {name: 0.0 for name in libs}
    splits = {name: {} for name in libs}
    for b, h, w, c, n in STEP_BLOCKS:
        args = block_args(rs, b, h, w, c)
        x, dy, *params = args
        # The eight parameter gradients of the plain backward in float64.
        want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (x, dy, *params)))[2:]
        line = []
        for name, lib in libs.items():
            call, out = _entry_call(lib, args)
            call()
            torch.cuda.synchronize()
            err = [float((u - v).abs().max() / v.abs().max()) for u, v in zip(out[1:], want)]
            if 'wrong' not in name and not max(err) <= 1e-5:
                raise SystemExit(f'{name} at {(b, h, w, c)}: off the plain backward in float64 '
                                 'by ' + ', '.join(f'{e:.1e}' for e in err))
            ms = graph_ms(call)
            totals[name] += n * ms
            for k, v in launch_split(call).items():
                k = k.replace('convnext_block_bwd_', '').replace('_kernel', '')
                splits[name][k] = splits[name].get(k, 0.0) + n * v
            line.append(f'{name} {ms:.4f}')
            del call, out
        print(f'({b}, {h}, {w}, {c}) x{n}, device ms: ' + ', '.join(line))
        del args, want
    for name in libs:
        print(f'per KBR micro-step, {name}: {totals[name]:.3f} ms; '
              + ', '.join(f'{k} {v:.3f}' for k, v in splits[name].items()))


def digests() -> None:
    """sha256 of each of kernel 10's nine outputs at the micro-step's shapes,
    on seeded inputs: equal lines from two checkouts mean the same bits."""
    rs = np.random.RandomState(0)
    for b, h, w, c, _ in STEP_BLOCKS:
        out = kernel10(block_args(rs, b, h, w, c))
        torch.cuda.synchronize()
        print(f'digest ({b}, {h}, {w}, {c}): ' + ' '.join(
            hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16] for t in out))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('block_bwd_bench needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    if sys.argv[1:] in (['variants'], ['digests']):
        (bench_variants if sys.argv[1] == 'variants' else digests)()
        return
    build = _build.build()
    _build.load()
    rs = np.random.RandomState(0)
    total = bound_total = 0.0
    step_split: dict[str, float] = {}
    for b, h, w, c, n in STEP_BLOCKS:
        args = block_args(rs, b, h, w, c)
        ms = graph_ms(lambda: kernel10(args))
        split = launch_split(lambda: kernel10(args))
        bound = bound_ms(b, h, w, c)
        total += n * ms
        bound_total += n * bound
        for k, v in split.items():
            step_split[k] = step_split.get(k, 0.0) + n * v
        print(f'({b}, {h}, {w}, {c}) x{n}: kernel 10 {ms:.4f} ms (bound {bound:.4f}, '
              f'{bound / ms:.0%}); launches (profiler): '
              + ', '.join(f'{k} {v:.4f}' for k, v in split.items())
              + f'; sum {sum(split.values()):.4f}')
        del args
    print(f'per KBR micro-step (54 blocks): kernel 10 {total:.3f} ms, bound {bound_total:.3f} ms '
          f'({bound_total / total:.0%}); launches (profiler): '
          + ', '.join(f'{k} {v:.3f}' for k, v in step_split.items())
          + f'; sum {sum(step_split.values()):.3f}')
    log = build.log or build.path.with_suffix('.log').read_text()
    entry = ''
    for line in log.splitlines():
        if 'Compiling entry' in line or 'Function properties for' in line:
            entry = _ptxas_name(line)
        elif entry and ('registers' in line or 'stack frame' in line):
            print(f'ptxas {entry}: {line.replace("ptxas info    :", "").strip()}')


if __name__ == '__main__':
    main()
