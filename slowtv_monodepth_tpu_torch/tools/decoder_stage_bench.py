"""Kernel 3 (the decoder stage's forward) launch by launch, on one CUDA card.

    python -m slowtv_monodepth_tpu_torch.tools.decoder_stage_bench

At the two full-resolution decoder stages (scale 1: (b, 96, 160, 64 -> 32),
scale 0: (b, 192, 320, 32 -> 16)) of a 384x640 request at B=1, at B=2 and at
B=4 (a KBR micro-step's forward runs B=4's), float32:
- kernel 3 (`ops.decoder_stage._launch_fwd`: one C entry, three CUDA
  launches, outputs ha, feat and disp): its device time per call, 10 calls
  captured into one CUDA graph, CUDA events around one replay, divided by
  10, held against the plain stage in float64;
- the split of that time between its CUDA launches: `torch.profiler`'s
  device time per kernel name over 10 eager calls, divided by 10;
- its bound on both operation counts: conv_b as the kernel computes it (16
  pre-summed parity taps per ha pixel: 32 CD^2 operations) and as a 9-tap
  conv on the upsampled grid (72 CD^2), at 67 TFLOP/s, beside the bytes
  (x and the parameters in, feat and disp out) at 3.35 TB/s;
- the plain stage's time and cuDNN's three convs alone (zero padding, no
  ELU, upsample or sigmoid) at the same shapes;
- both stages summed per request, each on the same card.
It ends with the `ptxas` lines (registers, stack frame, spills) of kernel
3's launches in the build log.

Of the package it uses only `ops.decoder_stage` (`_launch_fwd`,
`_conv_reflect`, `fused_upconv_stage_plain`) and `tools/block_bwd_bench.py` (`graph_ms`,
`launch_split`), so a copy of this file placed in another checkout's
`tools/` times that checkout's kernel 3: run it in two checkouts in turns
(A, B, B, A) to compare them on one card.

    python -m slowtv_monodepth_tpu_torch.tools.decoder_stage_bench variants

builds `csrc/decoder_stage.cu` as the library does and as copies with one
edit each, patched in at build time (all nvcc runs started together; the
library's source carries no such switches), and times each copy's C entry at
the stage shapes of B=1 and B=4 in the same way, on the library's plan
(`ops.decoder_stage.fwd_plan`) or on another: 8-, 4- or 2-warp blocks
everywhere, conv_a's or conv_b's tiles twice as tall and half as deep in
channels, disp in chunks of 16 channels, conv_b held to two blocks an SM
by its launch bounds, conv_b with 3 ha rows a thread; and timing aids whose
results are wrong: the products' FMAs left out, the staging left out,
conv_b's weight staging and pre-sums left out, the epilogue's stores left
out. The others'
outputs are held to the plain stage in float64 within 1e-5.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..ops import decoder_stage as ds
from .block_bwd_bench import PEAK_BYTES, PEAK_F32_FLOPS, graph_ms, launch_split

ATOL = 1e-5  # chip_smoke.py's STAGE_ATOL
# (h, w, ci, cd) of the KBR decoder's stages 1 and 0 at 384x640.
STAGES = ((96, 160, 64, 32), (192, 320, 32, 16))


def stage_args(rs, b, h, w, ci, cd) -> tuple:
    """x and the stage's six parameters on the card, fan-in scaled."""
    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32)).cuda()
    return (rand(b, h, w, ci, scale=0.5), rand(cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)),
            rand(cd, scale=0.1), rand(cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)),
            rand(cd, scale=0.1), rand(1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), rand(1, scale=0.1))


def stage_flops(b, h, w, ci, cd, presummed: bool) -> float:
    """Float32 operations of one stage: conv_a, conv_b and disp, conv_b as 16
    pre-summed taps per ha pixel or as 9 taps per output."""
    p = b * h * w
    conv_b = 2 * 16 * cd * cd * p if presummed else 2 * 9 * cd * cd * 4 * p
    return 2 * 9 * ci * cd * p + conv_b + 2 * 9 * cd * 4 * p


def stage_bytes(b, h, w, ci, cd) -> float:
    """x and the parameters in, feat and disp out."""
    p = b * h * w
    return 4 * (p * ci + 9 * (ci * cd + cd * cd + cd) + 2 * cd + 1 + 4 * p * cd + 4 * p)


def _errs(outs, args) -> float:
    """max|kernel - plain(float64)| over ha, feat and disp."""
    a64 = [t.double() for t in args]
    # Through `_conv_reflect`, which checkouts without `stage_ha_plain` have too.
    ha = F.elu(ds._conv_reflect(a64[0].permute(0, 3, 1, 2), a64[1], a64[2]))
    want = (ha.permute(0, 2, 3, 1), *ds.fused_upconv_stage_plain(*a64))
    return max(float((o.double() - t).abs().max()) for o, t in zip(outs, want))


def _cudnn(args):
    """cuDNN's three convs of the stage alone, on buffers of the stage's shapes."""
    x, wa, ba, wb, bb, wo, bo = args
    b, h, w, _ = x.shape
    cd = wa.shape[0]
    xa = x.permute(0, 3, 1, 2)
    ub = torch.empty(b, cd, 2 * h, 2 * w, device='cuda').contiguous(
        memory_format=torch.channels_last)
    return lambda: (F.conv2d(xa, wa, ba, padding=1), F.conv2d(ub, wb, bb, padding=1),
                    F.conv2d(ub, wo, bo, padding=1))


def _name(key: str) -> str:
    """A CUDA kernel's name without its namespace, return type and arguments."""
    key = key.replace('(anonymous namespace)::', '').split('(')[0]
    return key.replace('void ', '').strip()


def _ptxas(log: str) -> None:
    entry = ''
    for line in log.splitlines():
        if 'Compiling entry' in line or 'Function properties for' in line:
            entry = next((k for k in ('decoder_stage_fwd_conv_a', 'decoder_stage_fwd_conv_b',
                                      'decoder_stage_fwd_disp', 'conv3x3_reflect') if k in line), '')
        elif entry and ('registers' in line or 'stack frame' in line):
            print(f'ptxas {entry}: {line.replace("ptxas info    :", "").strip()}')


def main() -> None:
    rs = np.random.RandomState(0)
    build = _build.build()
    _build.load()
    for b in (1, 2, 4):
        total = plain = cudnn = bound = bound9 = 0.0
        split_total: dict[str, float] = {}
        for h, w, ci, cd in STAGES:
            args = stage_args(rs, b, h, w, ci, cd)
            err = _errs(ds._launch_fwd(*args), args)
            if not err <= ATOL:
                raise SystemExit(f'kernel 3 at {(b, h, w, ci, cd)}: off the plain stage in '
                                 f'float64 by {err:.2e}')
            ms = graph_ms(lambda: ds._launch_fwd(*args))
            pms = graph_ms(lambda: ds.fused_upconv_stage_plain(*args))
            lms = graph_ms(_cudnn(args))
            split = {_name(k): v for k, v in launch_split(lambda: ds._launch_fwd(*args)).items()}
            nbytes = 1e3 * stage_bytes(b, h, w, ci, cd) / PEAK_BYTES
            ops = 1e3 * stage_flops(b, h, w, ci, cd, True) / PEAK_F32_FLOPS
            ops9 = 1e3 * stage_flops(b, h, w, ci, cd, False) / PEAK_F32_FLOPS
            total, plain, cudnn = total + ms, plain + pms, cudnn + lms
            bound, bound9 = bound + max(nbytes, ops), bound9 + max(nbytes, ops9)
            for k, v in split.items():
                split_total[k] = split_total.get(k, 0.0) + v
            plan = ds.fwd_plan(b, h, w, ci, cd, _sms()) if hasattr(ds, 'fwd_plan') else '-'
            print(f'({b}, {h}, {w}, {ci} -> {cd}) plan {plan}: '
                  f'kernel 3 {ms:.4f} ms (err {err:.1e}; bound {max(nbytes, ops):.4f}, '
                  f'{max(nbytes, ops) / ms:.0%}; 9-tap bound {max(nbytes, ops9):.4f}; bytes '
                  f'{nbytes:.4f}), plain {pms:.4f}, cuDNN three convs {lms:.4f}; launches '
                  '(profiler): ' + ', '.join(f'{k} {v:.4f}' for k, v in split.items()))
            del args
        print(f'per request at B={b} (2 stages): kernel 3 {total:.4f} ms, bound {bound:.4f} '
              f'({bound / total:.0%}; 9-tap {bound9:.4f}), plain {plain:.4f}, cuDNN three convs '
              f'{cudnn:.4f}; launches (profiler): '
              + ', '.join(f'{k} {v:.4f}' for k, v in split_total.items()))
    _ptxas(build.log or build.path.with_suffix('.log').read_text())


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


ENTRY = 'slowtv_decoder_stage_fwd_f32'
_SKIP = '    if (a.CIN < 0) '
# name -> (edits of csrc/decoder_stage.cu (old, new); the plan from the library's
# plan per conv: (conv, (rg, cgb, cic), cin) -> (rg, cgb, cic)).
VARIANTS = {
    'library': ((), None),
    '8-warp blocks': ((), lambda conv, p, grid: _warps(conv, p, grid, 8)),
    '4-warp blocks': ((), lambda conv, p, grid: _warps(conv, p, grid, 4)),
    '2-warp blocks': ((), lambda conv, p, grid: _warps(conv, p, grid, 2)),
    'disp chunks of 16': ((), lambda conv, p, grid: _chunk16(conv, p, grid)),
    'conv_a taller tiles': ((), lambda conv, p, grid: _taller('a', conv, p)),
    'conv_b taller tiles': ((), lambda conv, p, grid: _taller('b', conv, p)),
    'conv_b held to two blocks an SM': ((('__launch_bounds__(kMaxThreads) decoder_stage_fwd_conv_b',
                                          '__launch_bounds__(kMaxThreads, 2) decoder_stage_fwd_conv_b'),),
                                        None),
    'conv_b 3 rows a thread': ((('template <> struct Conv<kConvB> { static constexpr int P = 4,',
                                 'template <> struct Conv<kConvB> { static constexpr int P = 3,'),),
                               lambda conv, p, grid: _rows3(conv, p, grid)),
    'no epilogue stores (wrong)': ((('        *reinterpret_cast<float4*>(op) = v;',
                                     '        if (a.CIN < 0) *reinterpret_cast<float4*>(op) = v;'),),
                                   None),
    'no FMA (wrong)': ((('    for (int c4 = 0; c4 < n4; ++c4, tp += tile_c4',
                         '    for (int c4 = 0; c4 < n4 && a.CIN < 0; ++c4, tp += tile_c4'),),
                       None),
    'conv_b without its pre-sums (wrong)': ((('    stage_weights<CONV>(s_w,',
                                              '    if (!UP) stage_weights<CONV>(s_w,'),), None),
    'no staging (wrong)': ((('    stage_tile<UP>(s_in,', _SKIP + 'stage_tile<UP>(s_in,'),
                            ('    stage_weights<CONV>(s_w,', _SKIP + 'stage_weights<CONV>(s_w,')),
                           None),
}


def _taller(which: str, conv: str, plan: tuple) -> tuple:
    """Conv `which` with half the channel warps and twice the row warps."""
    rg, cgb, cic = plan
    if conv != which or cgb < 2:
        return plan
    return 2 * rg, cgb // 2, cic


def _chunk16(conv: str, plan: tuple, grid: tuple) -> tuple:
    """disp's plan with chunks of up to 16 channels."""
    if conv != 'o':
        return plan
    saved = ds._MAX_CHUNK['o']
    ds._MAX_CHUNK['o'] = 16
    try:
        return ds.conv_plan('o', *grid, _sms())
    finally:
        ds._MAX_CHUNK['o'] = saved


def _rows3(conv: str, plan: tuple, grid: tuple) -> tuple:
    """conv_b's plan made for threads of 3 ha rows."""
    if conv != 'b':
        return plan
    saved = ds._CONVS['b']
    ds._CONVS['b'] = (3, *saved[1:])
    try:
        return ds.conv_plan('b', *grid, _sms())
    finally:
        ds._CONVS['b'] = saved


def _warps(conv: str, plan: tuple, grid: tuple, warps: int) -> tuple:
    """The plan with blocks of `warps` warps: all channel warps the conv has
    (up to `warps`), the rest row warps; the chunk within two blocks an SM."""
    _, to, _ = ds._CONVS[conv]
    cgb = 1 if to == 1 else min(warps, plan[1])
    rg = warps // cgb
    cic = plan[2]
    while cic > 4 and ds.smem_bytes(conv, rg, cgb, cic) > ds._SMEM_TARGET:
        cic = max(4, cic // 2)
    return rg, cgb, cic


def _build_variants() -> dict:
    """One library per entry of `VARIANTS` with edits (the others share the
    library's build), all nvcc runs started together."""
    out = _build.BUILD_DIR / 'decoder_stage_bench'
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        if not edits:
            continue
        src = out / f'variant_{i}'
        src.mkdir(parents=True, exist_ok=True)
        text = (_build.CSRC / 'decoder_stage.cu').read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'variant {name!r}: {old!r} is not in decoder_stage.cu once')
            text = text.replace(old, new)
        (src / 'decoder_stage.cu').write_text(text)
        path = src / 'kernel3.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(path),
               str(src / 'decoder_stage.cu')]
        procs[name] = (path, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {name: _build.load() for name, (edits, _) in VARIANTS.items() if not edits}
    for name, (path, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed (exit {proc.returncode}):\n{" ".join(cmd)}\n{log}')
        lib = ctypes.CDLL(str(path))
        getattr(lib, ENTRY).argtypes = _build.SIGNATURES[ENTRY]
        libs[name] = lib
        print(f'{name}:')
        _ptxas(log)
    return libs


def _entry_call(lib, args, plan):
    """A call of `lib`'s kernel-3 entry on `stage_args`' tensors and `plan`,
    into outputs made once -> (the call, (ha, feat, disp))."""
    x = args[0]
    b, h, w, ci = x.shape
    cd = args[1].shape[0]
    outs = (torch.empty(b, h, w, cd, device='cuda'), torch.empty(b, 2 * h, 2 * w, cd, device='cuda'),
            torch.empty(b, 2 * h, 2 * w, 1, device='cuda'))
    tensors = (*args, *outs)  # the call keeps them alive

    def call():
        _build.check(getattr(lib, ENTRY)(*(t.data_ptr() for t in tensors), b, h, w, ci, cd, *plan,
                                         x.device.index, torch.cuda.current_stream().cuda_stream),
                     'kernel 3')
    return call, outs


def bench_variants() -> None:
    libs = _build_variants()
    rs = np.random.RandomState(0)
    sms = _sms()
    totals = {name: {} for name in libs}
    for b in (1, 4):
        for h, w, ci, cd in STAGES:
            args = stage_args(rs, b, h, w, ci, cd)
            line = []
            for name, lib in libs.items():
                plan = ds.fwd_plan(b, h, w, ci, cd, sms)
                fn = VARIANTS[name][1]
                if fn is not None:  # the grid each conv walks: (b, h, w, cin, cout)
                    grids = ((b, h, w, ci, cd), (b, h, w, cd, cd), (b, 2 * h, 2 * w, cd, 1))
                    plan = tuple(v for conv, part, grid in zip('abo', (plan[:3], plan[3:6], plan[6:]),
                                                               grids) for v in fn(conv, part, grid))
                call, outs = _entry_call(lib, args, plan)
                call()
                torch.cuda.synchronize()
                err = _errs(outs, args)
                if 'wrong' not in name and not err <= ATOL:
                    raise SystemExit(f'{name} at {(b, h, w, ci, cd)}: off the plain stage in '
                                     f'float64 by {err:.1e}')
                ms = graph_ms(call)
                split = {_name(k).replace('decoder_stage_fwd_', '').replace('_kernel', ''): v
                         for k, v in launch_split(call).items()}
                tot = totals[name].setdefault(b, {'ms': 0.0})
                tot['ms'] += ms
                for k, v in split.items():
                    tot[k] = tot.get(k, 0.0) + v
                line.append(f'{name} {plan} {ms:.4f}')
                del call, outs
            print(f'({b}, {h}, {w}, {ci} -> {cd}), device ms: ' + ', '.join(line))
            del args
    for name in libs:
        print(f'{name}: ' + '; '.join(
            f'per request at B={b} {t["ms"]:.4f} ms (' + ', '.join(
                f'{k} {v:.4f}' for k, v in t.items() if k != 'ms') + ')'
            for b, t in totals[name].items()))


if __name__ == '__main__':
    if not torch.cuda.is_available():
        raise SystemExit('decoder_stage_bench needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    bench_variants() if sys.argv[1:] == ['variants'] else main()
