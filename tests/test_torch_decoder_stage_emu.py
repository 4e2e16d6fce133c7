"""The decoder stage's forward CUDA source (kernel 3), run on the CPU, and its host plan.

`csrc/decoder_stage.cu` launches through `cudaLaunchKernelEx` with dynamic
shared memory only, so `tests/cuda_emu` (one `std::thread` per CUDA thread,
shared memory filled with NaN first, `cp.async` copies that land only at the
wait) lets g++ build the very file. Its C entry is called through ctypes on
CPU tensors, into outputs filled with NaN, and `ha`, `feat` and `disp` are
held against the plain stage in float64: grids of 2 and 3, where a reflect
fold lands on the row it left; odd h and w; h and w off the tiles (two tile
columns); CI != CD; channels off 4 (scalar staging) and over one chunk of 32;
CD over one channel tile; CD = 1; an x that does not start 16-byte aligned;
each on the plan `fwd_plan` makes for 132 SMs and on plans that put tile,
channel-tile and chunk boundaries inside small images. Two mutants must fail:
conv_b's pre-summed taps with the two parities swapped, and the upsampled
grid's reflection taken on ha's grid (u[-1] = ha[1]).

The host plan (`ops.decoder_stage.fwd_plan`) is checked without the
emulation: at every stage shape the main path runs, at 132 and at 78 SMs,
its blocks cover every output value once and fit the card's shared memory,
and the shared memory the plan counts is the source's.

Tolerance: STAGE_ATOL of `chip_smoke.py`, 1e-5 (float32 sums of at most 9*ci
O(1) products through ELU and sigmoid, against float64).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu_torch import _build
from slowtv_monodepth_tpu_torch.ops import decoder_stage as ds
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
ENTRY = 'slowtv_decoder_stage_fwd_f32'
NAMES = ('ha', 'feat', 'disp')
ATOL = 1e-5
MUTANTS = {
    # conv_b's tap sets of the even and the odd output parity swapped.
    'parities': ('  return p == 0 ? (a == 0 ? 1 : 6) : (a == 0 ? 3 : 4);',
                 '  return p == 1 ? (a == 0 ? 1 : 6) : (a == 0 ? 3 : 4);'),
    # ha reflected on its own grid before the upsample: u[-1] = ha[1].
    'reflect_ha': ('  if (CLAMP) return i < 0 ? 0 : (i < n ? i : n - 1);',
                   '  if (CLAMP) return i < 0 ? 1 : (i < n ? i : n - 2);'),
}
H100_SMEM = 232448  # bytes of shared memory a block may have (227 KB)


def _start_build(gxx: str, src: Path, lib: Path) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', f'-I{EMU}',
           f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source and its mutants built for the CPU, all g++ runs started together."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_stage_fwd')
    src = _build.CSRC / 'decoder_stage.cu'
    text = src.read_text()
    sources = {'source': src}
    for name, (old, new) in MUTANTS.items():
        assert text.count(old) == 1, name
        sources[name] = tmp / f'{name}.cu'
        sources[name].write_text(text.replace(old, new))
    builds = {name: _start_build(gxx, s, tmp / f'lib{name}.so') for name, s in sources.items()}
    out = {}
    for name, proc in builds.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(tmp / f'lib{name}.so'))
        fn = getattr(lib, ENTRY)
        fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
        lib.slowtv_decoder_stage_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.slowtv_decoder_stage_fwd_smem_bytes.restype = ctypes.c_longlong
        out[name] = lib
    return out


def _case(b, h, w, ci, cd, seed=0, misaligned=False):
    """Inputs (x, wa, ba, wb, bb, wo, bo), float32, fan-in scaled; x one float
    into its storage when `misaligned`."""
    rs = np.random.RandomState(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32))
    x = rand(b, h, w, ci, scale=0.5)
    if misaligned:
        x = torch.cat([torch.zeros(1), x.flatten()])[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    return (x, rand(cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)), rand(cd, scale=0.1),
            rand(cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), rand(cd, scale=0.1),
            rand(1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), rand(1, scale=0.1))


def _plain(args):
    """(ha, feat, disp) of the plain stage in float64."""
    args = [t.double() for t in args]
    return (ds.stage_ha_plain(*args[:3]), *ds.fused_upconv_stage_plain(*args))


def _run(lib, args, plan):
    """The C entry on `plan` -> (err, ha, feat, disp), outputs NaN where not written."""
    x = args[0]
    b, h, w, ci = x.shape
    cd = args[1].shape[0]
    outs = [torch.full(s, float('nan')) for s in
            ((b, h, w, cd), (b, 2 * h, 2 * w, cd), (b, 2 * h, 2 * w, 1))]
    err = getattr(lib, ENTRY)(*(t.data_ptr() for t in (*args, *outs)), b, h, w, ci, cd, *plan,
                              0, None)
    return (err, *outs)


def _err(got, want) -> dict:
    return {k: float((g.double() - t).abs().max()) for k, g, t in zip(NAMES, got, want)}


# (b, h, w, ci, cd): grids of 2 and 3; one decoder channel; ci != cd off 4
# (scalar staging, zeros past the last channel); cd over one channel tile
# (conv_a: 8, conv_b: 4 a thread); ci over one chunk of 32; h and w off the
# tiles, two tile columns.
CASES = [(1, 2, 3, 4, 3), (2, 3, 2, 2, 2), (1, 2, 2, 3, 1), (1, 3, 5, 5, 7), (2, 5, 7, 6, 5),
         (1, 3, 4, 20, 17), (1, 7, 37, 8, 8), (1, 5, 3, 40, 12)]
# Plans (row warps, channel warps, chunk) that put tile rows, channel tiles and
# chunks inside the small images: one warp and chunks of 4; two row warps.
SMALL_PLANS = {'one warp, chunks of 4': (1, 1, 4) * 3,
               'two row warps': (2, 1, 8, 2, 1, 8, 2, 1, 8)}


@pytest.mark.parametrize('b,h,w,ci,cd', CASES)
def test_stage_forward_source_on_the_cpu_matches_plain(libs, b, h, w, ci, cd):
    args = _case(b, h, w, ci, cd)
    want = _plain(args)
    for plan in (ds.fwd_plan(b, h, w, ci, cd, 132), *SMALL_PLANS.values()):
        err, *got = _run(libs['source'], args, plan)
        assert err == 0
        assert all(torch.isfinite(g).all() for g in got), plan  # every value written
        errs = _err(got, want)
        assert max(errs.values()) <= ATOL, (plan, errs)


def test_unaligned_x_takes_the_scalar_staging(libs):
    args = _case(1, 4, 6, 8, 4, seed=5, misaligned=True)
    err, *got = _run(libs['source'], args, ds.fwd_plan(1, 4, 6, 8, 4, 132))
    errs = _err(got, _plain(args))
    assert err == 0 and max(errs.values()) <= ATOL, errs


def test_two_calls_are_bitwise_equal(libs):
    args = _case(2, 5, 7, 6, 5, seed=3)
    plan = ds.fwd_plan(2, 5, 7, 6, 5, 132)
    first, second = (_run(libs['source'], args, plan)[1:] for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_plan_out_of_range_is_refused(libs):
    args = _case(1, 2, 3, 4, 3)
    for plan in ((3, 3, 4) * 3, (1, 1, 6) * 3, (1, 1, 4, 1, 1, 4, 1, 2, 4)):
        assert _run(libs['source'], args, plan)[0] != 0, plan


@pytest.mark.parametrize('mutant', sorted(MUTANTS))
def test_comparison_catches_mutants(libs, mutant):
    args = _case(2, 4, 5, 6, 5, seed=4)
    want = _plain(args)
    plan = ds.fwd_plan(2, 4, 5, 6, 5, 132)
    assert max(_err(_run(libs['source'], args, plan)[1:], want).values()) <= ATOL
    err, *got = _run(libs[mutant], args, plan)
    errs = _err(got, want)
    assert err == 0 and errs['ha'] <= ATOL and errs['feat'] > 100 * ATOL, errs


def test_smem_bytes_is_the_sources(libs):
    lib = libs['source']
    for i, conv in enumerate('abo'):
        for rg, cgb, cic in ((1, 1, 4), (2, 4, 32), (8, 1, 16), (4, 2, 8)):
            assert lib.slowtv_decoder_stage_fwd_smem_bytes(i, rg, cgb, cic) == \
                ds.smem_bytes(conv, rg, cgb, cic)


# ------------------------------------------------------------------ host plan
def _stage_shapes():
    """(b, h, w, ci, cd) of every decoder stage the main path runs: a request
    at B=1 and B=4 (the micro-step's stages are B=4's), 384x640, and the
    training run's AR-aug buckets at B=4 (`chip_smoke.run_buckets`)."""
    shapes = [(b, 96, 160, 64, 32) for b in (1, 2, 4)] + [(b, 192, 320, 32, 16) for b in (1, 2, 4)]
    for bh, bw in ((224, 832), (480, 384)):
        shapes += [(4, bh // 4, bw // 4, 64, 32), (4, bh // 2, bw // 2, 32, 16)]
    return shapes


@pytest.mark.parametrize('sms', [132, 78])
def test_plan_covers_every_output_once_and_fits(sms):
    for b, h, w, ci, cd in _stage_shapes() + [(1, 2, 3, 4, 3), (1, 21, 19, 20, 20)]:
        plan = ds.fwd_plan(b, h, w, ci, cd, sms)
        for conv, grid, (rg, cgb, cic) in zip('abo', ((h, w, ci, cd), (h, w, cd, cd),
                                                      (2 * h, 2 * w, cd, 1)),
                                              (plan[:3], plan[3:6], plan[6:])):
            gh, gw, cin, cout = grid
            assert 32 * rg * cgb <= 256 and cic % 4 == 0 and 4 <= cic <= 32
            assert ds.smem_bytes(conv, rg, cgb, cic) <= H100_SMEM // 2
            rows, cols, chans, blocks = ds.conv_tiles(conv, b, gh, gw, cout, rg, cgb)
            # The kernel's block -> (image, tile row, tile column, channel tile),
            # channel tiles fastest; each block's outputs counted once.
            tiles = (b, -(-gh // rows), -(-gw // cols), -(-cout // chans))
            assert blocks == np.prod(tiles)
            ids = np.arange(blocks)
            ct, ids = ids % tiles[3], ids // tiles[3]
            tc, ids = ids % tiles[2], ids // tiles[2]
            tr, img = ids % tiles[1], ids // tiles[1]
            for axis, (tile, n, size) in enumerate(((tr, gh, rows), (tc, gw, cols),
                                                    (ct, cout, chans))):
                covered = np.zeros(n, int)
                for t in np.unique(tile):
                    covered[t * size:(t + 1) * size] += 1
                assert (covered == 1).all(), (conv, axis)
            assert len(set(zip(img, tr, tc, ct))) == blocks
