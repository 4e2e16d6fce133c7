"""The depthwise conv's CUDA source (kernels 1 and 2), run on the CPU.

`csrc/dwconv.cu` launches through `cudaLaunchKernelEx` with dynamic shared
memory only, so `tests/cuda_emu` (one `std::thread` per CUDA thread, shared
memory filled with NaN first) lets g++ build the very file. Its C entry points
are called through ctypes on CPU tensors and held against the plain PyTorch
versions in float64: the float4 and the scalar channel paths, every K, ragged
C, views that start off alignment, and the rolling-row walk across band
boundaries. The default build picks its bands as on the card (one-row bands at
these few pixels: the direct walk); a second build is given bands of 3 rows
(`SLOWTV_DWCONV_ROWS`, defined by this test only), so that the ring of output
rows runs, with bands that end inside the image and a short last band. A
mutant of that build, which drops the first halo row of every band, must fail.

The tap gradient (kernel 2) takes its plan (rows per tile, blocks per channel
group, blocks per cluster) from its caller, so these tests hand it small
plans that put tile, strip, block and cluster boundaries inside these small
images: tiles of 1 to 12 rows (fewer and more rows than the block's 8
warps), a block walking several bands and strips through its two tile
buffers, runs of tiles that start mid-strip, clusters of 2-3 blocks, one
partial (the cluster writes dw itself) and several (the second launch adds
them). Every K, ragged C (the scalar copies), a view one float off
alignment, two calls bitwise equal, refused plans, and two mutants that must
fail: a dropped halo row and a dropped partial. The stand-in's asynchronous
copies land only when the kernel waits for them, so a read before the wait
would fail these tests too.

Tolerance: DWCONV_ATOL of `chip_smoke.py`, 1e-5 absolute: float32 FMA chains
of K*K <= 81 O(1) products against float64 (measured ~1e-6). Tap gradient:
DW_ATOL, 1e-5, on O(1) sums of b*h*w products (the cotangent scaled by
1/sqrt(b*h*w)).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu_torch import _build
from slowtv_monodepth_tpu_torch.ops.dwconv import depthwise_conv_plain, dw_plan, dwconv_dw_plain
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
FWD = 'slowtv_dwconv_fwd_f32'
DW = 'slowtv_dwconv_dw_f32'
ATOL = 1e-5
BAND_ROWS = 3
# The fault the band build must catch: each band's first input row (its top
# halo row, the last row of the band above) never loaded.
MUTANT = ('if (iy >= 0 && iy < H) {', 'if (iy >= 0 && iy < H && t > 0) {')
# The tap gradient's faults: the last x row of every tile (the bottom halo row,
# or the last row the ring takes in) never staged; the last partial never added.
DW_MUTANTS = {'dw_halo': ('y0 - P, nr + K - 1, x0 - P', 'y0 - P, nr + K - 2, x0 - P'),
              'dw_partial': ('for (int p = 0; p < parts; ++p)', 'for (int p = 1; p < parts; ++p)')}


def _start_build(gxx: str, src: Path, lib: Path, *defines: str) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', f'-I{EMU}',
           f'-DKERNEL_SOURCE="{src}"', *defines, str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source as the card builds it, with bands of 3 rows, the mutant with
    bands of 3 rows and the tap gradient's mutants, all g++ runs started
    together -> name: library."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_dwconv')
    src = _build.CSRC / 'dwconv.cu'
    text = src.read_text()
    rows = f'-DSLOWTV_DWCONV_ROWS={BAND_ROWS}'
    specs = [('card', src, ()), ('bands', src, (rows,))]
    for name, (old, new), defines in [('mutant', MUTANT, (rows,)),
                                      *((n, m, ()) for n, m in DW_MUTANTS.items())]:
        assert text.count(old) == 1, old
        (tmp / f'{name}.cu').write_text(text.replace(old, new))
        specs.append((name, tmp / f'{name}.cu', defines))
    builds = {name: (tmp / f'lib{name}.so', _start_build(gxx, s, tmp / f'lib{name}.so', *d))
              for name, s, d in specs}
    out = {}
    for name, (lib, proc) in builds.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        out[name] = ctypes.CDLL(str(lib))
        for entry in (FWD, DW):
            fn = getattr(out[name], entry)
            fn.argtypes, fn.restype = _build.SIGNATURES[entry], ctypes.c_int
    return out


def _args(b, h, w, c, k, seed=0):
    rs = np.random.RandomState(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32))
    return rand(b, h, w, c), rand(c, 1, k, k, scale=1 / k), rand(c, scale=0.1)


def _fwd(lib, x, wt, bias):
    """The C entry on CPU tensors -> (err, out); out starts as NaN."""
    out = torch.full(x.shape, float('nan'))
    b, h, w, c = x.shape
    err = getattr(lib, FWD)(x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
                            out.data_ptr(), b, h, w, c, wt.shape[-1], 0, None)
    return err, out


def _fwd_err(lib, x, wt, bias) -> float:
    err, out = _fwd(lib, x, wt, bias)
    assert err == 0
    assert torch.isfinite(out).all()  # every output written
    want = depthwise_conv_plain(x.double(), wt.double(), None if bias is None else bias.double())
    return float((out.double() - want).abs().max())


# (b, h, w, c, k): every K on the float4 path; ragged C (the scalar path) at
# K = 7 and 3; rows shorter than a strip; one row; heights under the halo.
CASES = [(2, 7, 9, 40, 1), (2, 7, 9, 40, 3), (2, 7, 9, 40, 5), (2, 7, 9, 40, 7),
         (2, 7, 9, 40, 9), (1, 9, 13, 45, 7), (2, 6, 11, 70, 3), (1, 1, 3, 8, 7),
         (1, 4, 2, 36, 9), (3, 2, 5, 4, 5)]


@pytest.mark.parametrize('lib', ['card', 'bands'])
@pytest.mark.parametrize('b,h,w,c,k', CASES)
def test_forward_source_on_the_cpu_matches_plain(libs, lib, b, h, w, c, k):
    assert _fwd_err(libs[lib], *_args(b, h, w, c, k)) <= ATOL


@pytest.mark.parametrize('lib', ['card', 'bands'])
def test_forward_without_bias_and_off_alignment(libs, lib):
    """No bias (the input gradient's call); a view one float into its buffer
    (C % 4 == 0, but not 16-byte aligned: the scalar path)."""
    x, wt, _ = _args(2, 8, 9, 40, 7, seed=1)
    assert _fwd_err(libs[lib], x, wt, None) <= ATOL
    buf = torch.empty(x.numel() + 1)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    assert _fwd_err(libs[lib], view, wt, None) <= ATOL


def test_band_build_drops_a_halo_row_and_fails(libs):
    """Bands of 3 rows in an image of 8: the comparison must catch the mutant."""
    args = _args(2, 8, 9, 40, 7, seed=2)
    assert _fwd_err(libs['bands'], *args) <= ATOL
    assert _fwd_err(libs['mutant'], *args) > 100 * ATOL


def test_forward_refuses_an_even_kernel(libs):
    x, wt, bias = _args(1, 3, 3, 4, 3)
    err, out = _fwd(libs['card'], x, torch.zeros(4, 1, 4, 4), bias)
    assert err != 0 and torch.isnan(out).all()


def _dw_args(b, h, w, c, seed=3):
    """x and a cotangent scaled so that the taps are O(1)."""
    x = _args(b, h, w, c, 1, seed=seed)[0]
    g = torch.from_numpy((np.random.RandomState(seed + 1).standard_normal((b, h, w, c))
                          / np.sqrt(b * h * w)).astype(np.float32))
    return x, g


def _dw(lib, x, g, k, plan):
    """The C entry on CPU tensors and a plan -> (err, dw); dw and the
    partials start as NaN."""
    b, h, w, c = x.shape
    rows, splits, cluster = plan
    partial = torch.full((splits // cluster, c, k * k), float('nan'))
    dw = torch.full((c, 1, k, k), float('nan'))
    err = getattr(lib, DW)(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                           b, h, w, c, k, rows, splits, cluster, 0, None)
    return err, dw


def _dw_err(lib, x, g, k, plan) -> float:
    err, dw = _dw(lib, x, g, k, plan)
    assert err == 0
    assert torch.isfinite(dw).all()  # every tap written
    return float((dw.double() - dwconv_dw_plain(x.double(), g.double(), k)).abs().max())


@pytest.mark.parametrize('b,h,w,c,k', [(2, 7, 9, 40, 7), (1, 9, 13, 45, 3)])
def test_tap_gradient_source_on_the_cpu_matches_plain(libs, b, h, w, c, k):
    """On the plan the wrapper makes on an H100 (at these sizes: one tile per image)."""
    x, g = _dw_args(b, h, w, c)
    assert _dw_err(libs['card'], x, g, k, dw_plan(b, h, w, c, k, 132)) <= ATOL


@pytest.mark.parametrize('k', [1, 3, 5, 7, 9])
def test_tap_gradient_every_k(libs, k):
    """Tiles of 3 rows, 4 blocks per group (runs that start mid-strip and
    walk down several bands), clusters of 2, two partials; a strip of 20
    columns and a short one."""
    x, g = _dw_args(2, 11, 23, 40)
    assert _dw_err(libs['card'], x, g, k, (3, 4, 2)) <= ATOL


# (b, h, w, c, k, plan): one block per group walking every tile of the image
# pair (across strips and images); one-row tiles; splits that do not divide
# the tiles; a cluster that is every block of its group (one partial: dw
# written by the cluster); clusters of 3; a short last band; ragged C on the
# scalar copies (45, 70) and on the float4 ones (36: 2 groups, the second of
# 4 channels); tiles taller than the image; tiles of 12 and 10 rows (warps
# taking two rows a tile) with a last band of 1 row.
PLANS = [(2, 11, 23, 40, 7, (2, 1, 1)), (1, 8, 9, 36, 7, (1, 3, 1)),
         (2, 9, 25, 40, 5, (4, 5, 1)), (1, 13, 21, 40, 7, (3, 3, 3)),
         (2, 10, 9, 45, 7, (3, 6, 3)), (1, 9, 13, 70, 9, (2, 2, 2)),
         (2, 6, 11, 70, 3, (4, 3, 1)), (1, 5, 7, 36, 7, (8, 2, 2)),
         (1, 25, 21, 40, 7, (12, 2, 1)), (2, 21, 9, 36, 5, (10, 3, 3))]


@pytest.mark.parametrize('b,h,w,c,k,plan', PLANS)
def test_tap_gradient_across_tile_block_and_cluster_boundaries(libs, b, h, w, c, k, plan):
    x, g = _dw_args(b, h, w, c, seed=5)
    assert _dw_err(libs['card'], x, g, k, plan) <= ATOL


def test_tap_gradient_off_alignment_and_repeatable(libs):
    """A view one float into its buffer (C % 4 == 0 but not 16-byte
    aligned: the scalar staging) gives the aligned view's taps; two calls are
    bitwise equal on both paths."""
    x, g = _dw_args(2, 9, 13, 40, seed=7)
    buf = torch.empty(x.numel() + 1)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    plan = (2, 4, 2)
    runs = [_dw(libs['card'], t, g, 7, plan) for t in (x, x, view, view)]
    assert all(err == 0 for err, _ in runs)
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[2][1], runs[3][1])
    want = dwconv_dw_plain(x.double(), g.double(), 7)
    assert float((runs[2][1].double() - want).abs().max()) <= ATOL


@pytest.mark.parametrize('mutant', sorted(DW_MUTANTS))
def test_tap_gradient_mutant_fails(libs, mutant):
    """Tiles of 2 rows walked down an image of 9 by 3 blocks a group, in
    clusters of 1: the comparison must catch each mutant."""
    x, g = _dw_args(2, 9, 13, 40, seed=9)
    plan = (2, 3, 1)
    assert _dw_err(libs['card'], x, g, 7, plan) <= ATOL
    err, dw = _dw(libs[mutant], x, g, 7, plan)
    assert err == 0
    want = dwconv_dw_plain(x.double(), g.double(), 7)
    assert not float((dw.double() - want).abs().max()) <= 100 * ATOL


@pytest.mark.parametrize('k,plan', [(7, (2, 3, 2)), (7, (2, 9, 9)), (7, (0, 1, 1)),
                                    (7, (2, 0, 1)), (7, (500, 1, 1)), (4, (2, 1, 1))])
def test_tap_gradient_refuses_a_plan_it_cannot_run(libs, k, plan):
    """Splits that clusters do not divide, clusters over 8 blocks, no rows,
    no blocks, tiles beyond the shared memory, an even K: refused, dw untouched."""
    x, g = _dw_args(1, 6, 7, 8)
    err, dw = _dw(libs['card'], x, g, k, plan)
    assert err != 0 and torch.isnan(dw).all()
