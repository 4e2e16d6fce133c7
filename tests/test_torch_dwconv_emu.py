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
from slowtv_monodepth_tpu_torch.ops.dwconv import depthwise_conv_plain, dw_blocks, dwconv_dw_plain

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
FWD = 'slowtv_dwconv_fwd_f32'
DW = 'slowtv_dwconv_dw_f32'
ATOL = 1e-5
BAND_ROWS = 3
# The fault the band build must catch: each band's first input row (its top
# halo row, the last row of the band above) never loaded.
MUTANT = ('if (iy >= 0 && iy < H) {', 'if (iy >= 0 && iy < H && t > 0) {')


def _start_build(gxx: str, src: Path, lib: Path, *defines: str) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', f'-I{EMU}',
           f'-DKERNEL_SOURCE="{src}"', *defines, str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source as the card builds it, with bands of 3 rows, and the
    mutant with bands of 3 rows, all g++ runs started together -> name: library."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_dwconv')
    src = _build.CSRC / 'dwconv.cu'
    mutant = tmp / 'mutant.cu'
    text = src.read_text()
    assert text.count(MUTANT[0]) == 1
    mutant.write_text(text.replace(*MUTANT))
    rows = f'-DSLOWTV_DWCONV_ROWS={BAND_ROWS}'
    builds = {name: (tmp / f'lib{name}.so', _start_build(gxx, s, tmp / f'lib{name}.so', *d))
              for name, s, d in (('card', src, ()), ('bands', src, (rows,)),
                                 ('mutant', mutant, (rows,)))}
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


@pytest.mark.parametrize('b,h,w,c,k', [(2, 7, 9, 40, 7), (1, 9, 13, 45, 3)])
def test_tap_gradient_source_on_the_cpu_matches_plain(libs, b, h, w, c, k):
    x, _, _ = _args(b, h, w, c, k, seed=3)
    g = torch.from_numpy((np.random.RandomState(4).standard_normal((b, h, w, c))
                          / np.sqrt(b * h * w)).astype(np.float32))
    nblk = dw_blocks(b, h, w, c)
    partial = torch.full((nblk, k * k, c), float('nan'))
    dw = torch.full((c, 1, k, k), float('nan'))
    err = getattr(libs['card'], DW)(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                    b, h, w, c, k, nblk, 0, None)
    assert err == 0
    want = dwconv_dw_plain(x.double(), g.double(), k)
    assert float((dw.double() - want).abs().max()) <= ATOL
