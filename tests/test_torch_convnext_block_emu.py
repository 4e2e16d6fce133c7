"""The fused ConvNeXt block's CUDA sources, run on the CPU.

There is no nvcc and no card here, but `csrc/convnext_block.cu` (kernel 9,
forward) and `csrc/convnext_block_bwd.cu` (kernel 10, backward) use only
barriers, warp shuffles, read-only loads, thread-block clusters and plain C++,
so `tests/cuda_emu` (a stand-in `cuda_runtime.h` and `cooperative_groups.h`
and a small runtime: one `std::thread` per CUDA thread, `std::barrier`s, a
cluster's blocks run together, shared memory filled with NaN first) lets g++
build the very same files. Their C entry points are then called through ctypes
on CPU tensors and held against the plain PyTorch versions in float64: the
indexing, the masks of ragged tiles, the cluster's split of pixels and hidden
chunks and its sum, the backward's transposed weight reads, its pixel groups
and its fixed-order partial sums all run as written. What the card alone can
show (that nvcc takes the files, timing, a race the CPU's schedule hides) stays
with `tests/test_torch_cuda.py` and `chip_smoke.py`.

Tolerances: forward 1e-5 of max|y| (float32 sums of up to 4C products in
another order than float64; measured ~5e-7); backward 1e-5 of each gradient's
own largest magnitude (float32 products and pixel sums of a few hundred terms;
measured below 2e-6).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu_torch import _build
from slowtv_monodepth_tpu_torch.ops import convnext_block as cb
from slowtv_monodepth_tpu_torch.ops.dwconv import depthwise_conv_plain, dwconv_dw_plain

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
ENTRY = 'slowtv_convnext_block_fwd_f32'
BWD_ENTRY = 'slowtv_convnext_block_bwd_f32'
NAMES = ('dx', 'dw_weight', 'dw_bias', 'ln_weight', 'ln_bias', 'fc1_weight', 'fc1_bias',
         'fc2_weight', 'fc2_bias', 'gamma')
RTOL = 1e-5
BWD_RTOL = 1e-5
# Faults injected into a copy of the backward's sources, each of which the
# comparison must catch: the vector partials of one tile in eight dropped, and
# a transposed weight tile stored with two of its values swapped.
MUTANTS = {
    'dropped_partial': ('convnext_block_bwd.cu', 'for (int i = row; i < tiles;',
                        'for (int i = row + (row == 1); i < tiles;'),
    'wrong_transposed_index': ('convnext_common.cuh', 'Ws[(n + 1) * kWS + k] = pre[i].y;',
                               'Ws[(n + 1) * kWS + k] = pre[i].z;'),
}


def _start_build(gxx: str, src: Path, lib: Path) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', f'-I{EMU}',
           f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """Both sources and the backward's mutants built for the CPU, all g++ runs
    started together -> name: ctypes library."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu')
    builds = {name: (tmp / f'lib{name}.so', _start_build(gxx, _build.CSRC / f'{name}.cu',
                                                         tmp / f'lib{name}.so'))
              for name in ('convnext_block', 'convnext_block_bwd')}
    for name, (file, old, new) in MUTANTS.items():
        src = tmp / name
        shutil.copytree(_build.CSRC, src)
        text = (src / file).read_text()
        assert text.count(old) == 1, (name, old)
        (src / file).write_text(text.replace(old, new))
        builds[name] = (tmp / f'lib{name}.so',
                        _start_build(gxx, src / 'convnext_block_bwd.cu', tmp / f'lib{name}.so'))
    out = {}
    for name, (lib, proc) in builds.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        out[name] = ctypes.CDLL(str(lib))
    return out


@pytest.fixture(scope='module')
def kernel(libs):
    """Kernel 9's C entry point, built for the CPU."""
    fn = getattr(libs['convnext_block'], ENTRY)
    fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
    return fn


def _bwd_entry(lib):
    fn = getattr(lib, BWD_ENTRY)
    fn.argtypes, fn.restype = _build.SIGNATURES[BWD_ENTRY], ctypes.c_int
    size = lib.slowtv_convnext_block_bwd_scratch_floats
    size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    return fn, size


def _args(b, h, w, c, seed=0):
    rs = np.random.RandomState(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32))
    return (rand(b, h, w, c), rand(c, 1, 7, 7, scale=1 / 7), rand(c, scale=0.1),
            1 + rand(c, scale=0.1), rand(c, scale=0.1), rand(4 * c, c, scale=c ** -0.5),
            rand(4 * c, scale=0.1), rand(c, 4 * c, scale=(4 * c) ** -0.5), rand(c, scale=0.1),
            rand(c, scale=0.5))


def _run(kernel, args, m, s, approximate=False):
    out = torch.full_like(args[0], float('nan'))
    err = kernel(*(t.data_ptr() for t in args), out.data_ptr(), *args[0].shape, m, s,
                 int(approximate), 0, None)
    return err, out


# (b, h, w, c, pixels per tile, blocks per cluster, tanh): pixel counts off the
# tile, rows shorter than a 4-pixel strip and rows of whole strips, heights
# under the 7x7 halo, channels off 32 and over 256 (two fc2 panels, the taps'
# channel loop), a hidden size off 256, clusters with idle blocks (more blocks
# than strips) and every cluster size.
CASES = [(1, 5, 6, 8, 8, 1, False), (2, 4, 7, 40, 16, 1, True), (1, 9, 5, 96, 32, 2, False),
         (1, 3, 3, 264, 8, 4, False), (1, 2, 40, 72, 32, 2, True), (1, 4, 8, 160, 16, 2, False),
         (1, 2, 8, 512, 8, 8, True), (2, 3, 4, 128, 32, 2, False), (1, 4, 8, 512, 16, 8, False),
         (1, 6, 8, 256, 32, 4, True), (1, 1, 1, 8, 8, 1, False), (1, 7, 12, 128, 32, 1, False)]


@pytest.mark.parametrize('b,h,w,c,m,s,approximate', CASES)
def test_cuda_source_on_the_cpu_matches_plain(kernel, b, h, w, c, m, s, approximate):
    args = _args(b, h, w, c)
    err, out = _run(kernel, args, m, s, approximate)
    assert err == 0
    want = cb.fused_convnext_block_plain(*(t.double() for t in args), approximate=approximate)
    assert torch.isfinite(out).all()  # every output written, nothing read unwritten
    assert float((out.double() - want).abs().max()) <= RTOL * float(want.abs().max())


@pytest.mark.parametrize('h,w,c,want', [(5, 7, 96, (32, 2)), (3, 4, 40, (32, 1)),
                                        (10, 10, 264, (32, 4)), (4, 5, 512, (32, 8))])
def test_cuda_source_takes_the_tile_and_cluster_the_wrapper_picks(kernel, h, w, c, want):
    """What `fused_convnext_block` would launch for these few-pixel shapes."""
    m, s = cb.tile_pixels(h * w, c)
    assert (m, s) == want
    args = _args(1, h, w, c, seed=1)
    err, out = _run(kernel, args, m, s)
    assert err == 0
    want = cb.fused_convnext_block_plain(*(t.double() for t in args))
    assert float((out.double() - want).abs().max()) <= RTOL * float(want.abs().max())


@pytest.mark.parametrize('m,s,c', [(12, 1, 8), (32, 3, 512), (32, 8, 128), (8, 1, 6)])
def test_cuda_entry_refuses_what_it_was_not_built_for(kernel, m, s, c):
    """A tile size with no instance, a cluster size that is no power of two or
    exceeds the hidden chunks, channels off 4: an error code, no launch."""
    args = _args(1, 2, 2, c if c % 4 == 0 else 8)
    out = torch.zeros_like(args[0])
    err = kernel(*(t.data_ptr() for t in args), out.data_ptr(), 1, 2, 2, c, m, s, 0, 0, None)
    assert err != 0 and not out.any()


# ------------------------------------------------------------ kernel 10 (backward)
def _run_bwd(lib, args, dy, m, approximate=False):
    """The C entry -> (err, the ten gradients), dx and the taps' gradient
    finished from du by the plain depthwise transposes in float64."""
    fn, size = _bwd_entry(lib)
    x = args[0]
    b, h, w, c = x.shape
    du = torch.full_like(x, float('nan'))
    grads = [torch.full_like(t, float('nan')) for t in args[2:]]
    scratch = torch.full((size(b, h, w, c, m),), float('nan'))
    err = fn(*(t.data_ptr() for t in (x, dy, *args[1:], du, *grads, scratch)), b, h, w, c, m,
             int(approximate), 0, None)
    dud = du.double()
    dx = dy.double() + depthwise_conv_plain(dud, args[1].double().flip((-2, -1)))
    return err, (dx, dwconv_dw_plain(x.double(), dud, 7), *grads), du


def _bwd_err(got, want) -> list[float]:
    return [float((g.double() - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]


# (b, h, w, c, pixels per tile, tanh): a ragged tile under one pixel group;
# channels off 32 with a hidden size under 256; two hidden chunks (the second
# ragged); pixel groups of the weight gradients; every tile size; one image
# row; more than 256 channels (two panels of dxln).
BWD_CASES = [(1, 5, 6, 8, 8, False), (2, 4, 7, 40, 16, True), (1, 9, 12, 64, 32, False),
             (1, 3, 20, 72, 8, True), (3, 6, 11, 32, 16, True), (1, 1, 9, 16, 32, False),
             (1, 2, 5, 264, 8, False)]


@pytest.mark.parametrize('b,h,w,c,m,approximate', BWD_CASES)
def test_backward_cuda_source_on_the_cpu_matches_plain(libs, b, h, w, c, m, approximate):
    args = _args(b, h, w, c, seed=2)
    dy = torch.from_numpy(np.random.RandomState(3).standard_normal((b, h, w, c)).astype(np.float32))
    err, got, du = _run_bwd(libs['convnext_block_bwd'], args, dy, m, approximate)
    assert err == 0
    assert torch.isfinite(du).all() and all(torch.isfinite(g).all() for g in got)
    want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])),
                                             approximate=approximate)
    errs = _bwd_err(got, want)
    assert max(errs) <= BWD_RTOL, dict(zip(NAMES, errs))


@pytest.mark.parametrize('mutant', sorted(MUTANTS))
def test_backward_comparison_catches_an_injected_fault(libs, mutant):
    args = _args(2, 6, 11, 48, seed=4)
    dy = torch.from_numpy(np.random.RandomState(5).standard_normal((2, 6, 11, 48)).astype(np.float32))
    want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])))
    assert max(_bwd_err(_run_bwd(libs['convnext_block_bwd'], args, dy, 16)[1], want)) <= BWD_RTOL
    err, got, _ = _run_bwd(libs[mutant], args, dy, 16)
    assert err == 0 and max(_bwd_err(got, want)) > 100 * BWD_RTOL


def test_backward_takes_the_tile_the_wrapper_picks_and_refuses_others(libs):
    """`bwd_tile_pixels` at the pose net's first stage width, and a tile size
    with no instance (an error code, nothing written)."""
    m = cb.bwd_tile_pixels(96)
    assert m == 32
    args = _args(1, 3, 4, 96, seed=6)
    dy = torch.ones(1, 3, 4, 96)
    err, got, _ = _run_bwd(libs['convnext_block_bwd'], args, dy, m)
    want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])))
    assert err == 0 and max(_bwd_err(got, want)) <= BWD_RTOL
    err, _, du = _run_bwd(libs['convnext_block_bwd'], args, dy, 12)
    assert err != 0 and torch.isnan(du).all()
