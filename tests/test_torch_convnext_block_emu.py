"""The fused ConvNeXt block's CUDA source, run on the CPU.

There is no nvcc and no card here, but `csrc/convnext_block.cu` uses only
barriers, warp shuffles, read-only loads, thread-block clusters and plain C++,
so `tests/cuda_emu` (a stand-in `cuda_runtime.h` and `cooperative_groups.h`
and a small runtime: one `std::thread` per CUDA thread, `std::barrier`s, a
cluster's blocks run together, shared memory filled with NaN first) lets g++
build the very same file. Its C entry point is then called through ctypes on
CPU tensors and held against the plain PyTorch version in float64: the
indexing, the masks of ragged tiles, the cluster's split of pixels and hidden
chunks and its sum all run as written. What the card alone can show (that nvcc
takes the file, timing, a race the CPU's schedule hides) stays with
`tests/test_torch_cuda.py` and `chip_smoke.py`.

Tolerance: 1e-5 of max|y| (float32 sums of up to 4C products in another order
than float64; measured ~5e-7).
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

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
ENTRY = 'slowtv_convnext_block_fwd_f32'
RTOL = 1e-5


@pytest.fixture(scope='module')
def kernel(tmp_path_factory):
    """The kernel source built for the CPU -> its C entry point."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA source for the CPU')
    lib = tmp_path_factory.mktemp('cuda_emu') / 'libconvnext_block_emu.so'
    src = _build.CSRC / 'convnext_block.cu'
    cmd = [gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', f'-I{EMU}',
           f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'), '-o', str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    fn = getattr(ctypes.CDLL(str(lib)), ENTRY)
    fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
    return fn


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
