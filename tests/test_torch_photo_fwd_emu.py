"""The photometric error's forward CUDA source (kernel 7), run on the CPU.

`csrc/photo.cu` launches through `cudaLaunchKernelEx` with dynamic shared
memory only, so `tests/cuda_emu` (one `std::thread` per CUDA thread, shared
memory filled with NaN first, `cp.async` copies that land only at the wait)
lets g++ build the very file, with its shared header `photo_common.cuh`.
Its C entry is called through ctypes on CPU tensors, into a map filled with
NaN, and the map is held:
- bitwise against `_parent_order`, a numpy float32 re-statement of the
  rounded operations of the kernel as it was before its redesign, in their
  order (row sums (x0 + x1) + x2, squares rounded before their sums, the
  vertical sum (top + middle) + bottom, IEEE divisions by 9, by q r and by
  C, the map accumulated as acc + term / C from 0, channel 0 first). The
  emulation builds with -ffp-contract=off, so on the CPU this shows what
  `chip_smoke.py`'s sha256 of the map (PHOTO_FWD_SHA256) shows on the card;
- against `photo_fwd_plain` in float64, within `chip_smoke.py`'s
  PHOTO_ATOL plus twice the plain float32 version's error.
Cases: C = 1 to 4; h and w off the tile (6 rows x 128 columns); h = 2 and
w = 2; images two and three tiles wide and several tiles high; rows of W C
floats a multiple of 4 (16-byte staging) and not, and an x that does not
start 16-byte aligned (scalar staging); exact ties (x == y on a half), where
the map is exactly 0 on every pixel whose 3 x 3 window lies in the tie half.

Two mutants must fail: the reflect map repeating the edge (2 n - 1 - i, in
the shared header) and the vertical sum taken as top + (middle + bottom).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu_torch import _build
from slowtv_monodepth_tpu_torch.ops import photo
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

EMU = _build.CSRC.parents[1] / 'tests' / 'cuda_emu'
ENTRY = 'slowtv_photo_fwd_f32'
ATOL = 1e-5  # chip_smoke.py's PHOTO_ATOL
W_SSIM = 0.85
# name -> (file, old, new)
MUTANTS = {
    'reflect': ('photo_common.cuh', 'i >= n ? 2 * n - 2 - i : i', 'i >= n ? 2 * n - 1 - i : i'),
    'vertical_order': ('photo.cu', 'add(add(h[i % 3][k], h[(i + 1) % 3][k]), ht[k])',
                       'add(h[i % 3][k], add(h[(i + 1) % 3][k], ht[k]))'),
}


def _start_build(gxx: str, src, lib) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared', '-fPIC', '-pthread',
           f'-I{EMU}', f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source and its mutants built for the CPU, all g++ runs started
    together (each mutant from a copy of the sources with one edit)."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_photo_fwd')
    procs = {'source': _start_build(gxx, _build.CSRC / 'photo.cu', tmp / 'libsource.so')}
    for name, (file, old, new) in MUTANTS.items():
        src = tmp / name
        src.mkdir()
        for f in ('photo.cu', 'photo_common.cuh'):
            shutil.copy(_build.CSRC / f, src / f)
        text = (src / file).read_text()
        assert text.count(old) == 1, (name, old)
        (src / file).write_text(text.replace(old, new))
        procs[name] = _start_build(gxx, src / 'photo.cu', tmp / f'lib{name}.so')
    out = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(tmp / f'lib{name}.so'))
        fn = getattr(lib, ENTRY)
        fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
        out[name] = lib
    return out


def _case(m, h, w, c, seed=0, ties=False, misaligned=False):
    """x, y uniform in [0, 1); y == x on the left half with `ties`; x one
    float into its storage with `misaligned`."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32))
    y = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32))
    if ties:
        y[:, :, : w // 2] = x[:, :, : w // 2]
    if misaligned:
        x = torch.cat([torch.zeros(1), x.flatten()])[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    return x, y


def _run(lib, x, y):
    """The C entry -> (err, map), NaN where not written."""
    m, h, w, c = x.shape
    out = torch.full((m, h, w), float('nan'))
    err = getattr(lib, ENTRY)(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, h, w, c,
                              W_SSIM, 1 - W_SSIM, 0, None)
    return err, out


def _parent_order(x, y) -> np.ndarray:
    """The kernel's map by numpy float32 operations, each rounded, in the
    order of the kernel before its redesign."""
    f = np.float32
    x, y = x.numpy(), y.numpy()
    m, h, w, c = x.shape
    c1, c2 = f(0.01) * f(0.01), f(0.03) * f(0.03)
    w_ssim, w_l1 = f(W_SSIM), f(1 - W_SSIM)
    acc = np.zeros((m, h, w), np.float32)

    def pad(a):
        return np.pad(a, ((0, 0), (1, 1), (1, 1)), mode='reflect')

    def pool(p, q):  # rows (p0 q0 + p1 q1) + p2 q2, then (top + middle) + bottom, / 9
        row = (p[:, :, :w] * q[:, :, :w] + p[:, :, 1:w + 1] * q[:, :, 1:w + 1]) \
            + p[:, :, 2:] * q[:, :, 2:]
        return ((row[:, :h] + row[:, 1:h + 1]) + row[:, 2:]) / f(9)

    for k in range(c):
        xp, yp = pad(x[..., k]), pad(y[..., k])
        one = np.ones_like(xp)
        mx, my = pool(xp, one), pool(yp, one)
        ex2, ey2, exy = pool(xp, xp), pool(yp, yp), pool(xp, yp)
        mxx, myy, mxy = mx * mx, my * my, mx * my
        a = (f(2) * mx) * my + c1
        t = f(2) * (exy - mxy) + c2
        q = (mxx + myy) + c1
        r = ((ex2 - mxx) + (ey2 - myy)) + c2
        s = np.fmin(np.fmax((f(1) - (a * t) / (q * r)) * f(0.5), f(0)), f(1))
        acc = acc + (w_ssim * s + w_l1 * np.abs(x[..., k] - y[..., k])) / f(c)
    return acc


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# (m, h, w, c, ties, misaligned): one tile with h and w off it; h = 2; w = 2;
# both 2; three tiles wide (the third 4 columns) and four tiles high; two
# tiles wide (the second 1-2 columns), two or three high, one exactly; C = 1-4; W C a multiple of 4
# ((1, 9, 2, 2), (1, 2, 2, 4), (1, 19, 260, 3), (2, 11, 130, 2), (1, 6, 129, 4))
# and not; an unaligned x; exact ties on a half.
CASES = [(1, 5, 7, 3, False, False), (2, 2, 9, 1, True, False), (1, 9, 2, 2, False, False),
         (1, 2, 2, 4, False, False), (1, 19, 260, 3, True, False),
         (2, 11, 130, 2, True, False), (1, 13, 255, 1, False, False),
         (1, 6, 129, 4, True, False), (2, 7, 131, 3, True, True)]


@pytest.mark.parametrize('m,h,w,c,ties,misaligned', CASES)
def test_photo_fwd_source_on_the_cpu_has_the_parents_bits(libs, m, h, w, c, ties, misaligned):
    x, y = _case(m, h, w, c, seed=h * w + c, ties=ties, misaligned=misaligned)
    parent = _parent_order(x, y)
    want = photo.photo_fwd_plain(x.double(), y.double(), W_SSIM)
    tol = ATOL + 2 * float((photo.photo_fwd_plain(x, y, W_SSIM).double() - want).abs().max())
    err, out = _run(libs['source'], x, y)
    assert err == 0
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(parent))
    assert float((out.double() - want).abs().max()) <= tol
    if ties:  # every pixel whose 3 x 3 window lies in the tie half
        assert (out[:, :, : w // 2 - 1] == 0).all()


def test_two_calls_are_bitwise_equal(libs):
    x, y = _case(1, 19, 260, 3, seed=3, ties=True)
    first, second = (_run(libs['source'], x, y)[1] for _ in range(2))
    assert torch.equal(first, second)


def test_out_of_range_arguments_are_refused(libs):
    for shape in ((1, 1, 7, 3), (1, 5, 1, 3), (1, 5, 7, 5)):  # h, w < 2; C > 4
        assert _run(libs['source'], *_case(*shape))[0] != 0, shape


@pytest.mark.parametrize('mutant', list(MUTANTS))
def test_comparison_catches_mutants(libs, mutant):
    x, y = _case(2, 13, 140, 3, seed=4, ties=True)
    parent = _parent_order(x, y)
    assert np.array_equal(_bits(_run(libs['source'], x, y)[1].numpy()), _bits(parent))
    err, out = _run(libs[mutant], x, y)
    assert err == 0 and not np.array_equal(_bits(out.numpy()), _bits(parent))
    if mutant == 'reflect':  # off the float64 map too, at the bottom row and right column
        want = photo.photo_fwd_plain(x.double(), y.double(), W_SSIM)
        assert float((out.double() - want).abs().max()) > 100 * ATOL
