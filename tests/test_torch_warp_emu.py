"""The warp's CUDA source (kernels 5 and 6), run on the CPU.

`csrc/warp.cu` launches through `cudaLaunchKernelEx` with dynamic shared
memory only, so `tests/cuda_emu` (one `std::thread` per CUDA thread, shared
memory filled with NaN first) lets g++ build the very file. Its two C
entries, for float32 and for bfloat16 sources, are called through ctypes on
CPU tensors, into outputs filled with NaN, and out, ddx and ddy are held:
- bitwise against `_blend_order`, a numpy re-statement of the kernel's
  `blend` in its float32 operations and their order (each a b + c d as
  fma(a, b, c d), correctly rounded; every other product, sum and difference
  rounded): the emulation builds with -ffp-contract=off, so on the CPU this
  shows what `chip_smoke.py`'s sha256 of the outputs (WARP_SHA256) shows on
  the card;
- against `warp_bilinear_plain` in float64, within `chip_smoke.py`'s
  WARP_ATOL;
- the bfloat16 entry, on a source rounded to bfloat16: bitwise equal to the
  float32 entry on the widened source.
Cases: C = 1, 2, 3, 4 (instances of their own) and 8 (the generic one);
pixels per image off a multiple of the block's 512 and on it; HO, WO other
than H, W (a resample); coords exactly on 0, W - 1 and H - 1, and integer
coords; H = 1 and W = 1; coords staged by 16-byte loads and float by float
(pixels per image not a multiple of 4, or coords that do not start 16-byte
aligned); a bfloat16 source that does not start 4-byte aligned.

Four mutants must fail: ddy as top - bot and a b + c d as fma(c, d, a b)
(the arithmetic; the second is how nvcc contracted the plain expressions in
this body), the last partial block of each image skipped, and the 16-byte
staging of the coords leaving out the last float4 of each run.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu_torch import _build
from slowtv_monodepth_tpu_torch.ops import sample
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

EMU = _build.CSRC.parents[1] / 'tests' / 'cuda_emu'
ENTRIES = ('slowtv_warp_bilinear_f32', 'slowtv_warp_bilinear_packed_bf16')
ATOL = 1e-5  # chip_smoke.py's WARP_ATOL
# name -> (old, new) in warp.cu
MUTANTS = {
    'ddy_sign': ('*gy = __fsub_rn(bot, top);', '*gy = __fsub_rn(top, bot);'),
    'other_product_fused': ('return __fmaf_rn(a, b, __fmul_rn(c, d));',
                            'return __fmaf_rn(c, d, __fmul_rn(a, b));'),
    'partial_block': ('(per_image + kPixels - 1) / kPixels;', 'per_image / kPixels;'),
    'staging': ('if (4 * k >= n) continue;', 'if (4 * k + 4 >= n) continue;'),
}


def _start_build(gxx: str, src, lib) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared', '-fPIC', '-pthread',
           f'-I{EMU}', f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source and its mutants built for the CPU, all g++ runs started
    together (each mutant from a copy of the source with one edit)."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_warp')
    procs = {'source': _start_build(gxx, _build.CSRC / 'warp.cu', tmp / 'libsource.so')}
    for name, (old, new) in MUTANTS.items():
        text = (_build.CSRC / 'warp.cu').read_text()
        assert text.count(old) == 1, (name, old)
        (tmp / f'{name}.cu').write_text(text.replace(old, new))
        procs[name] = _start_build(gxx, tmp / f'{name}.cu', tmp / f'lib{name}.so')
    out = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(tmp / f'lib{name}.so'))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build.SIGNATURES[entry], ctypes.c_int
        out[name] = lib
    return out


def _shifted(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of `t` that starts `elems` elements into its storage."""
    flat = torch.cat([torch.zeros(elems, dtype=t.dtype), t.flatten()])[elems:]
    return flat.view(t.shape)


def _case(b, h, w, c, ho, wo, coords, seed):
    """img uniform in [0, 1); coords: 'random' uniform over the image,
    'near' a near-identity warp as view synthesis gives it (a resample when
    ho, wo differ from h, w), 'grid' the image's bounds and integers only."""
    rs = np.random.RandomState(seed)
    img = torch.from_numpy(rs.rand(b, h, w, c).astype(np.float32))
    if coords == 'random':
        fx = rs.uniform(-0.2, 1.2, (b, ho, wo)) * (w - 1)
        fy = rs.uniform(-0.2, 1.2, (b, ho, wo)) * (h - 1)
    elif coords == 'near':
        ys, xs = np.meshgrid(np.arange(ho) * (h / ho), np.arange(wo) * (w / wo), indexing='ij')
        fx = xs + 2 + rs.standard_normal((b, ho, wo))
        fy = ys + 0.5 * rs.standard_normal((b, ho, wo))
    else:
        fx = rs.choice([0.0, 1.0, w - 1.0, w / 2, (w - 1) / 3], (b, ho, wo))
        fy = rs.choice([0.0, 1.0, h - 1.0, h / 2, (h - 1) / 3], (b, ho, wo))
    fx, fy = (torch.from_numpy(np.clip(f, 0, n - 1).astype(np.float32))
              for f, n in ((fx, w), (fy, h)))
    return img, fx, fy


def _run(lib, entry, img, fx, fy):
    """The C entry -> (err, (out, ddx, ddy)), NaN where not written."""
    b, h, w, c = img.shape
    ho, wo = fx.shape[1:]
    outs = tuple(torch.full((b, ho, wo, c), float('nan')) for _ in range(3))
    err = getattr(lib, entry)(*(t.data_ptr() for t in (img, fx, fy, *outs)), b, h, w, c, ho,
                              wo, 0, None)
    return err, outs


def _fma32(a, b, c) -> np.ndarray:
    """fma(a, b, c) of float32 arrays, rounded once to float32: a b is exact
    in float64, the sum's rounding error comes from TwoSum, and the sum
    rounded to odd in float64 then to nearest in float32 is the correctly
    rounded result (53 >= 24 + 2 bits)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)
    to_odd = (e != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(to_odd, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _mix(a, b, c, d) -> np.ndarray:
    """The kernel's a b + c d: fma(a, b, c d)."""
    return _fma32(a, b, c * d)


def _blend_order(img, fx, fy):
    """The kernel's outputs by numpy float32 operations, each rounded once,
    in the order of `blend`."""
    f = np.float32
    img, fx, fy = img.float().numpy(), fx.numpy(), fy.numpy()
    b, h, w, _ = img.shape
    x0f, y0f = np.floor(fx), np.floor(fy)
    wx, wy = (fx - x0f)[..., None], (fy - y0f)[..., None]
    x0 = np.clip(x0f.astype(np.int64), 0, w - 1)
    y0 = np.clip(y0f.astype(np.int64), 0, h - 1)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    i = np.arange(b)[:, None, None]
    v00, v01, v10, v11 = img[i, y0, x0], img[i, y0, x1], img[i, y1, x0], img[i, y1, x1]
    ux, uy = f(1) - wx, f(1) - wy
    top, bot = _mix(v00, ux, v01, wx), _mix(v10, ux, v11, wx)
    return _mix(top, uy, bot, wy), _mix(v01 - v00, uy, v11 - v10, wy), bot - top


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# (b, h, w, c, ho, wo, coords, bfloat16 source offset in elements, coords offset in floats):
# 117 pixels an image (float by float), 960 (a block and a partial one, by
# float4), 512 (on the block's edge), a resample of 1023 pixels, 512 on the
# image's bounds and integers, the generic C = 8, H = 1, W = 1, coords that
# start 4 bytes past 16-byte alignment, the ragged case of chip_smoke.py; the
# feature widths of the generic C that feature reconstruction warps (C = 64: a
# ResNet-18's stride-4 map; C = 128: ConvNeXt-B's), a run of 512 pixels and a part.
CASES = [(2, 9, 13, 3, 9, 13, 'random', 1, 0), (1, 24, 40, 3, 24, 40, 'near', 0, 0),
         (2, 16, 32, 1, 16, 32, 'random', 1, 0), (1, 20, 30, 2, 33, 31, 'near', 1, 0),
         (2, 7, 11, 4, 8, 64, 'grid', 1, 0), (1, 5, 7, 8, 9, 4, 'random', 1, 0),
         (1, 1, 17, 3, 5, 6, 'random', 0, 0), (2, 13, 1, 2, 7, 5, 'grid', 1, 0),
         (1, 12, 20, 3, 12, 20, 'near', 1, 1), (3, 37, 53, 3, 29, 41, 'random', 0, 0),
         (2, 16, 36, 64, 16, 36, 'near', 1, 0), (1, 12, 19, 128, 23, 25, 'random', 0, 0)]


@pytest.mark.parametrize('b,h,w,c,ho,wo,coords,shift16,shift', CASES)
def test_warp_source_on_the_cpu_has_blends_bits(libs, b, h, w, c, ho, wo, coords, shift16,
                                                shift):
    img, fx, fy = _case(b, h, w, c, ho, wo, coords, seed=b * h * w * c + ho)
    if shift:
        fx, fy = _shifted(fx, shift), _shifted(fy, shift)
        assert fx.data_ptr() % 16 and fy.data_ptr() % 16
    err, got = _run(libs['source'], ENTRIES[0], img, fx, fy)
    assert err == 0
    for g, want in zip(got, _blend_order(img, fx, fy)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))
    for g, want in zip(got, sample.warp_bilinear_plain(img.double(), fx.double(), fy.double())):
        assert float((g.double() - want).abs().max()) <= ATOL
    # The bfloat16 entry on the rounded source: the float32 entry's bits on the widened one.
    img16 = _shifted(img.to(torch.bfloat16), shift16)
    assert img16.data_ptr() % 4 == (2 if shift16 else 0)
    err16, got16 = _run(libs['source'], ENTRIES[1], img16, fx, fy)
    assert err16 == 0
    wide = _run(libs['source'], ENTRIES[0], img16.float(), fx, fy)[1]
    for g, want in zip(got16, wide):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want.numpy()))
    for g, want in zip(got16, _blend_order(img16, fx, fy)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))


def test_out_of_range_arguments_are_refused_and_empty_calls_write_nothing(libs):
    img, fx, fy = _case(1, 4, 5, 3, 4, 5, 'random', seed=0)
    out = torch.full((1, 4, 5, 3), float('nan'))
    lib = libs['source']
    for entry in ENTRIES:
        for b, h, w, c in ((1, 0, 5, 3), (1, 4, 0, 3), (1, 4, 5, 0), (-1, 4, 5, 3)):
            assert getattr(lib, entry)(img.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                                       *(out.data_ptr(),) * 3, b, h, w, c, 4, 5, 0, None) != 0
        for b, ho, wo in ((0, 4, 5), (1, 0, 5), (1, 4, 0)):
            assert getattr(lib, entry)(img.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                                       *(out.data_ptr(),) * 3, b, 4, 5, 3, ho, wo, 0, None) == 0
    assert out.isnan().all()


@pytest.mark.parametrize('mutant', list(MUTANTS))
def test_comparison_catches_mutants(libs, mutant):
    img, fx, fy = _case(2, 24, 40, 3, 24, 40, 'near', seed=4)  # a block and a partial one
    for entry, src in zip(ENTRIES, (img, img.to(torch.bfloat16))):
        want = _blend_order(src, fx, fy)
        assert all(np.array_equal(_bits(g.numpy()), _bits(t))
                   for g, t in zip(_run(libs['source'], entry, src, fx, fy)[1], want))
        err, got = _run(libs[mutant], entry, src, fx, fy)
        assert err == 0
        assert not all(np.array_equal(_bits(g.numpy()), _bits(t)) for g, t in zip(got, want))
