"""The decoder stage's backward CUDA source (kernel 4), run on the CPU.

`csrc/decoder_stage_bwd.cu` launches through `cudaLaunchKernelEx` with dynamic
shared memory only, so `tests/cuda_emu` (one `std::thread` per CUDA thread,
shared memory filled with NaN first) lets g++ build the very file. Its C entry
is called through ctypes on CPU tensors (the forward's `ha`, `feat` and `disp`
from the plain stage) and its seven gradients are held against
`fused_upconv_stage_bwd_plain` in float64: grids of 2 and 3, where a reflect
fold lands on the row it left; one decoder channel; CI != CD; channels off 4
(the scalar staging) and over 16 (two weight-set chunks, two channel tiles);
each bit of `need` alone. A mutant whose pre-summed taps for the upsampled
gather swap two parities must fail.

Tolerance: STAGE_BWD_RTOL of `chip_smoke.py`, each gradient to 1e-5 of its
own largest magnitude (float32 sums of at most a few thousand O(1) products
here, against float64; measured below 1e-6).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu_torch import _build
from slowtv_monodepth_tpu_torch.ops import decoder_stage as ds
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
ENTRY = 'slowtv_decoder_stage_bwd_f32'
NAMES = ('dx', 'dwa', 'dba', 'dwb', 'dbb', 'dwo', 'dbo')
RTOL = 1e-5
# The fault the comparison must catch: the pre-summed taps of the 2x upsampled
# gather's second and third offsets ({1, 2} and {0, 1}) swapped.
MUTANT = ('return set == 0 ? 4 : set == 1 ? 6 : set == 2 ? 3 : set == 3 ? 1 : 7;',
          'return set == 0 ? 4 : set == 1 ? 3 : set == 2 ? 6 : set == 3 ? 1 : 7;')


def _start_build(gxx: str, src: Path, lib: Path) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', f'-I{EMU}',
           f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'), '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source and its mutant built for the CPU, both g++ runs started together."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_stage_bwd')
    src = _build.CSRC / 'decoder_stage_bwd.cu'
    mutant = tmp / 'mutant.cu'
    text = src.read_text()
    assert text.count(MUTANT[0]) == 1
    mutant.write_text(text.replace(*MUTANT))
    builds = {name: _start_build(gxx, s, tmp / f'lib{name}.so')
              for name, s in (('source', src), ('mutant', mutant))}
    out = {}
    for name, proc in builds.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(tmp / f'lib{name}.so'))
        fn = getattr(lib, ENTRY)
        fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
        size = lib.slowtv_decoder_stage_bwd_scratch_floats
        size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_longlong
        out[name] = (fn, size)
    return out


def _case(b, h, w, ci, cd, seed=0):
    """Inputs (x, wa, ba, wb, bb, wo, bo), the forward's ha, feat, disp and
    the two cotangents, float32, fan-in scaled."""
    rs = np.random.RandomState(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.standard_normal(shape)).astype(np.float32))
    args = (rand(b, h, w, ci, scale=0.5), rand(cd, ci, 3, 3, scale=1 / np.sqrt(9 * ci)),
            rand(cd, scale=0.1), rand(cd, cd, 3, 3, scale=1 / np.sqrt(9 * cd)),
            rand(cd, scale=0.1), rand(1, cd, 3, 3, scale=1 / np.sqrt(9 * cd)), rand(1, scale=0.1))
    ha = F.elu(ds._conv_reflect(args[0].permute(0, 3, 1, 2), args[1], args[2]))
    ha = ha.permute(0, 2, 3, 1).contiguous()
    feat, disp = ds.fused_upconv_stage_plain(*args)
    return args, (ha, feat, disp), (rand(b, 2 * h, 2 * w, cd), rand(b, 2 * h, 2 * w, 1))


def _run(lib, args, saved, cots, need=15):
    """The C entry -> (err, seven gradients); a gradient not asked for is None."""
    fn, size = lib
    x = args[0]
    b, h, w, ci = x.shape
    cd = args[1].shape[0]
    need7 = [need & 1, need & 2, need & 2, need & 4, need & 4, need & 8, need & 8]
    outs = [torch.full_like(t, float('nan')) if n else None for t, n in zip(args, need7)]
    scratch = torch.full((size(b, h, w, ci, cd),), float('nan'))
    err = fn(*(t.data_ptr() for t in (x, args[1], args[3], args[5], *saved, *cots, scratch)),
             *(None if o is None else o.data_ptr() for o in outs), b, h, w, ci, cd, need, 0, None)
    return err, outs


def _errs(got, want) -> dict:
    return {k: float((g.double() - t).abs().max()) / (float(t.abs().max()) or 1.0)
            for k, g, t in zip(NAMES, got, want) if g is not None}


# (b, h, w, ci, cd): grids of 2 and 3 both ways; one decoder channel; ci != cd
# off 4 (scalar staging); ci over 16 and cd over 16 (two channel tiles, two
# weight-set chunks); a wider grid (two band tiles across).
CASES = [(1, 2, 3, 4, 3), (2, 3, 2, 2, 2), (1, 2, 2, 3, 1), (1, 3, 3, 5, 7), (2, 4, 5, 6, 5),
         (1, 3, 4, 20, 17), (1, 2, 17, 8, 4)]


@pytest.mark.parametrize('b,h,w,ci,cd', CASES)
def test_stage_backward_source_on_the_cpu_matches_plain(libs, b, h, w, ci, cd):
    args, saved, cots = _case(b, h, w, ci, cd)
    err, got = _run(libs['source'], args, saved, cots)
    assert err == 0
    assert all(torch.isfinite(g).all() for g in got)  # every value written
    want = ds.fused_upconv_stage_bwd_plain(*(t.double() for t in (*args, *cots)))
    errs = _errs(got, want)
    assert max(errs.values()) <= RTOL, errs


@pytest.mark.parametrize('need', [1, 2, 4, 8])
def test_each_need_bit_alone(libs, need):
    """One bit of `need`: its gradients right, the others never written."""
    args, saved, cots = _case(1, 3, 4, 6, 5, seed=need)
    err, got = _run(libs['source'], args, saved, cots, need)
    assert err == 0
    want = ds.fused_upconv_stage_bwd_plain(*(t.double() for t in (*args, *cots)))
    errs = _errs(got, want)
    assert len(errs) == (1 if need == 1 else 2) and max(errs.values()) <= RTOL, errs


def test_two_calls_are_bitwise_equal(libs):
    args, saved, cots = _case(2, 4, 5, 6, 5, seed=3)
    first, second = (_run(libs['source'], args, saved, cots)[1] for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_comparison_catches_swapped_parities(libs):
    args, saved, cots = _case(2, 4, 5, 6, 5, seed=4)
    want = ds.fused_upconv_stage_bwd_plain(*(t.double() for t in (*args, *cots)))
    assert max(_errs(_run(libs['source'], args, saved, cots)[1], want).values()) <= RTOL
    err, got = _run(libs['mutant'], args, saved, cots)
    errs = _errs(got, want)
    assert err == 0 and max(errs['dx'], errs['dwa']) > 100 * RTOL, errs
