"""The fused ConvNeXt block's CUDA sources, run on the CPU.

There is no nvcc and no card here, but `csrc/convnext_block.cu` (kernel 9,
forward) and `csrc/convnext_block_bwd.cu` (kernel 10, backward) use only
barriers, warp shuffles, read-only loads, thread-block clusters, `cp.async`
copies and plain C++, so `tests/cuda_emu` (a stand-in `cuda_runtime.h`,
`cooperative_groups.h` and `cuda_pipeline_primitives.h`, whose copies land
only when their thread waits for them, and a small runtime: one `std::thread`
per CUDA thread, `std::barrier`s, a cluster's blocks run together, shared
memory filled with NaN first) lets g++ build the very same files. Their C
entry points are then called through ctypes on CPU tensors and held against
the plain PyTorch versions in float64: the indexing, the masks of ragged
tiles, the cluster's split of pixels and hidden chunks and its sum, the
backward's staged slabs (transposed and not), its epilogues, its float chains
of pixels, its splits and its fixed-order partial sums all run as written. What the card alone can
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
# Faults injected into a copy of the backward's source, each of which the
# comparison must catch: one pixel tile's vector partials in eight dropped
# from the finishing sums; the transposed copy of dh1 stored with two of its
# pixels swapped; a bias read one column off in the mlp tiles' epilogue; the
# column sums of dh1 taking in the rows past the last pixel (the padding of
# the transposed activations' rows); the second float chain of each
# weight-gradient split dropped.
MUTANTS = {
    'dropped_partial': ('for (int i = warp; i < n; i += kWarps)',
                        'for (int i = warp + (warp == 1); i < n; i += kWarps)'),
    'wrong_transposed_index': ('acc[4 * h][j], acc[4 * h + 1][j]',
                               'acc[4 * h + 1][j], acc[4 * h][j]'),
    'epilogue_column_off_by_one': ('__ldg(b1 + n)', '__ldg(b1 + (n + 1) % hidden)'),
    'unmasked_ragged_tile': ('if (m0 + tile_row(r) < m_end) cs[j] += acc[r][j];',
                             'cs[j] += acc[r][j];'),
    'dropped_group': ('d = (i < per ? 0.0 : d) + (double)acc[r][j];',
                      'd = (i < per ? 0.0 : d) + (i / per == 1 ? 0.0 : (double)acc[r][j]);'),
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
    for name, (old, new) in MUTANTS.items():
        src = tmp / name
        shutil.copytree(_build.CSRC, src)
        text = (src / 'convnext_block_bwd.cu').read_text()
        assert text.count(old) == 1, (name, old)
        (src / 'convnext_block_bwd.cu').write_text(text.replace(old, new))
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
    size.argtypes, size.restype = [ctypes.c_int] * 7, ctypes.c_longlong
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
def _run_bwd(lib, args, dy, plan, approximate=False):
    """The C entry on `plan` (pixels per tile, pixels per chain, weight
    splits, dxln splits) -> (err, the ten gradients, du), dx and the taps'
    gradient finished from du by the plain depthwise transposes in float64."""
    fn, size = _bwd_entry(lib)
    x = args[0]
    b, h, w, c = x.shape
    m, group, splits_w, splits_x = plan
    du = torch.full_like(x, float('nan'))
    grads = [torch.full_like(t, float('nan')) for t in args[2:]]
    scratch = torch.full((size(b, h, w, c, m, max(splits_w, 1), max(splits_x, 1)),), float('nan'))
    err = fn(*(t.data_ptr() for t in (x, dy, *args[1:], du, *grads, scratch)), b, h, w, c, m,
             group, splits_w, splits_x, int(approximate), 0, None)
    dud = du.double()
    dx = dy.double() + depthwise_conv_plain(dud, args[1].double().flip((-2, -1)))
    return err, (dx, dwconv_dw_plain(x.double(), dud, 7), *grads), du


def _bwd_err(got, want) -> list[float]:
    return [float((g.double() - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]


def _dy(b, h, w, c, seed):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal((b, h, w, c)).astype(
        np.float32))


# (b, h, w, c, plan, tanh), plan = (pixels per tile, pixels per float chain,
# weight-gradient splits, dxln splits): every per-pixel tile size with a
# ragged last tile; a hidden size under one 128-column tile and one whose
# second tile is ragged; two pixel tiles of the products, the second of 70
# rows; channels off 32 and over 256 (three column tiles, the last of 8);
# chains of 32 to 256 pixels, two chains of 256; weight splits with a short
# last one and empty ones; dxln splits of K, empty ones too; one image row.
BWD_CASES = [(1, 5, 6, 8, (8, 32, 3, 4), False), (2, 4, 7, 40, (16, 32, 2, 2), True),
             (1, 9, 12, 64, (32, 32, 3, 1), False), (1, 3, 20, 72, (8, 256, 1, 4), True),
             (3, 6, 11, 32, (16, 64, 2, 1), True), (1, 1, 9, 16, (32, 256, 1, 1), False),
             (1, 2, 5, 264, (8, 32, 1, 3), False), (1, 17, 19, 8, (32, 256, 1, 2), False)]


@pytest.mark.parametrize('b,h,w,c,plan,approximate', BWD_CASES)
def test_backward_cuda_source_on_the_cpu_matches_plain(libs, b, h, w, c, plan, approximate):
    args = _args(b, h, w, c, seed=2)
    dy = _dy(b, h, w, c, 3)
    err, got, du = _run_bwd(libs['convnext_block_bwd'], args, dy, plan, approximate)
    assert err == 0
    assert torch.isfinite(du).all() and all(torch.isfinite(g).all() for g in got)
    want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])),
                                             approximate=approximate)
    errs = _bwd_err(got, want)
    assert max(errs) <= BWD_RTOL, dict(zip(NAMES, errs))


# The faults' case: two pixel tiles of the products (the second of 5 rows, in
# rows padded to 136), nine per-pixel tiles, two hidden tiles, two weight
# splits of three and two chains, two dxln splits.
FAULT_CASE = (1, 7, 19, 48)
FAULT_PLAN = (16, 32, 2, 2)


@pytest.fixture(scope='module')
def fault_case(libs):
    """The faults' inputs and the plain backward in float64, which the
    unchanged source matches."""
    args, dy = _args(*FAULT_CASE, seed=4), _dy(*FAULT_CASE, 5)
    want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])))
    got = _run_bwd(libs['convnext_block_bwd'], args, dy, FAULT_PLAN)[1]
    assert max(_bwd_err(got, want)) <= BWD_RTOL
    return args, dy, want


@pytest.mark.parametrize('mutant', sorted(MUTANTS))
def test_backward_comparison_catches_an_injected_fault(libs, fault_case, mutant):
    args, dy, want = fault_case
    err, got, _ = _run_bwd(libs[mutant], args, dy, FAULT_PLAN)
    errs = [e if e == e else float('inf') for e in _bwd_err(got, want)]  # NaN: caught
    assert err == 0 and max(errs) > 100 * BWD_RTOL


def test_backward_takes_the_tile_the_wrapper_picks_and_refuses_others(libs):
    """`bwd_plan` for a few-pixel shape at the pose net's first stage width on
    an H100's 132 SMs (the smallest pixel tile, one chain, one weight split),
    run as the wrapper would; and a tile size with no instance (an error
    code, nothing written)."""
    plan = cb.bwd_plan(1, 3, 4, 96, 132)
    assert plan[:2] == (8, cb.BWD_GROUP) and plan[2] == 1
    args = _args(1, 3, 4, 96, seed=6)
    dy = torch.ones(1, 3, 4, 96)
    err, got, _ = _run_bwd(libs['convnext_block_bwd'], args, dy, plan)
    want = cb.fused_convnext_block_bwd_plain(*(t.double() for t in (args[0], dy, *args[1:])))
    assert err == 0 and max(_bwd_err(got, want)) <= BWD_RTOL
    err, _, du = _run_bwd(libs['convnext_block_bwd'], args, dy, (12, *plan[1:]))
    assert err != 0 and torch.isnan(du).all()


@pytest.mark.parametrize('plan', [(16, 0, 1, 1), (16, 48, 1, 1), (16, 288, 1, 1),
                                  (16, 256, 0, 1), (16, 256, 1, 0)])
def test_backward_entry_refuses_a_plan_it_cannot_run(libs, plan):
    """Chains of no pixels, off the 32-deep slab or over 256; no split of
    either kind: an error code, nothing written."""
    args = _args(1, 2, 3, 8, seed=7)
    err, _, du = _run_bwd(libs['convnext_block_bwd'], args, torch.ones(1, 2, 3, 8), plan)
    assert err != 0 and torch.isnan(du).all()


# (b, h, w, c) of every block of the KBR micro-step.
STEP_SHAPES = [(4, 96, 160, 128), (4, 48, 80, 256), (4, 24, 40, 512), (4, 12, 20, 1024),
               (8, 96, 160, 96), (8, 48, 80, 192), (8, 24, 40, 384), (8, 12, 20, 768)]


@pytest.mark.parametrize('sms', [132, 114])
@pytest.mark.parametrize('b,h,w,c', STEP_SHAPES)
def test_bwd_plan_fits_the_card_and_leaves_no_split_empty(b, h, w, c, sms):
    """At the micro-step's block shapes on an H100 SXM (132 SMs) and PCIe
    (114): the per-pixel tile's shared memory fits, chains of 256 pixels,
    every split of either kind holds work, and the products launch keeps
    each SM busy (at least as many blocks as SMs)."""
    m, group, splits_w, splits_x = cb.bwd_plan(b, h, w, c, sms)
    p, hidden = b * h * w, 4 * c
    assert m in (8, 16, 32) and cb._bwd_row_smem(m, c) <= cb._SMEM and group == 256
    assert (splits_w - 1) * cb._split_len(p, splits_w) < p
    assert (splits_x - 1) * cb._split_len(hidden, splits_x) < hidden
    tiles_c, tiles_h, mtiles = -(-c // 128), -(-hidden // 128), -(-p // 128)
    assert 2 * tiles_c * tiles_h * splits_w + mtiles * tiles_c * splits_x >= sms
