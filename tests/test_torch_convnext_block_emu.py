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
tiles, the staged slabs of the product core both kernels share, their
epilogues (the forward's transposed hg store, the backward's), their float
chains, the forward's K split over a cluster and its rank-order sum out of
the cluster's shared memories, the backward's splits and its fixed-order
partial sums all run as written. Both take their plan from the caller, so
these tests hand them small plans that put tile, chain, split and cluster
boundaries inside small shapes, and each has mutants that must fail. What
the card alone can show (that nvcc takes the files, timing, a race the CPU's
schedule hides) stays with `tests/test_torch_cuda.py` and `chip_smoke.py`.

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
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / 'tests' / 'cuda_emu'
ENTRY = 'slowtv_convnext_block_fwd_f32'
BWD_ENTRY = 'slowtv_convnext_block_bwd_f32'
NAMES = ('dx', 'dw_weight', 'dw_bias', 'ln_weight', 'ln_bias', 'fc1_weight', 'fc1_bias',
         'fc2_weight', 'fc2_bias', 'gamma')
RTOL = 1e-5
BWD_RTOL = 1e-5
# Faults injected into a copy of the forward's source, each of which the
# comparison must catch: rank 1's partial left out of the cluster's sum; fc1's
# bias read one column off; two pixels swapped in the hg^T store; the ragged
# pixel tile's rows past the last pixel stored by fc1's epilogue (over the
# next hidden unit's first pixels); every float chain but a block's first
# dropped.
FWD_MUTANTS = {
    'fwd_dropped_split_partial': ('for (int s = 1; s < S; ++s) {',
                                  'for (int s = 2; s < S; ++s) {'),
    'fwd_bias_column_off_by_one': ('const float bias = __ldg(b1 + n);',
                                   'const float bias = __ldg(b1 + (n + 1) % (4 * C));'),
    'fwd_swapped_transposed_store': ('make_float4(gelu(v.x + bias, approximate), gelu(v.y + bias',
                                     'make_float4(gelu(v.y + bias, approximate), gelu(v.x + bias'),
    'fwd_unmasked_ragged_tile': ('if (n0 + n >= N || m0 + m >= m_end) continue;',
                                 'if (n0 + n >= N) continue;'),
    'fwd_dropped_chain': ('      [&](int) {\n',
                          '      [&](int kt) {\n        if (kt >= kMaxGroup / kBK) zero(acc);\n'),
}
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
    """Both sources and their mutants built for the CPU, all g++ runs started
    together -> name: ctypes library."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu')
    builds = {name: (tmp / f'lib{name}.so', _start_build(gxx, _build.CSRC / f'{name}.cu',
                                                         tmp / f'lib{name}.so'))
              for name in ('convnext_block', 'convnext_block_bwd')}
    for file, mutants in (('convnext_block.cu', FWD_MUTANTS), ('convnext_block_bwd.cu', MUTANTS)):
        for name, (old, new) in mutants.items():
            src = tmp / name
            shutil.copytree(_build.CSRC, src)
            text = (src / file).read_text()
            assert text.count(old) == 1, (name, old)
            (src / file).write_text(text.replace(old, new))
            builds[name] = (tmp / f'lib{name}.so',
                            _start_build(gxx, src / file, tmp / f'lib{name}.so'))
    out = {}
    for name, (lib, proc) in builds.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        out[name] = ctypes.CDLL(str(lib))
    return out


def _fwd_entry(lib):
    fn = getattr(lib, ENTRY)
    fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
    size = lib.slowtv_convnext_block_fwd_scratch_floats
    size.argtypes, size.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    return fn, size


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


def _run(lib, args, plan, approximate=False):
    """The forward's C entry on `plan` (pixels per prep tile, fc1's split,
    fc2's split, blocks of an unsplit product launch), into NaN-filled output
    and scratch -> (err, y)."""
    fn, size = _fwd_entry(lib)
    x = args[0]
    out = torch.full_like(x, float('nan'))
    scratch = torch.full((size(*x.shape),), float('nan'))
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(), scratch.data_ptr(), *x.shape, *plan,
             int(approximate), 0, None)
    return err, out


def _fwd_err(out, args, approximate=False) -> float:
    want = cb.fused_convnext_block_plain(*(t.double() for t in args), approximate=approximate)
    return float((out.double() - want).abs().max()) / float(want.abs().max())


# (b, h, w, c, plan, tanh), plan = (pixels per prep tile, blocks splitting
# fc1's K = c, blocks splitting fc2's K = 4c): one pixel; pixel counts off the
# 128-pixel tile (2 and 3 tiles, the last of 1 or 7) and off 4 (a ragged quad
# in hg^T's padded rows); heights under the 7x7 halo; one image row; channels
# off 128 (8 to 96: one ragged tile; 264: a third tile of 8); hidden sizes
# under one 128-column tile and with a ragged second or third one; every
# split size of either product, with idle blocks (K of 8 over 8 blocks, 160
# over 4, 72 over 6, 288 over 7) and without; chains of 256 and a short last
# one (fc1's K of 264 on one block, fc2's 1056 over two: 544 = 256 + 256 +
# 32).
FWD_CASES = [(1, 1, 1, 8, (8, 1, 1), False), (1, 5, 6, 8, (8, 8, 8), True),
             (2, 4, 7, 40, (16, 2, 4), False), (1, 3, 3, 264, (8, 1, 2), False),
             (1, 9, 15, 64, (32, 1, 8), True), (1, 2, 67, 16, (16, 2, 1), False),
             (3, 6, 11, 32, (8, 3, 5), True), (1, 17, 19, 8, (32, 4, 1), False),
             (1, 4, 33, 96, (16, 1, 1), True), (1, 2, 5, 72, (8, 6, 7), False),
             (1, 7, 12, 128, (32, 8, 4), False), (2, 2, 2, 12, (8, 8, 4), True),
             (1, 6, 8, 48, (32, 2, 8), True), (1, 1, 129, 24, (16, 1, 1), False),
             (1, 10, 30, 64, (32, 7, 3), True)]


@pytest.mark.parametrize('b,h,w,c,plan,approximate', FWD_CASES)
def test_cuda_source_on_the_cpu_matches_plain(libs, b, h, w, c, plan, approximate):
    args = _args(b, h, w, c)
    err, out = _run(libs['convnext_block'], args, plan, approximate)
    assert err == 0
    assert torch.isfinite(out).all()  # every output written, nothing read unwritten
    assert _fwd_err(out, args, approximate) <= RTOL


@pytest.mark.parametrize('h,w,c,want', [(3, 4, 96, (8, 3, 6)), (5, 7, 64, (8, 1, 8)),
                                        (2, 3, 192, (8, 6, 8))])
def test_cuda_source_takes_the_plan_the_wrapper_picks(libs, h, w, c, want):
    """What `fused_convnext_block` would launch for these few-pixel shapes on
    an H100's 132 SMs: splits of 3 to 8 blocks."""
    plan = cb.fwd_plan(1, h, w, c, 132)
    assert plan == want
    args = _args(1, h, w, c, seed=1)
    err, out = _run(libs['convnext_block'], args, plan)
    assert err == 0 and _fwd_err(out, args) <= RTOL


def test_cuda_source_gives_the_same_bits_twice(libs):
    """Split K on both products: the cluster's sums run in a fixed order."""
    args = _args(1, 9, 15, 64, seed=3)
    first, second = (_run(libs['convnext_block'], args, (16, 2, 4))[1] for _ in range(2))
    assert torch.equal(first, second)


@pytest.mark.parametrize('c,plan', [(8, (12, 1, 1)), (8, (8, 9, 1)), (8, (8, 1, 0)),
                                    (8, (8, -1, 1)), (6, (8, 1, 1))])
def test_cuda_entry_refuses_what_it_was_not_built_for(libs, c, plan):
    """A prep tile with no instance, a split over 8, of none or of fewer,
    channels off 4: an error code, nothing written."""
    fn, _ = _fwd_entry(libs['convnext_block'])
    args = _args(1, 2, 2, c if c % 4 == 0 else 8)
    out = torch.zeros_like(args[0])
    scratch = torch.zeros(1)
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(), scratch.data_ptr(), 1, 2, 2, c,
             *plan, 0, 0, None)
    assert err != 0 and not out.any()


# The faults' case: two pixel tiles (the second of 7 pixels, rows of hg^T
# padded to 136) and three hidden tiles (the last of 64), fc1's K of 80 split
# over two blocks, fc2's K of 320 in two chains.
FWD_FAULT_CASE = (1, 9, 15, 80)
FWD_FAULT_PLAN = (8, 2, 1)


@pytest.fixture(scope='module')
def fwd_fault_args(libs):
    """The faults' inputs, which the unchanged source matches."""
    args = _args(*FWD_FAULT_CASE, seed=4)
    assert _fwd_err(_run(libs['convnext_block'], args, FWD_FAULT_PLAN)[1], args) <= RTOL
    return args


@pytest.mark.parametrize('mutant', sorted(FWD_MUTANTS))
def test_comparison_catches_an_injected_fault(libs, fwd_fault_args, mutant):
    err, out = _run(libs[mutant], fwd_fault_args, FWD_FAULT_PLAN)
    e = _fwd_err(out, fwd_fault_args)
    assert err == 0 and not e <= 100 * RTOL  # NaN: caught


# Every ConvNeXt block shape of a 384x640 request (B=1) and of the KBR
# micro-step (ConvNeXt-B at B=4, ConvNeXt-T at B=8).
PLAN_SHAPES = [(1, 96, 160, 128), (1, 48, 80, 256), (1, 24, 40, 512), (1, 12, 20, 1024),
               (4, 96, 160, 128), (4, 48, 80, 256), (4, 24, 40, 512), (4, 12, 20, 1024),
               (8, 96, 160, 96), (8, 48, 80, 192), (8, 24, 40, 384), (8, 12, 20, 768)]


# Blocks an H100 SXM runs at once in clusters of 1 to 8 (what `_cluster_blocks`
# might say; the card's own answer is printed by chip_smoke.py).
H100_SLOTS = (132, 132, 126, 120, 120, 120, 112, 120)


@pytest.mark.parametrize('sms,slots', [(132, None), (132, H100_SLOTS), (114, None)],
                         ids=['sxm', 'sxm_clusters', 'pcie'])
@pytest.mark.parametrize('b,h,w,c', PLAN_SHAPES)
def test_fwd_plan_fits_the_card_and_leaves_no_split_empty(b, h, w, c, sms, slots):
    """On an H100 SXM (132 SMs, with and without fewer blocks at once in
    large clusters) and PCIe (114): the prep tile's shared memory fits, every
    block of a split holds K, each product gives more than half the blocks
    the card runs at once a block (the deep stages at B=1 only by their
    splits)."""
    m, s1, s2 = cb.fwd_plan(b, h, w, c, sms, slots)
    assert m in (8, 16, 32) and 4 * m * (c + 4) <= cb._SMEM
    mtiles = -(-b * h * w // 128)
    for s, k, n in ((s1, c, 4 * c), (s2, 4 * c, c)):
        assert 1 <= s <= 8 and (s - 1) * cb._split_len(k, s) < k
        assert mtiles * -(-n // 128) * s > (slots or (sms,) * 8)[s - 1] / 2


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
