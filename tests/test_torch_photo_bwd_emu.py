"""The photometric error's backward CUDA source (kernel 8), run on the CPU, and its host plan.

`csrc/photo_bwd.cu` launches through `cudaLaunchKernelEx` with dynamic
shared memory only, so `tests/cuda_emu` (one `std::thread` per CUDA thread,
shared memory filled with NaN first, `cp.async` copies that land only at the
wait) lets g++ build the very file. Its C entry is called through ctypes on
CPU tensors, into dx and dy filled with NaN, and both are held against
`photo_bwd_plain` in float64: C = 1, 2, 3; h and w off the tile (rows of
`bwd_plan`'s height, 62 columns); h = 2 and w = 2, where a reflect fold
lands on the row it left; images two and three tiles wide and several tiles
high, so that every fold and halo crosses a tile edge; rows of W C floats a
multiple of 4 (16-byte staging) and not (scalar staging), and an x that
does not start 16-byte aligned (scalar staging); exact ties (x == y on a
half); each on the plan `bwd_plan` makes for 132 SMs and on the plans of 4
and 16 rows, which give the same bits.

Two mutants must fail: the reflect fold's weight 2 made 1 (the comparison of
dx and dy), and the tie mask 0.5 made 1. The second cannot show in dx and
dy: at x == y over a window SSIM is at its maximum, so the clipped term's
gradient there is zero whatever the mask (the kernel's V maps at a tie
cancel exactly against x == y at every output they reach). So a probe copy
of the source, patched at build time, writes P^T(G du/dP(x^2)) into dx, a
map the mask scales, and the probe of the tie mutant is held against the
float64 map with jnp.clip's 0.5 at the ties (the probe itself within
PHOTO_BWD_RTOL plus twice the plain float32 map's error: near a tie the map
divides by the variances' sum).

The host plan (`ops.photo.bwd_plan`) is checked without the emulation: at
every shape the main path runs, at 132 and at 78 SMs, its blocks cover every
output once and fit the card's shared memory (five blocks an SM at C = 3),
and the shared memory the plan counts is the source's.

Tolerance: PHOTO_BWD_RTOL of `chip_smoke.py`, 1e-5 of the largest |gradient|
(at least 1), against float64.
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
ENTRY = 'slowtv_photo_bwd_f32'
RTOL = 1e-5
W_SSIM = 0.85
FOLD = ('__device__ __forceinline__ float fold_weight(int q, int edge) { return q == edge ? 2.f',
        '__device__ __forceinline__ float fold_weight(int q, int edge) { return q == edge ? 1.f')
TIE = (': ((raw == 0.f || raw == 1.f) ? 0.5f : 0.f);', ': ((raw == 0.f || raw == 1.f) ? 1.f : 0.f);')
PROBE = ('a.dx[go] = p[0] + p[2] * (2.f * xq) + p[3] * yq + l1;', 'a.dx[go] = p[2];')
BUILDS = {'source': (), 'fold': (FOLD,), 'probe': (PROBE,), 'probe_tie': (PROBE, TIE)}
H100_SMEM = 232448    # bytes of shared memory a block may have (227 KB)
SMEM_PER_SM = 233472  # an H100 SM's shared memory (228 KB), 1 KB of it reserved per block


def _start_build(gxx: str, src, lib) -> subprocess.Popen:
    cmd = [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared', '-fPIC', '-pthread',
           f'-I{EMU}', f'-I{_build.CSRC}', f'-DKERNEL_SOURCE="{src}"', str(EMU / 'emu.cpp'),
           '-o', str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope='module')
def libs(tmp_path_factory) -> dict:
    """The source, its mutant and the probe copies built for the CPU, all g++
    runs started together."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ (C++20) to build the CUDA sources for the CPU')
    tmp = tmp_path_factory.mktemp('cuda_emu_photo_bwd')
    src = _build.CSRC / 'photo_bwd.cu'
    text = src.read_text()
    procs = {}
    for name, edits in BUILDS.items():
        patched = text
        for old, new in edits:
            assert patched.count(old) == 1, (name, old)
            patched = patched.replace(old, new)
        path = src if not edits else tmp / f'{name}.cu'
        if edits:
            path.write_text(patched)
        procs[name] = _start_build(gxx, path, tmp / f'lib{name}.so')
    out = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(tmp / f'lib{name}.so'))
        fn = getattr(lib, ENTRY)
        fn.argtypes, fn.restype = _build.SIGNATURES[ENTRY], ctypes.c_int
        lib.slowtv_photo_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.slowtv_photo_bwd_smem_bytes.restype = ctypes.c_longlong
        out[name] = lib
    return out


def _case(m, h, w, c, seed=0, ties=False, misaligned=False):
    """x, y uniform in [0, 1), g (m, h, w); y == x on the left half with
    `ties`; x one float into its storage with `misaligned`."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32))
    y = torch.from_numpy(rs.rand(m, h, w, c).astype(np.float32))
    if ties:
        y[:, :, : w // 2] = x[:, :, : w // 2]
    g = torch.from_numpy(rs.rand(m, h, w).astype(np.float32))
    if misaligned:
        x = torch.cat([torch.zeros(1), x.flatten()])[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    return x, y, g


def _run(lib, x, y, g, rows):
    """The C entry with tiles `rows` high -> (err, dx, dy), NaN where not written."""
    m, h, w, c = x.shape
    dx, dy = torch.full_like(x, float('nan')), torch.full_like(y, float('nan'))
    err = getattr(lib, ENTRY)(x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                              dy.data_ptr(), m, h, w, c, W_SSIM / c, (1 - W_SSIM) / c, rows,
                              0, None)
    return err, dx, dy


def _rel_err(got, want) -> float:
    """max|got - want| over both gradients, relative to max(1, max|want|)."""
    scale = max(1.0, max(float(t.abs().max()) for t in want))
    return max(float((u.double() - t).abs().max()) for u, t in zip(got, want)) / scale


def _plans(m, h, w, c):
    return sorted({photo.bwd_plan(m, h, w, c, 132), *photo.BWD_ROWS})


# (m, h, w, c, ties): one tile with h and w off it; h = 2; w = 2; both 2; two
# and three tiles wide (the second tile of (1, 13, 64, 2) two columns),
# several tiles high; C = 1, 2, 3; W C a multiple of 4 ((1, 9, 2, 2),
# (1, 19, 132, 3), (2, 11, 68, 1), (1, 13, 64, 2)) and not; exact ties on a half.
CASES = [(1, 5, 7, 3, False), (2, 2, 9, 3, True), (1, 9, 2, 2, False), (1, 2, 2, 1, False),
         (1, 19, 132, 3, True), (2, 11, 68, 1, True), (1, 13, 64, 2, False), (1, 6, 63, 3, True)]


@pytest.mark.parametrize('m,h,w,c,ties', CASES)
def test_photo_bwd_source_on_the_cpu_matches_plain(libs, m, h, w, c, ties):
    x, y, g = _case(m, h, w, c, seed=h * w + c, ties=ties)
    want = photo.photo_bwd_plain(x.double(), y.double(), g.double(), W_SSIM)
    first = None
    for rows in _plans(m, h, w, c):
        err, dx, dy = _run(libs['source'], x, y, g, rows)
        assert err == 0
        assert torch.isfinite(dx).all() and torch.isfinite(dy).all(), rows  # every value written
        assert _rel_err((dx, dy), want) <= RTOL, rows
        # Every output's sums run in one order whatever the tile height.
        first = first or (dx, dy)
        assert torch.equal(dx, first[0]) and torch.equal(dy, first[1]), rows


def test_unaligned_x_takes_the_scalar_staging(libs):
    x, y, g = _case(2, 7, 66, 3, seed=5, ties=True, misaligned=True)
    want = photo.photo_bwd_plain(x.double(), y.double(), g.double(), W_SSIM)
    err, dx, dy = _run(libs['source'], x, y, g, 4)
    assert err == 0 and _rel_err((dx, dy), want) <= RTOL


def test_two_calls_are_bitwise_equal(libs):
    x, y, g = _case(1, 19, 132, 3, seed=3, ties=True)
    first, second = (_run(libs['source'], x, y, g, 16)[1:] for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_plan_out_of_range_is_refused(libs):
    x, y, g = _case(1, 5, 7, 3)
    for rows in (0, 5, 8, 32):
        assert _run(libs['source'], x, y, g, rows)[0] != 0, rows
    x1, y1, g1 = _case(1, 1, 7, 3)
    assert _run(libs['source'], x1, y1, g1, 4)[0] != 0  # h < 2: no reflect padding


def _probe_map(x, y, g):
    """P^T(G du/dP(x^2)) (what the probe copy writes into dx) by the plain
    formulas in x's dtype, with jnp.clip's mask: 1 inside the clip, 0.5 at a
    tie, 0 outside -> (the map, the count of ties)."""
    c = x.shape[-1]
    pool = photo.avg_pool3x3_reflect
    mx, my = pool(x), pool(y)
    a = 2 * mx * my + photo.C1
    t = 2 * (pool(x * y) - mx * my) + photo.C2
    q = mx * mx + my * my + photo.C1
    r = (pool(x * x) - mx * mx) + (pool(y * y) - my * my) + photo.C2
    u = a * t / (q * r)
    raw = (1 - u) / 2
    mask = ((raw > 0) & (raw < 1)).to(x.dtype) + 0.5 * ((raw == 0) | (raw == 1)).to(x.dtype)
    v = g[..., None] * (W_SSIM / c) * -0.5 * mask * (-u * q / (q * r))
    z = torch.zeros_like(x, requires_grad=True)
    with torch.enable_grad():
        return torch.autograd.grad((pool(z) * v).sum(), z)[0], int((raw == 0).sum())


@pytest.mark.parametrize('mutant', ['fold', 'tie'])
def test_comparison_catches_mutants(libs, mutant):
    x, y, g = _case(2, 9, 70, 3, seed=4, ties=True)
    if mutant == 'fold':
        want = photo.photo_bwd_plain(x.double(), y.double(), g.double(), W_SSIM)
        assert _rel_err(_run(libs['source'], x, y, g, 4)[1:], want) <= RTOL
        err, dx, dy = _run(libs['fold'], x, y, g, 4)
        assert err == 0 and _rel_err((dx, dy), want) > 100 * RTOL
    else:
        # The map divides by the variances' sum near ties: held, as chip_smoke.py
        # holds the kernels, to RTOL plus twice the plain float32 map's error.
        want, ties = _probe_map(x.double(), y.double(), g.double())
        assert ties > 100  # the half with x == y: S == 0 exactly
        tol = RTOL + 2 * _rel_err((_probe_map(x, y, g)[0],), (want,))
        assert _rel_err(_run(libs['probe'], x, y, g, 4)[1:2], (want,)) <= tol
        err, dx, _ = _run(libs['probe_tie'], x, y, g, 4)
        assert err == 0 and _rel_err((dx,), (want,)) > 100 * tol


def test_smem_bytes_is_the_sources(libs):
    lib = libs['source']
    for rows in photo.BWD_ROWS:
        for c in range(1, photo.MAX_CHANNELS + 1):
            assert lib.slowtv_photo_bwd_smem_bytes(rows, c) == photo.smem_bytes(rows, c)


# ------------------------------------------------------------------ host plan
def _main_path_shapes():
    """(m, h, w, 3) of every kernel-8 call the main path makes: the KBR step's
    warped stack (2 supports x 4 scales x B=4) and the static stack (2 x B) at
    384x640, and both at the training run's AR-aug buckets
    (`chip_smoke.run_buckets`)."""
    return [(m, h, w, 3) for m in (32, 8) for h, w in ((384, 640), (224, 832), (480, 384))]


@pytest.mark.parametrize('sms', [132, 78])
def test_plan_covers_every_output_once_and_fits(sms):
    shapes = _main_path_shapes() + [(1, 2, 2, 3), (1, 19, 132, 3), (2, 11, 68, 1), (1, 6, 63, 4)]
    for m, h, w, c in shapes:
        rows = photo.bwd_plan(m, h, w, c, sms)
        assert rows in photo.BWD_ROWS and photo.smem_bytes(rows, c) <= H100_SMEM
        if c == 3:  # five blocks an SM
            assert 5 * (photo.smem_bytes(rows, c) + 1024) <= SMEM_PER_SM
        rt, ct, blocks = photo.bwd_tiles(m, h, w, rows)
        if (m, h, w, c) in _main_path_shapes():
            assert rows == 16 and blocks >= 5 * sms
        # The kernel's block -> (image, tile row, tile column), columns fastest;
        # each tile's outputs counted once.
        ids = np.arange(blocks)
        tc, tr, img = ids % ct, ids // ct % rt, ids // (ct * rt)
        assert len(set(zip(img, tr, tc))) == blocks and img.max() == m - 1
        for tile, n, size in ((tr, h, rows), (tc, w, photo.BWD_TILE_W)):
            covered = np.zeros(n, int)
            for t in np.unique(tile):
                covered[t * size:(t + 1) * size] += 1
            assert (covered == 1).all()
    with pytest.raises(ValueError, match='1 to 4 channels'):
        photo.bwd_plan(1, 8, 8, 5, sms)
