"""Port differential: the warp (`ops.sample`) vs the JAX package's.

Two levels, same numpy inputs on both sides, float32:
- `warp_bilinear` (out, ddx, ddy) against `pallas_warp.warp_bilinear_pallas`
  run in interpret mode, with the cases of `tests/test_pallas_warp.py`
  (tile-boundary coords included);
- `grid_sample` (value, grid and image gradients) against the JAX
  `grid_sample` with `SLOWTV_FORCE_PALLAS_WARP` (border mode: the kernel
  and its `custom_vjp`) or on its XLA path (zeros mode), with grids that
  leave the image and an identity warp whose coords sit exactly on the
  image border (the clip ties).
The port runs on the CPU, so its wrapper takes the plain version.

Tolerances: atol 2e-5 on samples and ddx/ddy (the JAX kernel's own against
its XLA path, `test_pallas_warp.py`); gradients atol 1e-4 with rtol 1e-4
(sums of 4-corner products over up to 3 channels, as there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.ops.pallas_warp import warp_bilinear_pallas
from slowtv_monodepth_tpu.ops.sample import grid_sample as jax_grid_sample
from slowtv_monodepth_tpu_torch.ops import sample as ts
from torch_threads import two_torch_threads  # noqa: F401

ATOL = 2e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand_case(rs, b=2, h=24, w=160, c=3, ho=16, wo=200):
    """`test_pallas_warp.py:_rand_case`: coords 20% beyond each border, clamped."""
    img = rs.random((b, h, w, c), dtype=np.float32)
    fx = np.clip(rs.random((b, ho, wo)) * 1.4 * (w - 1) - 0.2 * w, 0, w - 1).astype(np.float32)
    fy = np.clip(rs.random((b, ho, wo)) * 1.4 * (h - 1) - 0.2 * h, 0, h - 1).astype(np.float32)
    return img, fx, fy


def _boundary_case(rs):
    """`test_pallas_warp.py:119`: coords straddling the TPU tile boundaries."""
    b, h, w, c = 1, 32, 384, 3
    img = rs.random((b, h, w, c), dtype=np.float32)
    xs = np.concatenate([np.linspace(126.25, 129.75, 20), np.linspace(254.25, 257.75, 20),
                         np.linspace(w - 2.5, w - 1, 10), np.linspace(0, 2, 14)])
    ys = np.concatenate([np.linspace(6.25, 8.75, 20), np.linspace(14.25, 16.75, 20),
                         np.linspace(h - 2.5, h - 1, 14), np.linspace(0, 2, 10)])
    fx = np.ascontiguousarray(np.broadcast_to(xs[None, None, :], (b, 64, 64)), np.float32)
    fy = np.ascontiguousarray(np.broadcast_to(ys[None, :, None], (b, 64, 64)), np.float32)
    return img, fx, fy


CASES = {
    'single_tile': lambda rs: _rand_case(rs, 1, 16, 128, 1, 16, 128),
    'rgb_ragged': lambda rs: _rand_case(rs, 1, 24, 160, 3, 24, 160),
    'batched_out_shape': lambda rs: _rand_case(rs),
    'tile_boundaries': _boundary_case,
}


def _port_warp(img, fx, fy):
    return [t.numpy() for t in ts.warp_bilinear(*map(torch.from_numpy, (img, fx, fy)))]


@pytest.mark.parametrize('case', sorted(CASES))
def test_warp_bilinear_matches_jax_kernel(case):
    img, fx, fy = CASES[case](np.random.default_rng(17))
    want = warp_bilinear_pallas(jnp.asarray(img), jnp.asarray(fx), jnp.asarray(fy),
                                interpret=True)
    got = _port_warp(img, fx, fy)
    for name, g, w in zip(('out', 'ddx', 'ddy'), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=name)


def _grids(kind: str, rs):
    b, h, w, c = 2, 16, 32, 3
    img = rs.random((b, h, w, c), dtype=np.float32)
    if kind == 'identity':
        # Pixel centres, exact in float32 (h, w powers of 2): the coords of
        # the first and last rows and columns sit exactly on the clip bounds.
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        grid = np.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
        grid = np.broadcast_to(grid, (b, h, w, 2))
    else:  # 30% of the samples outside the image
        grid = rs.uniform(-1.3, 1.3, (b, 17, 23, 2))
    return img, np.ascontiguousarray(grid, np.float32), rs.standard_normal(
        grid.shape[:3] + (c,)).astype(np.float32)


def _jax_grads(img, grid, cot, mode):
    def loss(im, gr):
        return (jax_grid_sample(im, gr, padding_mode=mode) * cot).sum()
    out = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode=mode)
    gi, gg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    return [np.asarray(t) for t in (out, gi, gg)]


def _port_grads(img, grid, cot, mode):
    im = torch.from_numpy(img).requires_grad_()
    gr = torch.from_numpy(grid).requires_grad_()
    out = ts.grid_sample(im, gr, padding_mode=mode)
    (out * torch.from_numpy(cot)).sum().backward()
    return [t.detach().numpy() for t in (out, im.grad, gr.grad)]


@pytest.mark.parametrize('mode,kind', [('border', 'identity'), ('border', 'random'),
                                       ('zeros', 'random')])
def test_grid_sample_and_grads_match_jax(monkeypatch, mode, kind):
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    img, grid, cot = _grids(kind, np.random.default_rng(3))
    want = _jax_grads(img, grid, cot, mode)
    got = _port_grads(img, grid, cot, mode)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, err_msg='out')
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL, err_msg='d img')
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL, err_msg='d grid')


def test_grid_gradient_differential_has_teeth(monkeypatch):
    """`torch.clamp`'s VJP (full gradient at the border tie) fails the identity case."""
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    img, grid, cot = _grids('identity', np.random.default_rng(3))
    want = _jax_grads(img, grid, cot, 'border')
    monkeypatch.setattr(ts, 'clip', lambda x, lo, hi: x.clamp(lo, hi))
    got = _port_grads(img, grid, cot, 'border')
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


def test_warp_differential_has_teeth(monkeypatch):
    """x1 = x0 + 1 without the border clamp (ddx at x = w - 1 then reads the
    next row instead of 0) fails the tile-boundary case."""
    img, fx, fy = CASES['tile_boundaries'](np.random.default_rng(17))
    want = warp_bilinear_pallas(jnp.asarray(img), jnp.asarray(fx), jnp.asarray(fy),
                                interpret=True)
    corners = ts._corners

    def unclamped(h, w, fx, fy):
        (i00, _, i10, _), wx, wy = corners(h, w, fx, fy)
        return (i00, (i00 + 1).clamp(max=h * w - 1), i10,
                (i10 + 1).clamp(max=h * w - 1)), wx, wy

    monkeypatch.setattr(ts, '_corners', unclamped)
    got = _port_warp(img, fx, fy)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=ATOL)


def test_image_gradient_skipped_for_data():
    """The scatter-add runs only when the source requires grad."""
    img, grid, _ = _grids('random', np.random.default_rng(5))
    gr = torch.from_numpy(grid).requires_grad_()
    ts.grid_sample(torch.from_numpy(img), gr).sum().backward()
    assert gr.grad is not None and torch.isfinite(gr.grad).all()


@pytest.mark.parametrize('case', ['dtype', 'shape', 'noncontiguous', 'device'])
def test_wrapper_rejects(case):
    img, fx, fy = torch.zeros(1, 4, 5, 3), torch.zeros(1, 2, 3), torch.zeros(1, 2, 3)
    if case == 'dtype':
        img = img.double()
    elif case == 'shape':
        fy = torch.zeros(1, 2, 4)
    elif case == 'noncontiguous':
        fx = torch.zeros(1, 3, 2).transpose(1, 2)
    elif case == 'device':
        img = img.to('meta')
    with pytest.raises((ValueError, TypeError)):
        ts.warp_bilinear(img, fx, fy)
