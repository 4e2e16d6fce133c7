"""Port differential: the warp on a bfloat16 source (`ops.sample`) vs the JAX package's.

- `warp_bilinear(img.bfloat16(), fx, fy)` (out, ddx, ddy; float32) against
  `pallas_warp.warp_bilinear_pallas(img.astype(bfloat16), ...)`, the packed
  Pallas kernel in interpret mode; channel counts 1, 2, 3 and 4 (odd counts
  leave half a packed word empty).
- `grid_sample` on a bfloat16 image: value, grid gradient and image gradient
  against the JAX `grid_sample` with `SLOWTV_FORCE_PALLAS_WARP`.
- Any dtype but float32 and bfloat16 raises, also on the CPU.
The port runs on the CPU, where its wrapper takes the plain version on the
exactly widened source.

Tolerances: the source is the same bfloat16 array on both sides, widened
exactly, so samples and ddx/ddy agree as in float32: atol 2e-5. Grid
gradient atol 1e-4 + rtol 1e-4. The image cotangent is a float32 scatter-add
rounded to bfloat16 on both sides: 2**-7 of the largest magnitude (one
bfloat16 ulp at the top of the range).
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


def _case(rs, b, h, w, c, ho, wo):
    """Coords 20% beyond each border, clamped (tests/test_pallas_warp.py)."""
    img = rs.random((b, h, w, c), dtype=np.float32)
    fx = np.clip(rs.random((b, ho, wo)) * 1.4 * (w - 1) - 0.2 * w, 0, w - 1).astype(np.float32)
    fy = np.clip(rs.random((b, ho, wo)) * 1.4 * (h - 1) - 0.2 * h, 0, h - 1).astype(np.float32)
    return img, fx, fy


def _bf16(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(img).to(torch.bfloat16)


CASES = {'rgb': (2, 24, 160, 3, 16, 200), 'one_channel': (1, 16, 128, 1, 16, 128),
         'two_channels': (1, 24, 136, 2, 9, 140), 'four_channels': (1, 16, 128, 4, 8, 130)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_warp_on_bf16_source_matches_jax_packed_kernel(case):
    img, fx, fy = _case(np.random.default_rng(17), *CASES[case])
    want = warp_bilinear_pallas(jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(fx),
                                jnp.asarray(fy), interpret=True)
    got = ts.warp_bilinear(_bf16(img), torch.from_numpy(fx), torch.from_numpy(fy))
    for name, g, w in zip(('out', 'ddx', 'ddy'), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), atol=ATOL, err_msg=name)


def test_the_quantization_shows():
    """The bf16 source is not the float32 source: the differential above
    would fail on a port that warped the unquantized image."""
    img, fx, fy = _case(np.random.default_rng(17), *CASES['rgb'])
    want = warp_bilinear_pallas(jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(fx),
                                jnp.asarray(fy), interpret=True)
    got = ts.warp_bilinear(torch.from_numpy(img), torch.from_numpy(fx), torch.from_numpy(fy))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0], np.float32), atol=ATOL)


def _grads_inputs(rs):
    b, h, w, c = 2, 16, 32, 3
    img = rs.random((b, h, w, c), dtype=np.float32)
    grid = rs.uniform(-1.3, 1.3, (b, 17, 23, 2)).astype(np.float32)
    return img, grid, rs.standard_normal((b, 17, 23, c)).astype(np.float32)


def test_grid_sample_on_bf16_source_and_grads_match_jax(monkeypatch):
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    img, grid, cot = _grads_inputs(np.random.default_rng(3))

    def loss(im, gr):
        return (jax_grid_sample(im, gr) * cot).sum()
    jimg = jnp.asarray(img).astype(jnp.bfloat16)
    want_out = jax_grid_sample(jimg, jnp.asarray(grid))
    want_gi, want_gg = jax.grad(loss, argnums=(0, 1))(jimg, jnp.asarray(grid))

    im = _bf16(img).requires_grad_()
    gr = torch.from_numpy(grid).requires_grad_()
    out = ts.grid_sample(im, gr)
    (out * torch.from_numpy(cot)).sum().backward()

    assert out.dtype == torch.float32 and im.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out, np.float32), atol=ATOL)
    np.testing.assert_allclose(gr.grad.numpy(), np.asarray(want_gg), **GRAD_TOL)
    want_gi = np.asarray(want_gi.astype(jnp.float32))
    np.testing.assert_allclose(im.grad.float().numpy(), want_gi,
                               atol=2 ** -7 * np.abs(want_gi).max())


def test_grid_gradient_differential_has_teeth(monkeypatch):
    """A grid gradient taken with ddx and ddy swapped fails."""
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
    img, grid, cot = _grads_inputs(np.random.default_rng(3))
    jimg = jnp.asarray(img).astype(jnp.bfloat16)
    want = jax.grad(lambda gr: (jax_grid_sample(jimg, gr) * cot).sum())(jnp.asarray(grid))

    plain = ts.warp_bilinear_plain
    monkeypatch.setattr(ts, 'warp_bilinear', lambda *a: (lambda o, dx, dy: (o, dy, dx))(*plain(*a)))
    gr = torch.from_numpy(grid).requires_grad_()
    (ts.grid_sample(_bf16(img), gr) * torch.from_numpy(cot)).sum().backward()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(gr.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize('dtype', [torch.float16, torch.float64, torch.uint8])
def test_other_dtypes_raise(dtype):
    img = torch.zeros(1, 4, 5, 3, dtype=dtype)
    f = torch.zeros(1, 2, 3)
    with pytest.raises(TypeError):
        ts.warp_bilinear(img, f, f)


def test_packed_wrapper_refuses_the_cpu():
    """`warp_bilinear_packed` is the kernel's wrapper: it has no plain path."""
    f = torch.zeros(1, 2, 3)
    with pytest.raises(TypeError):
        ts.warp_bilinear_packed(torch.zeros(1, 4, 5, 3, dtype=torch.bfloat16), f, f)


def test_view_synth_quantizes_the_sources_only():
    """`_batched_synth(..., warp_bf16=True)` equals the float32 synthesis of
    the bfloat16-rounded sources, and differs from that of the sources as
    they were."""
    from slowtv_monodepth_tpu_torch.core.handlers import _batched_synth
    rs = np.random.RandomState(4)
    n, m, h, w = 2, 2, 12, 16
    supp = torch.from_numpy(rs.rand(n, m, h, w, 3).astype(np.float32))
    depth = torch.from_numpy(1 + rs.rand(m, h, w, 1).astype(np.float32))
    T = torch.eye(4).repeat(n, m, 1, 1)
    T[..., 0, 3] = 0.05
    K = torch.tensor([[12., 0, 8, 0], [0, 12, 6, 0], [0, 0, 1, 0], [0, 0, 0, 1]]).repeat(m, 1, 1)
    got = _batched_synth(supp, depth, T, K, warp_bf16=True)
    rounded = _batched_synth(supp.to(torch.bfloat16).float(), depth, T, K)
    exact = _batched_synth(supp, depth, T, K)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), rounded.numpy(), atol=1e-6)
    assert (got - exact).abs().max() > 1e-4
