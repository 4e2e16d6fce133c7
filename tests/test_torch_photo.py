"""Port differential: the fused photometric error (`ops.photo`) vs the JAX package's.

The JAX side is `pallas_photo.photo_err_ssim` (its Pallas kernels in
interpret mode on the CPU, forward and custom VJP), on the shapes of
`tests/test_pallas_photo.py`, plus a case with exact ties: x == y over a
region, where S == 0 exactly (the clip's tie) and x - y == 0 (the L1
term's VJP is sign(0) = 0 in the TPU kernel).
The port runs on the CPU, so `photo_fwd` / `photo_bwd` take their plain
versions; the autograd Function between them is the one the card runs.

Tolerances: error map atol 1e-5 and VJP atol 2e-5, the JAX kernel's own
against its XLA formulation (`test_pallas_photo.py`: float32 pools and a
ratio of products, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.ops.pallas_photo import photo_err_ssim as jax_photo
from slowtv_monodepth_tpu_torch.ops import photo as tp
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = [  # tests/test_pallas_photo.py:15-20
    (3, 16, 24, 3),
    (2, 8, 13, 3),
    (1, 104, 40, 1),
    (1, 144, 130, 2),
]
FWD_ATOL = 1e-5
VJP_ATOL = 2e-5


def _inputs(shape, seed, ties=False):
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    y = rs.rand(*shape).astype(np.float32)
    if ties:  # the left half identical: S == 0 exactly on its interior
        y[:, :, : shape[2] // 2] = x[:, :, : shape[2] // 2]
    wgt = rs.rand(*shape[:3], 1).astype(np.float32)
    return x, y, wgt


def _jax(x, y, wgt):
    xj, yj, wj = map(jnp.asarray, (x, y, wgt))
    out = jax_photo(xj, yj, 0.85)
    gx, gy = jax.grad(lambda a, b: (jax_photo(a, b, 0.85) * wj).sum(), argnums=(0, 1))(xj, yj)
    return [np.asarray(t) for t in (out, gx, gy)]


def _port(x, y, wgt):
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = tp.photo_err_ssim(xt, yt, 0.85)
    (out * torch.from_numpy(wgt)).sum().backward()
    return [t.detach().numpy() for t in (out, xt.grad, yt.grad)]


@pytest.mark.parametrize('shape', SHAPES)
def test_forward_and_vjp_match_jax(shape):
    x, y, wgt = _inputs(shape, 42)
    want, got = _jax(x, y, wgt), _port(x, y, wgt)
    assert got[0].shape == want[0].shape == shape[:3] + (1,)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=VJP_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=VJP_ATOL)


@pytest.mark.parametrize('shape', SHAPES[:2])
def test_vjp_at_exact_ties_matches_jax(shape):
    x, y, wgt = _inputs(shape, 7, ties=True)
    want, got = _jax(x, y, wgt), _port(x, y, wgt)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=VJP_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=VJP_ATOL)


def test_tie_differential_has_teeth(monkeypatch):
    """At x == y the L1 term's VJP is sign(0) = 0, as the TPU kernel's; an
    |x - y| whose gradient is 1 at 0 (`jnp.abs`'s) fails the tie case.

    (The clip's tie is not observable here: at an exact tie u = N / D = 1 is
    the maximum of u, so every du/d(stat) is 0 and the mask multiplies 0.
    The clip tie that matters is the warp's, `test_torch_warp.py`.)
    """
    x, y, wgt = _inputs(SHAPES[0], 7, ties=True)
    want = _jax(x, y, wgt)

    def abs_grad_one_at_zero(x, y, w_ssim):
        d = x - y
        return (w_ssim * tp.ssim_error(x, y) + (1 - w_ssim) * torch.where(d >= 0, d, -d)).mean(-1)

    monkeypatch.setattr(tp, 'photo_fwd_plain', abs_grad_one_at_zero)
    got = _port(x, y, wgt)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[1], want[1], atol=VJP_ATOL)


def test_forward_differential_has_teeth(monkeypatch):
    """Zero padding in place of reflect padding in the pools fails."""
    x, y, wgt = _inputs(SHAPES[0], 42)
    want = _jax(x, y, wgt)

    def pool_zeros(t):
        t = torch.nn.functional.pad(t.permute(0, 3, 1, 2), (1, 1, 1, 1))
        return torch.nn.functional.avg_pool2d(t, 3, stride=1).permute(0, 2, 3, 1)

    monkeypatch.setattr(tp, 'avg_pool3x3_reflect', pool_zeros)
    got = _port(x, y, wgt)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)


def test_plain_backward_is_the_plain_forwards_gradient():
    """`photo_bwd_plain` (the reference of kernel 8 on the card) against
    autograd through `photo_fwd_plain` in float64."""
    x, y, wgt = _inputs((2, 9, 11, 3), 3)
    g = torch.from_numpy(wgt[..., 0])
    dx, dy = tp.photo_bwd(torch.from_numpy(x), torch.from_numpy(y), g, 0.85)
    xd = torch.from_numpy(x).double().requires_grad_()
    yd = torch.from_numpy(y).double().requires_grad_()
    (tp.photo_fwd_plain(xd, yd, 0.85) * g.double()).sum().backward()
    np.testing.assert_allclose(dx.numpy(), xd.grad.numpy(), atol=VJP_ATOL)
    np.testing.assert_allclose(dy.numpy(), yd.grad.numpy(), atol=VJP_ATOL)


def test_cpu_path_does_not_count_launches():
    x, y, wgt = _inputs((1, 8, 8, 3), 0)
    before = (tp.photo_fwd.launches, tp.photo_bwd.launches)
    _port(x, y, wgt)
    assert (tp.photo_fwd.launches, tp.photo_bwd.launches) == before


@pytest.mark.parametrize('case', ['dtype', 'shape', 'small', 'noncontiguous', 'device'])
def test_wrappers_reject(case):
    x, y = torch.zeros(1, 6, 7, 3), torch.zeros(1, 6, 7, 3)
    if case == 'dtype':
        x = x.double()
    elif case == 'shape':
        y = torch.zeros(1, 6, 8, 3)
    elif case == 'small':
        x, y = torch.zeros(1, 1, 7, 3), torch.zeros(1, 1, 7, 3)
    elif case == 'noncontiguous':
        x = torch.zeros(1, 7, 6, 3).transpose(1, 2)
    elif case == 'device':
        x = x.to('meta')
    with pytest.raises((ValueError, TypeError)):
        tp.photo_fwd(x, y, 0.85)
