"""Port differential: the backward of `ops.dwconv.depthwise_conv` vs the JAX package's.

The JAX side is `pallas_dwconv.depthwise_conv` forced onto its Pallas
kernels (`SLOWTV_FORCE_PALLAS_DWCONV`, interpret mode on the CPU), whose
`custom_vjp` gives dx (the forward kernel on the cotangent with flipped
taps), dw (the tap-gradient kernel) and db. The port's autograd Function
runs the same split with the plain versions, since the tensors lie on the
CPU.

Tolerances: dx atol 1e-5 as the forward (K*K products per element); dw
and db sum over b*h*w terms of O(1) products, so atol 1e-5 times the number
of summed terms' square root (float32 sums in another order; measured
~2e-6 at these shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.ops import pallas_dwconv as pd
from slowtv_monodepth_tpu_torch.ops import dwconv as td
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = [(2, 16, 24, 96, 7), (1, 9, 13, 40, 3), (2, 11, 19, 70, 7), (1, 12, 20, 33, 3)]


@pytest.fixture(autouse=True)
def _force_pallas(monkeypatch):
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_DWCONV', '1')


def _inputs(b, h, w, c, k, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, w, c).astype(np.float32),
            (rs.randn(k, k, c) * 0.2).astype(np.float32),    # JAX layout (k, k, c)
            rs.randn(c).astype(np.float32),
            rs.randn(b, h, w, c).astype(np.float32))          # cotangent


def _jax(x, taps, bias, g):
    _, vjp = jax.vjp(pd.depthwise_conv, *map(jnp.asarray, (x, taps, bias)))
    dx, dtaps, db = vjp(jnp.asarray(g))
    dw = np.ascontiguousarray(np.asarray(dtaps).transpose(2, 0, 1)[:, None])  # (c, 1, k, k)
    return np.asarray(dx), dw, np.asarray(db)


def _port(x, taps, bias, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(taps.transpose(2, 0, 1)[:, None])).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    td.depthwise_conv(xt, wt, bt).backward(torch.from_numpy(g))
    return xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()


def _tols(b, h, w):
    return {'dx': 1e-5, 'dw': 1e-5 * np.sqrt(b * h * w), 'db': 1e-5 * np.sqrt(b * h * w)}


@pytest.mark.parametrize('b,h,w,c,k', SHAPES)
def test_backward_matches_jax_custom_vjp(b, h, w, c, k):
    args = _inputs(b, h, w, c, k)
    tol = _tols(b, h, w)
    for name, got, want in zip(('dx', 'dw', 'db'), _port(*args), _jax(*args)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=tol[name], err_msg=name)


def test_backward_differential_has_teeth(monkeypatch):
    """dx through the forward with the taps NOT flipped fails."""
    args = _inputs(*SHAPES[0])
    want = _jax(*args)
    forward = td._forward

    def unflipped(x, weight, bias):  # bias is None only in the backward's dx
        return forward(x, weight if bias is not None else weight.flip((-2, -1)), bias)

    monkeypatch.setattr(td, '_forward', unflipped)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_port(*args)[0], want[0], atol=_tols(*SHAPES[0][:3])['dx'])


def test_tap_gradient_plain_matches_autograd():
    """`dwconv_dw_plain` (the card's reference for kernel 2) is conv2d's weight grad."""
    x, taps, bias, g = _inputs(2, 10, 14, 24, 5, seed=3)
    w = torch.from_numpy(np.ascontiguousarray(taps.transpose(2, 0, 1)[:, None])).requires_grad_()
    torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=2,
                               groups=24).backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = td.dwconv_dw(torch.from_numpy(x), torch.from_numpy(g), 5)
    np.testing.assert_allclose(got.numpy(), w.grad.numpy(), atol=1e-4)


# (b, h, w, c): the block shapes of the KBR micro-step (ConvNeXt-B at B=4,
# ConvNeXt-T on the 2 x 4 pose pairs), 384x640.
STEP_SHAPES = [(4, 96, 160, 128), (4, 48, 80, 256), (4, 24, 40, 512), (4, 12, 20, 1024),
               (8, 96, 160, 96), (8, 48, 80, 192), (8, 24, 40, 384), (8, 12, 20, 768)]


def test_blocks_of_the_tap_gradient():
    """The tap gradient's plan: a valid plan everywhere (one block for one
    pixel; tiles of at most 12 rows, which fit in shared memory; clusters
    that divide the blocks, at most 8; about one block per SM, on an H100
    (132 SMs) and on a card of 78: rounding the tiles per block up may add
    one block per channel group); at every step shape one wave of one block
    per SM of an H100, every block the same number of tiles or one fewer, at
    least 96 blocks (the 12x20 ConvNeXt-T stage has 24 groups of 8 tiles),
    and partials at most 10% of the bytes of x and g."""
    assert td.dw_plan(1, 1, 1, 1, 7, 132) == (1, 1, 1)
    for b, h, w, c in STEP_SHAPES + [(2, 37, 53, 70), (8, 7, 26, 768), (1, 9, 13, 45)]:
        for k in (1, 3, 5, 7, 9):
            for sms in (132, 78):
                rows, splits, cluster = td.dw_plan(b, h, w, c, k, sms)
                assert 1 <= rows <= 12 and splits >= 1 and 1 <= cluster <= 8
                assert splits % cluster == 0 and -(-c // 32) * (splits - 1) <= sms
    for b, h, w, c in STEP_SHAPES:
        rows, splits, cluster = td.dw_plan(b, h, w, c, 7, 132)
        tiles = b * -(-h // rows) * -(-w // 20)
        assert 96 <= -(-c // 32) * splits <= 132
        counts = {tiles * (i + 1) // splits - tiles * i // splits for i in range(splits)}
        assert max(counts) - min(counts) <= 1  # tiles per block, as the kernel splits them
        assert (splits // cluster) * c * 49 <= 0.1 * 2 * b * h * w * c


@pytest.mark.parametrize('case', ['dtype', 'shape', 'even_k', 'noncontiguous'])
def test_tap_gradient_rejects(case):
    x, g, k = torch.zeros(1, 6, 7, 8), torch.zeros(1, 6, 7, 8), 3
    if case == 'dtype':
        g = g.double()
    elif case == 'shape':
        g = torch.zeros(1, 6, 7, 9)
    elif case == 'even_k':
        k = 4
    elif case == 'noncontiguous':
        x = torch.zeros(1, 7, 6, 8).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        td.dwconv_dw(x, g, k)
