"""Port differential: `ops.convnext_block.fused_convnext_block` vs the JAX package's.

The JAX side is `pallas_convnext.fused_convnext_block`, whose Pallas kernels
(forward and the custom VJP's backward) run in interpret mode off a TPU, and,
for the shapes that kernel refuses (h < 6, channels off the 128 lanes), the
unfused flax `ConvNeXtBlock`. The port's wrapper takes its plain PyTorch
version because the tensors lie on the CPU; autograd through it is the oracle
the port's backward kernel will be held to. Same numpy inputs on both sides,
float32, weights fan-in scaled so that every activation is O(1).

Tolerances: forward 1e-5 of max|y| (sums of up to 4C = 512 float32 products in
another order, the JAX kernel's polynomial erf good to 1.5e-7; measured
~1e-6); each gradient 1e-4 of its own largest magnitude, the JAX package's own
limit (`tests/test_pallas_convnext.py:84`; sums over b*h*w = 384 pixels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.models.encoders.convnext import ConvNeXtBlock as JaxBlock
from slowtv_monodepth_tpu.ops import pallas_convnext as pc
from slowtv_monodepth_tpu_torch.ops import convnext_block as tb

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
NAMES = ('x', 'dw_weight', 'dw_bias', 'ln_weight', 'ln_bias', 'fc1_weight', 'fc1_bias',
         'fc2_weight', 'fc2_bias', 'gamma')


def _inputs(b, h, w, c, seed=0, x_scale=1.0) -> dict:
    """The block's ten inputs in the port's layouts, as numpy arrays."""
    rs = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (scale * rs.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {'x': f(b, h, w, c, scale=x_scale), 'dw_weight': f(c, 1, 7, 7, scale=1 / 7),
            'dw_bias': f(c, scale=0.1 * x_scale), 'ln_weight': 1 + f(c, scale=0.1),
            'ln_bias': f(c, scale=0.1), 'fc1_weight': f(4 * c, c, scale=c ** -0.5),
            'fc1_bias': f(4 * c, scale=0.1), 'fc2_weight': f(c, 4 * c, scale=(4 * c) ** -0.5),
            'fc2_bias': f(c, scale=0.1), 'gamma': f(c, scale=0.5)}


def _to_jax(a: dict, pad_to: int = 0) -> list:
    """The port's layouts -> the JAX kernel's ((7, 7, c) taps, (in, out) dense),
    zero-padded to `pad_to` channels as the JAX encoder pads its lanes."""
    c = a['x'].shape[-1]
    args = [a['x'], a['dw_weight'][:, 0].transpose(1, 2, 0), a['dw_bias'], a['ln_weight'],
            a['ln_bias'], a['fc1_weight'].T, a['fc1_bias'], a['fc2_weight'].T, a['fc2_bias'],
            a['gamma']]
    if pad_to:
        p = pad_to - c
        lanes = lambda v: np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, p)])  # noqa: E731
        args = [lanes(v) if v.shape[-1] == c else v for v in args]
        args[5] = np.pad(args[5], [(0, p), (0, 4 * p)])   # (c, 4c) -> (pad, 4 * pad)
        args[6] = np.pad(args[6], [(0, 4 * p)])
        args[7] = np.pad(a['fc2_weight'].T, [(0, 4 * p), (0, p)])
    return [jnp.asarray(np.ascontiguousarray(v)) for v in args]


def _from_jax_grads(g: list) -> dict:
    """Gradients in the JAX kernel's layouts -> the port's."""
    g = [np.asarray(v) for v in g]
    g[1] = g[1].transpose(2, 0, 1)[:, None]
    g[5], g[7] = g[5].T, g[7].T
    return dict(zip(NAMES, g))


def _port(a: dict, approximate=False, grad=False):
    ts = {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in a.items()}
    return tb.fused_convnext_block(*ts.values(), approximate=approximate), ts


def _jax_unfused(a: dict, approximate: bool) -> np.ndarray:
    """The flax block on its plain path (no switch set)."""
    c = a['x'].shape[-1]
    j = _to_jax(a)
    params = {'conv_dw': {'kernel': j[1][:, :, None, :], 'bias': j[2]},
              'norm': {'scale': j[3], 'bias': j[4]},
              'mlp_fc1': {'kernel': j[5], 'bias': j[6]},
              'mlp_fc2': {'kernel': j[7], 'bias': j[8]}, 'gamma': j[9]}
    return np.asarray(JaxBlock(c, gelu_approx=approximate).apply({'params': params}, j[0]))


def _assert_close(got, want, rtol, what=''):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape
    assert err <= rtol * scale, f'{what}: {err:.3g} > {rtol:g} * {scale:.3g}'


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in ('SLOWTV_FORCE_PALLAS_CONVNEXT', 'SLOWTV_ENABLE_PALLAS_CONVNEXT'):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize('approximate', [False, True], ids=['erf', 'tanh'])
@pytest.mark.parametrize('shape', [(2, 12, 16, 128), (1, 6, 8, 256)])
def test_forward_matches_jax_kernel(shape, approximate):
    a = _inputs(*shape)
    want = np.asarray(pc.fused_convnext_block(*_to_jax(a), approximate=approximate))
    got, _ = _port(a, approximate)
    _assert_close(got.numpy(), want, FWD_RTOL)


@pytest.mark.parametrize('approximate', [False, True], ids=['erf', 'tanh'])
def test_lane_padded_jax_kernel_matches_port_at_96_channels(approximate):
    """JAX pads 96 channels to its 128 lanes and masks the LayerNorm; the
    port's kernel takes the real channel count."""
    a = _inputs(2, 12, 16, 96, seed=1)
    want = np.asarray(pc.fused_convnext_block(*_to_jax(a, pad_to=128), c_real=96,
                                              approximate=approximate))
    assert float(np.abs(want[..., 96:]).max()) == 0
    got, _ = _port(a, approximate)
    _assert_close(got.numpy(), want[..., :96], FWD_RTOL)


@pytest.fixture(scope='module', params=[False, True], ids=['erf', 'tanh'])
def grads(request):
    """All ten gradients of sum(y * g): the JAX custom VJP (its backward
    kernel, interpret mode) and autograd through the port's plain version."""
    approximate = request.param
    a = _inputs(2, 12, 16, 128, seed=2)
    g = np.random.RandomState(3).standard_normal(a['x'].shape).astype(np.float32)
    want = jax.grad(lambda *args: (pc.fused_convnext_block(*args, approximate=approximate)
                                   * jnp.asarray(g)).sum(), argnums=tuple(range(10)))(*_to_jax(a))
    y, ts = _port(a, approximate, grad=True)
    y.backward(torch.from_numpy(g))
    return {k: t.grad.numpy() for k, t in ts.items()}, _from_jax_grads(want)


@pytest.mark.parametrize('name', NAMES)
def test_plain_gradient_matches_jax_custom_vjp(grads, name):
    got, want = grads
    _assert_close(got[name], want[name], GRAD_RTOL, name)


@pytest.mark.parametrize('approximate', [False, True], ids=['erf', 'tanh'])
@pytest.mark.parametrize('shape', [(1, 4, 9, 128), (2, 5, 7, 96), (1, 13, 11, 40),
                                   (3, 3, 3, 8)])
def test_shapes_the_jax_kernel_refuses_match_the_jax_unfused_block(shape, approximate):
    """h < 6 (the halo), channels off the 128 lanes."""
    a = _inputs(*shape, seed=4)
    assert not pc.convnext_block_supported(shape, shape[-1], 'tpu')
    got, _ = _port(a, approximate)
    _assert_close(got.numpy(), _jax_unfused(a, approximate), FWD_RTOL)


@pytest.mark.parametrize('fault', ['ln_eps', 'gelu_flavor', 'flipped_taps', 'fc_transposed'])
def test_differential_has_teeth(fault, monkeypatch):
    """Each fault in the port breaks the forward comparison above."""
    # Small activations, so that the LayerNorm's epsilon matters.
    a = _inputs(2, 12, 16, 128, seed=5, x_scale=3e-3 if fault == 'ln_eps' else 1.0)
    want = np.asarray(pc.fused_convnext_block(*_to_jax(a)))
    _assert_close(_port(a)[0].numpy(), want, FWD_RTOL)  # sound before the fault
    if fault == 'ln_eps':
        monkeypatch.setattr(tb, 'LN_EPS', 1e-5)
    elif fault == 'flipped_taps':
        a['dw_weight'] = np.ascontiguousarray(a['dw_weight'][..., ::-1, ::-1])
    elif fault == 'fc_transposed':  # (4c, c) read as if it were the JAX (c, 4c) layout
        a['fc1_weight'] = np.ascontiguousarray(a['fc1_weight'].T).reshape(a['fc1_weight'].shape)
    got, _ = _port(a, approximate=fault == 'gelu_flavor')
    with pytest.raises(AssertionError):
        _assert_close(got.numpy(), want, FWD_RTOL)


@pytest.mark.parametrize('case', ['dtype', 'channels_not_multiple_of_4', 'too_many_channels',
                                  'x_rank', 'fc1_in_jax_layout', 'dw_kernel_size', 'bias_shape',
                                  'noncontiguous', 'device'])
def test_wrapper_rejects(case):
    c = {'channels_not_multiple_of_4': 6, 'too_many_channels': tb.MAX_CHANNELS + 4}.get(case, 8)
    a = {k: torch.zeros(v.shape) for k, v in _inputs(1, 4, 4, 8).items()} if c == 8 else {
        'x': torch.zeros(1, 2, 2, c), 'dw_weight': torch.zeros(c, 1, 7, 7),
        'dw_bias': torch.zeros(c), 'ln_weight': torch.zeros(c), 'ln_bias': torch.zeros(c),
        'fc1_weight': torch.zeros(4 * c, c), 'fc1_bias': torch.zeros(4 * c),
        'fc2_weight': torch.zeros(c, 4 * c), 'fc2_bias': torch.zeros(c), 'gamma': torch.zeros(c)}
    if case == 'dtype':
        a['x'] = a['x'].double()
    elif case == 'x_rank':
        a['x'] = a['x'][0]
    elif case == 'fc1_in_jax_layout':
        a['fc1_weight'] = a['fc1_weight'].T.contiguous()
    elif case == 'dw_kernel_size':
        a['dw_weight'] = torch.zeros(8, 1, 3, 3)
    elif case == 'bias_shape':
        a['fc2_bias'] = torch.zeros(4)
    elif case == 'noncontiguous':
        a['x'] = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)
    elif case == 'device':
        a['x'] = a['x'].to('meta')
    with pytest.raises((ValueError, TypeError)):
        tb.fused_convnext_block(*a.values())


def test_cpu_path_counts_no_launches_and_keeps_autograd():
    before = tb.fused_convnext_block.launches
    y, _ = _port(_inputs(1, 4, 4, 8), grad=True)
    assert tb.fused_convnext_block.launches == before
    assert y.grad_fn is not None


@pytest.mark.parametrize('pixels,c,want', [
    (15360, 128, (32, 1)), (3840, 256, (32, 1)), (960, 512, (32, 4)), (240, 1024, (16, 8)),  # KBR, B=1
    (61440, 128, (32, 1)), (15360, 256, (32, 1)), (3840, 512, (32, 1)), (960, 1024, (16, 2)),  # B=4
    (35, 96, (32, 2)), (12, 40, (32, 1)), (77, 1536, (8, 8)), (10 ** 6, 2048, (8, 1))])
def test_tile_pixels_fits_shared_memory_and_fills_the_card(pixels, c, want):
    """The tile is the largest that fits a block's 227 KB; a cluster of up to 8
    blocks shares each tile while the tiles alone are fewer than 99, and never
    more blocks than there are 256-column hidden chunks."""
    m, s = tb.tile_pixels(pixels, c)
    assert (m, s) == want
    assert 4 * (m * (2 * c + 4) + 260 * m + 256 * 36) <= 227 * 1024
    assert s in (1, 2, 4, 8) and (s - 1) * 256 < 4 * c
    assert s == 1 or -(-pixels // m) * s // 2 < 99
