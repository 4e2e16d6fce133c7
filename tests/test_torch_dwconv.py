"""Port differential: `ops.dwconv.depthwise_conv` vs the JAX package's.

The JAX side runs its Pallas kernel in interpret mode on the CPU
(`SLOWTV_FORCE_PALLAS_DWCONV`, as `tests/test_pallas_dwconv.py` does); the
port's wrapper takes its plain PyTorch version because the tensors lie on
the CPU. Same numpy inputs on both sides, float32.

Tolerance: atol 1e-5, the JAX kernel's own against XLA's conv (K*K <= 81
O(1) products summed in another order; measured ~1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.ops import pallas_dwconv as pd
from slowtv_monodepth_tpu_torch.ops import dwconv as td
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = [  # tests/test_pallas_dwconv.py:34-39
    (2, 16, 24, 96, 7),
    (1, 9, 13, 128, 3),
    (2, 24, 40, 160, 5),
    (1, 17, 160, 96, 7),
]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _force_pallas(monkeypatch):
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_DWCONV', '1')


def _inputs(b, h, w, c, k, seed=42):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, c).astype(np.float32)
    taps = (rs.randn(k, k, c) * 0.2).astype(np.float32)   # JAX layout (k, k, c)
    bias = rs.randn(c).astype(np.float32)
    return x, taps, bias


def _jax(x, taps, bias):
    return np.asarray(pd.depthwise_conv(jnp.asarray(x), jnp.asarray(taps), jnp.asarray(bias)))


def _port(x, taps, bias, fault=None):
    w = np.ascontiguousarray(taps.transpose(2, 0, 1)[:, None])  # (c, 1, k, k)
    if fault == 'flipped_taps':
        w = np.ascontiguousarray(w[..., ::-1, ::-1])
    out = td.depthwise_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    return out.numpy()


@pytest.mark.parametrize('b,h,w,c,k', SHAPES)
def test_matches_jax(b, h, w, c, k):
    x, taps, bias = _inputs(b, h, w, c, k)
    ref = _jax(x, taps, bias)
    out = _port(x, taps, bias)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize('fault', ['flipped_taps'])
def test_differential_has_teeth(fault):
    """The comparison above fails when the port's taps are flipped."""
    x, taps, bias = _inputs(*SHAPES[0])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_port(x, taps, bias, fault), _jax(x, taps, bias),
                                   atol=ATOL)


def test_no_bias_matches_jax():
    x, taps, _ = _inputs(1, 9, 13, 40, 3, seed=3)
    w = torch.from_numpy(np.ascontiguousarray(taps.transpose(2, 0, 1)[:, None]))
    out = td.depthwise_conv(torch.from_numpy(x), w)
    ref = np.asarray(pd.depthwise_conv(jnp.asarray(x), jnp.asarray(taps)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_cpu_path_does_not_count_launches():
    x, taps, bias = _inputs(1, 8, 8, 32, 7)
    before = td.depthwise_conv.launches
    _port(x, taps, bias)
    assert td.depthwise_conv.launches == before


@pytest.mark.parametrize('case', ['dtype', 'even_k', 'weight_shape', 'bias_shape',
                                  'noncontiguous', 'device'])
def test_wrapper_rejects(case):
    x = torch.zeros(1, 8, 8, 16)
    w = torch.zeros(16, 1, 7, 7)
    b = torch.zeros(16)
    if case == 'dtype':
        x = x.double()
    elif case == 'even_k':
        w = torch.zeros(16, 1, 6, 6)
    elif case == 'weight_shape':
        w = torch.zeros(8, 1, 7, 7)
    elif case == 'bias_shape':
        b = torch.zeros(8)
    elif case == 'noncontiguous':
        x = torch.zeros(1, 16, 8, 8).permute(0, 2, 3, 1)
    elif case == 'device':
        x = x.to('meta')
    with pytest.raises((ValueError, TypeError)):
        td.depthwise_conv(x, w, b)
