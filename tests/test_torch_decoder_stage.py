"""Port differential: `ops.fused_upconv_stage` vs `pallas_decoder.fused_upconv_stage`.

The JAX side runs the fused Pallas stage in interpret mode on the CPU (as
`tests/test_pallas_decoder.py` does); the port's wrapper takes its plain
PyTorch version because the tensors lie on the CPU. Same numpy inputs.

Tolerance: atol 1e-5, the JAX kernel's own against the unfused stage
(9*ci-term float32 sums through ELU and sigmoid; measured ~1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu.ops.pallas_decoder import fused_upconv_stage
from slowtv_monodepth_tpu_torch.ops import decoder_stage as tds
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = [(2, 32, 24, 6, 5), (1, 48, 40, 8, 4)]  # tests/test_pallas_decoder.py:46
ATOL = 1e-5


def _mk(b, h, w, ci, cd, seed=0):
    """Same draws as tests/test_pallas_decoder.py:_mk, JAX layouts (HWIO)."""
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, h, w, ci) * 0.5).astype(np.float32),
            (rs.randn(3, 3, ci, cd) * 0.3).astype(np.float32),
            (rs.randn(cd) * 0.1).astype(np.float32),
            (rs.randn(3, 3, cd, cd) * 0.3).astype(np.float32),
            (rs.randn(cd) * 0.1).astype(np.float32),
            (rs.randn(3, 3, cd, 1) * 0.3).astype(np.float32),
            (rs.randn(1) * 0.1).astype(np.float32)]


def _torch_args(args):
    """HWIO -> OIHW for the three kernels; x stays NHWC."""
    out = []
    for i, a in enumerate(args):
        if i in (1, 3, 5):
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out.append(torch.from_numpy(a))
    return out


def _faulty_stage(fault, x, wa, ba, wb, bb, wo, bo):
    """The plain stage with one deliberate mistake."""
    pad = 'constant' if fault == 'zero_padding' else 'reflect'

    def conv(v, w, b):
        return F.conv2d(F.pad(v, (1, 1, 1, 1), mode=pad), w, b)

    ha = F.elu(conv(x.permute(0, 3, 1, 2), wa, ba))
    if fault == 'reflect_before_upsample':
        # Reflect ha, then upsample and crop: u[-1] becomes ha[1], not ha[0].
        u = F.interpolate(F.pad(ha, (1, 1, 1, 1), mode='reflect'), scale_factor=2)
        feat = F.elu(F.conv2d(u[..., 1:-1, 1:-1], wb, bb))
    else:
        feat = F.elu(conv(F.interpolate(ha, scale_factor=2), wb, bb))
    disp = torch.sigmoid(conv(feat, wo, bo))
    return feat.permute(0, 2, 3, 1), disp.permute(0, 2, 3, 1)


def _jax(args):
    feat, disp = fused_upconv_stage(*[jnp.asarray(a) for a in args])
    return np.asarray(feat), np.asarray(disp)


@pytest.mark.parametrize('b,h,w,ci,cd', SHAPES)
def test_matches_jax(b, h, w, ci, cd):
    args = _mk(b, h, w, ci, cd)
    f_ref, d_ref = _jax(args)
    feat, disp = tds.fused_upconv_stage(*_torch_args(args))
    assert feat.shape == f_ref.shape and disp.shape == d_ref.shape
    np.testing.assert_allclose(feat.numpy(), f_ref, atol=ATOL)
    np.testing.assert_allclose(disp.numpy(), d_ref, atol=ATOL)


@pytest.mark.parametrize('fault', ['zero_padding', 'reflect_before_upsample'])
def test_differential_has_teeth(fault):
    """The comparison above fails on a stage with either mistake."""
    args = _mk(*SHAPES[0])
    f_ref, d_ref = _jax(args)
    feat, disp = _faulty_stage(fault, *_torch_args(args))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(feat.numpy(), f_ref, atol=ATOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(disp.numpy(), d_ref, atol=ATOL)


def test_cpu_path_does_not_count_launches():
    before = tds.fused_upconv_stage.launches
    tds.fused_upconv_stage(*_torch_args(_mk(1, 4, 4, 3, 2)))
    assert tds.fused_upconv_stage.launches == before


@pytest.mark.parametrize('case', ['dtype', 'too_small', 'wa_shape', 'wo_shape',
                                  'noncontiguous', 'too_many_channels'])
def test_wrapper_rejects(case):
    args = _torch_args(_mk(1, 6, 6, 4, 3))
    if case == 'dtype':
        args[0] = args[0].double()
    elif case == 'too_small':
        args[0] = args[0][:, :1].contiguous()
    elif case == 'wa_shape':
        args[1] = torch.zeros(3, 5, 3, 3)
    elif case == 'wo_shape':
        args[5] = torch.zeros(2, 3, 3, 3)
    elif case == 'noncontiguous':
        args[0] = args[0].transpose(1, 2)
    elif case == 'too_many_channels':
        ci = tds.MAX_CHANNELS + 1
        args[0] = torch.zeros(1, 4, 4, ci)
        args[1] = torch.zeros(3, ci, 3, 3)
    with pytest.raises((ValueError, TypeError)):
        tds.fused_upconv_stage(*args)
