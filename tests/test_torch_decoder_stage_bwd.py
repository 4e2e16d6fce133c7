"""Port differential: the decoder stage's backward against the JAX package's.

- `ops.fused_upconv_stage_bwd` (on the CPU: its plain version, autograd
  through the plain stage) against `jax.grad` of
  `pallas_decoder.fused_upconv_stage`, whose custom VJP is the Pallas backward
  kernel run in interpret mode: the cases of `tests/test_pallas_decoder.py`,
  with both cotangents, `g_feat` alone and `g_disp` alone.
- Heights and widths of 2 and 3, where a reflect fold lands on the row it
  came from, are legal for the port and too small for the Pallas kernel's
  bands: there the reference is `jax.grad` of the unfused JAX stage.
- `DepthNet` with fused stages, every parameter's gradient, against the JAX
  `DepthNet` with its fused stages forced on (`SLOWTV_ENABLE_PALLAS_DEC`,
  `SLOWTV_FORCE_PALLAS_DEC`).
Same numpy inputs on both sides, float32.

Tolerance: each gradient to 5e-5 of max(1, its largest magnitude), the JAX
kernel's own against its unfused stage (sums over up to b*2h*2w pixels of
9*ci-term products, in another order). The net's gradients: atol 1e-3 of the
tensor's largest magnitude plus 1e-7, as the training-step differential.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from slowtv_monodepth_tpu.ops.pallas_decoder import fused_upconv_stage
from slowtv_monodepth_tpu_torch.ops import decoder_stage as tds
from torch_threads import two_torch_threads  # noqa: F401

NAMES = ('dx', 'dwa', 'dba', 'dwb', 'dbb', 'dwo', 'dbo')
SHAPES = [(2, 32, 24, 6, 5), (1, 48, 40, 8, 4)]  # tests/test_pallas_decoder.py:46
SMALL = [(1, 2, 3, 4, 3), (2, 3, 2, 2, 2), (1, 2, 2, 3, 2), (1, 3, 3, 1, 2), (1, 5, 2, 2, 3)]
RTOL = 5e-5


def _mk(b, h, w, ci, cd, seed=1):
    """The draws of tests/test_pallas_decoder.py:_mk, JAX layouts (HWIO), and
    the two cotangents of its VJP test."""
    rs = np.random.RandomState(seed)
    args = [(rs.randn(b, h, w, ci) * 0.5).astype(np.float32),
            (rs.randn(3, 3, ci, cd) * 0.3).astype(np.float32),
            (rs.randn(cd) * 0.1).astype(np.float32),
            (rs.randn(3, 3, cd, cd) * 0.3).astype(np.float32),
            (rs.randn(cd) * 0.1).astype(np.float32),
            (rs.randn(3, 3, cd, 1) * 0.3).astype(np.float32),
            (rs.randn(1) * 0.1).astype(np.float32)]
    rs = np.random.RandomState(2)
    return args, rs.rand(b, 2 * h, 2 * w, cd).astype(np.float32), \
        rs.rand(b, 2 * h, 2 * w, 1).astype(np.float32)


def _unfused_jax_stage(x, wa, ba, wb, bb, wo, bo):
    """tests/test_pallas_decoder.py:_ref_stage."""
    def conv(v, w_, b_):
        vp = jnp.pad(v, ((0, 0), (1, 1), (1, 1), (0, 0)), mode='reflect')
        return lax.conv_general_dilated(vp, w_, (1, 1), 'VALID',
                                        dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + b_

    def up2(v):
        b, h, w, c = v.shape
        return jnp.broadcast_to(v[:, :, None, :, None, :], (b, h, 2, w, 2, c)).reshape(
            b, 2 * h, 2 * w, c)

    ha = jax.nn.elu(conv(x, wa, ba))
    hb = jax.nn.elu(conv(up2(ha), wb, bb))
    return hb, jax.nn.sigmoid(conv(hb, wo, bo))


def _jax_grads(stage, args, g_feat, g_disp):
    """Gradients of <feat, g_feat> + <disp, g_disp>, weights back in OIHW."""
    def loss(*a):
        feat, disp = stage(*a)
        out = 0.0
        if g_feat is not None:
            out = out + (feat * g_feat).sum()
        if g_disp is not None:
            out = out + (disp * g_disp).sum()
        return out
    grads = jax.grad(loss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    return [np.asarray(g).transpose(3, 2, 0, 1) if i in (1, 3, 5) else np.asarray(g)
            for i, g in enumerate(grads)]


def _torch_args(args):
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if i in (1, 3, 5)
                             else a) for i, a in enumerate(args)]


def _port_grads(args, g_feat, g_disp, bwd=None):
    """`fused_upconv_stage_bwd` on the forward's stored tensors."""
    targs = _torch_args(args)
    gf, gd = (None if g is None else torch.from_numpy(g) for g in (g_feat, g_disp))
    feat, disp = tds.fused_upconv_stage(*targs)
    ha = torch.empty(feat.shape[0], feat.shape[1] // 2, feat.shape[2] // 2, feat.shape[3])
    return [g.numpy() for g in (bwd or tds.fused_upconv_stage_bwd)(
        *targs, ha, feat, disp, gf, gd)]


def _assert_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=RTOL * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize('cotangents', ['both', 'feat', 'disp'])
@pytest.mark.parametrize('b,h,w,ci,cd', SHAPES)
def test_backward_matches_jax_kernel(b, h, w, ci, cd, cotangents):
    args, g_feat, g_disp = _mk(b, h, w, ci, cd)
    g_feat = None if cotangents == 'disp' else g_feat
    g_disp = None if cotangents == 'feat' else g_disp
    _assert_close(_port_grads(args, g_feat, g_disp),
                  _jax_grads(fused_upconv_stage, args, g_feat, g_disp))


@pytest.mark.parametrize('b,h,w,ci,cd', SMALL)
def test_backward_matches_jax_on_the_smallest_grids(b, h, w, ci, cd):
    args, g_feat, g_disp = _mk(b, h, w, ci, cd)
    _assert_close(_port_grads(args, g_feat, g_disp),
                  _jax_grads(_unfused_jax_stage, args, g_feat, g_disp))


def test_autograd_through_the_wrapper_is_the_backward():
    """`fused_upconv_stage(...)` under grad gives what `fused_upconv_stage_bwd` gives."""
    args, g_feat, g_disp = _mk(1, 6, 5, 4, 3)
    leaves = [t.requires_grad_() for t in _torch_args(args)]
    feat, disp = tds.fused_upconv_stage(*leaves)
    got = torch.autograd.grad([feat, disp], leaves,
                              [torch.from_numpy(g_feat), torch.from_numpy(g_disp)])
    for g, w in zip(got, _port_grads(args, g_feat, g_disp)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)


def test_need_mask_drops_gradients():
    args, g_feat, g_disp = _mk(1, 4, 4, 3, 2)
    targs = _torch_args(args)
    feat, disp = tds.fused_upconv_stage(*targs)
    ha = torch.empty(1, 4, 4, 2)
    got = tds.fused_upconv_stage_bwd(*targs, ha, feat, disp, torch.from_numpy(g_feat), None,
                                     need=(False, True, False, True))
    assert [g is None for g in got] == [True, False, False, True, True, False, False]


@pytest.mark.parametrize('fault', ['reflect_before_upsample', 'elu_grad_dropped',
                                   'fold_dropped'])
def test_differential_has_teeth(fault):
    """The comparison fails on a backward with one deliberate mistake."""
    import torch.nn.functional as F
    args, g_feat, g_disp = _mk(*SHAPES[0])

    def faulty(x, wa, ba, wb, bb, wo, bo, ha, feat, disp, gf, gd):
        leaves = [t.detach().requires_grad_() for t in (x, wa, ba, wb, bb, wo, bo)]
        x, wa, ba, wb, bb, wo, bo = leaves
        pad = 'replicate' if fault == 'fold_dropped' else 'reflect'

        def conv(v, w, b):
            return F.conv2d(F.pad(v, (1, 1, 1, 1), mode=pad), w, b)

        za = conv(x.permute(0, 3, 1, 2), wa, ba)
        # `elu_grad_dropped`: the forward value of ELU with the derivative 1
        # everywhere (dza = dha, without the elu'(ha) factor).
        ha = F.elu(za) if fault != 'elu_grad_dropped' else za + (F.elu(za) - za).detach()
        if fault == 'reflect_before_upsample':
            u = F.interpolate(F.pad(ha, (1, 1, 1, 1), mode='reflect'), scale_factor=2)
            feat = F.elu(F.conv2d(u[..., 1:-1, 1:-1], wb, bb))
        else:
            feat = F.elu(conv(F.interpolate(ha, scale_factor=2), wb, bb))
        disp = torch.sigmoid(conv(feat, wo, bo))
        return torch.autograd.grad([feat.permute(0, 2, 3, 1), disp.permute(0, 2, 3, 1)],
                                   leaves, [gf, gd])

    want = _jax_grads(fused_upconv_stage, args, g_feat, g_disp)
    got = _port_grads(args, g_feat, g_disp, bwd=faulty)
    with pytest.raises(AssertionError):
        _assert_close(got[:1], want[:1])  # dx sees every fault


def test_depthnet_gradients_with_fused_stages_match_jax(monkeypatch):
    from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
    from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
    from slowtv_monodepth_tpu_torch.models import (DepthNet, depth_state_dict_from_jax,
                                                   seeded_state_dict)
    monkeypatch.setenv('SLOWTV_ENABLE_PALLAS_DEC', '1')
    monkeypatch.setenv('SLOWTV_FORCE_PALLAS_DEC', '1')
    cfg = {'enc_name': 'convnext_atto', 'pretrained': False, 'out_scales': [0, 1, 2, 3]}
    net = DepthNet(**cfg)
    assert net.decoders['disp'].fused_stages
    sd = seeded_state_dict(net, 0)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)

    net.train()
    out = net(torch.from_numpy(x).permute(0, 3, 1, 2))['disp']
    sum((d * d).mean() for d in out.values()).backward()
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}

    params, _ = convert_reference_ckpt({f'nets.depth.{k}': v for k, v in sd.items()},
                                       {'net': {'depth': cfg}})
    jnet = JaxDepthNet(**{**cfg, 'out_scales': tuple(cfg['out_scales'])})

    def loss(p):
        disp = jnet.apply({'params': p}, jnp.asarray(x), train=True)['disp']
        return sum((d * d).mean() for d in disp.values())

    grads = jax.jit(jax.grad(loss))(params['depth'])
    want = {k: v.numpy() for k, v in
            depth_state_dict_from_jax(jax.tree.map(np.asarray, grads), cfg['out_scales']).items()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3 * np.abs(want[k]).max() + 1e-7,
                                   err_msg=k)
