"""Port differential for the serving slice: `DepthNet` (ConvNeXt + monodepth).

Weights: `models.seeded_state_dict` draws numpy weights for the port's
state-dict keys; the JAX package's `convert_reference_ckpt` turns them into
JAX params, and the port loads those back through
`depth_state_dict_from_jax`, so both bridges carry the weights.

The JAX side runs with both Pallas switches enabled and forced (interpret
mode on the CPU), as `tests/test_pallas_decoder.py:80-94` does: every
ConvNeXt depthwise conv and both skip-less decoder stages go through the
JAX package's kernels. The port runs on the CPU, so its wrappers take their
plain versions.

Tolerance: disparities atol 1e-5 (float32 sigmoid outputs after ~12
residual blocks and the decoder, sums in another order; measured ~1e-6).
Encoder features: 1e-4 relative to their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch.models import (DepthNet, depth_state_dict_from_jax,
                                               seeded_state_dict)
from torch_threads import two_torch_threads  # noqa: F401

ENC = 'convnext_atto'
SHAPE = (2, 64, 96, 3)
DISP_ATOL = 1e-5
FEAT_RTOL = 1e-4
PALLAS_SWITCHES = ('SLOWTV_ENABLE_PALLAS_DWCONV', 'SLOWTV_FORCE_PALLAS_DWCONV',
                   'SLOWTV_ENABLE_PALLAS_DEC', 'SLOWTV_FORCE_PALLAS_DEC')


def depth_cfg(enc_name=ENC, out_scales=(0, 1, 2, 3), **kw) -> dict:
    return {'enc_name': enc_name, 'dec_name': 'monodepth',
            'out_scales': list(out_scales), **kw}


def jax_params_from_port_keys(sd: dict, cfg: dict) -> dict:
    """Port-keyed numpy weights -> JAX depth params (the JAX converter)."""
    params, _ = convert_reference_ckpt({f'nets.depth.{k}': v for k, v in sd.items()},
                                       {'net': {'depth': cfg}})
    return params['depth']


def seeded_pair(cfg: dict, seed: int = 0, **port_kw):
    """-> (port DepthNet on the CPU, JAX depth params), same seeded weights."""
    with torch.device('meta'):   # shapes only: every tensor is loaded
        net = DepthNet(**cfg, **port_kw)
    params = jax_params_from_port_keys(seeded_state_dict(net, seed), cfg)
    net.to_empty(device='cpu').load_state_dict(depth_state_dict_from_jax(params, cfg['out_scales']))
    return net.eval(), params


def port_forward(net, x: np.ndarray) -> dict:
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _input(seed=1):
    return np.random.RandomState(seed).standard_normal(SHAPE).astype(np.float32)


@pytest.fixture(scope='module')
def kbr_slice():
    cfg = depth_cfg()
    net, params = seeded_pair(cfg)
    x = _input()
    with pytest.MonkeyPatch.context() as mp:
        for name in PALLAS_SWITCHES:
            mp.setenv(name, '1')
        ref = JaxDepthNet(**cfg, pretrained=False).apply(
            {'params': params}, jnp.asarray(x), train=False)
    return {'cfg': cfg, 'params': params, 'x': x, 'port': port_forward(net, x),
            'jax': jax.tree.map(np.asarray, ref)}


@pytest.mark.parametrize('scale', [0, 1, 2, 3])
def test_slice_disp_matches_jax(kbr_slice, scale):
    got = nhwc(kbr_slice['port']['disp'][scale])
    want = kbr_slice['jax']['disp'][scale]
    assert got.shape == want.shape == (SHAPE[0], SHAPE[1] >> scale, SHAPE[2] >> scale, 1)
    np.testing.assert_allclose(got, want, atol=DISP_ATOL)


@pytest.mark.parametrize('stage', [0, 1, 2, 3])
def test_slice_encoder_features_match_jax(kbr_slice, stage):
    got = nhwc(kbr_slice['port']['depth_feats'][stage])
    want = kbr_slice['jax']['depth_feats'][stage]
    np.testing.assert_allclose(got, want, atol=FEAT_RTOL * np.abs(want).max())


@pytest.mark.parametrize('fault', [dict(gelu='tanh'), dict(dec_pad_mode='zeros')])
def test_slice_differential_has_teeth(kbr_slice, fault):
    """tanh GELU where exact was asked, or zero-padded decoder convs, fail."""
    net = DepthNet(**kbr_slice['cfg'], **fault).eval()
    net.load_state_dict(depth_state_dict_from_jax(kbr_slice['params']))
    disp = port_forward(net, kbr_slice['x'])['disp']
    with pytest.raises(AssertionError):
        for s in range(4):
            np.testing.assert_allclose(nhwc(disp[s]), kbr_slice['jax']['disp'][s],
                                       atol=DISP_ATOL)


def test_stereo_mask_blend_outputs_match_jax():
    """Virtual stereo + mask decoder + flip blending (unfused stages)."""
    cfg = depth_cfg(out_scales=(0, 2), use_virtual_stereo=True,
                    mask_name='explainability', num_ch_mask=2, use_stereo_blend=True)
    net, params = seeded_pair(cfg, seed=3)
    x = _input(seed=4)
    ref = JaxDepthNet(**cfg, pretrained=False).apply(
        {'params': params}, jnp.asarray(x), train=False)
    out = port_forward(net, x)
    assert sorted(out) == sorted(ref)
    for key in ('disp', 'disp_stereo', 'mask'):
        assert sorted(out[key]) == sorted(ref[key]) == [0, 2]
        for s in (0, 2):
            np.testing.assert_allclose(nhwc(out[key][s]), np.asarray(ref[key][s]),
                                       atol=DISP_ATOL, err_msg=f'{key}[{s}]')


def test_state_dict_round_trip_through_jax_converter():
    """JAX params -> port state dict -> `convert_reference_ckpt` -> equal leaves.

    The params come from the JAX converter (a full `init` of the JAX net
    takes ~20 s here); `kbr_slice` shows that tree is the one the JAX
    `DepthNet` applies.
    """
    cfg = depth_cfg()
    rs = np.random.RandomState(5)
    keys = DepthNet(**cfg).state_dict()
    params = jax_params_from_port_keys(
        {k: rs.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in keys.items()},
        cfg)
    params = jax.tree.map(np.asarray, params)
    net = DepthNet(**cfg)
    net.load_state_dict(depth_state_dict_from_jax(params))  # strict: every key
    back = jax_params_from_port_keys(
        {k: v.numpy() for k, v in net.state_dict().items()}, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_convnext_specs_match_jax():
    """Every ConvNeXt variant is built with the JAX package's depths and widths."""
    from slowtv_monodepth_tpu.models.encoders.convnext import CONVNEXT_SPECS as JAX_SPECS
    from slowtv_monodepth_tpu_torch.models.encoders import CONVNEXT_SPECS
    assert sorted(CONVNEXT_SPECS) == sorted(JAX_SPECS)
    for name, spec in JAX_SPECS.items():
        for key in ('depths', 'dims', 'channels', 'reductions'):
            assert list(CONVNEXT_SPECS[name][key]) == list(spec[key]), (name, key)


def test_unported_configurations_raise():
    """The encoder families of ROADMAP A10d (beyond ConvNeXt, ResNet, ResNeXt and the DPT
    ViTs) raise naming it: MobileNet, and the BEiT and Swin DPT backbones."""
    for enc in ('mobilenetv3_large_100', 'dpt_beitb16_384', 'dpt_swin2b24_384'):
        with pytest.raises(NotImplementedError, match=r'queue A item 10d \(A10d\)'):
            DepthNet(enc_name=enc, dec_name='dpt')


# ------------------------------------------------------------- fused ConvNeXt blocks
FUSED_ENC = dict(depths=(1, 2, 1, 1), dims=(128, 128, 256, 256))
FUSED_SHAPE = (1, 96, 128, 3)   # stages at 24x32, 12x16, 6x8 and (below the JAX kernel's halo) 3x4


@pytest.fixture(scope='module')
def fused_encoder():
    """A ConvNeXt encoder on lane-aligned widths, seeded, on both sides with
    every block fused: the JAX encoder under `SLOWTV_FORCE_PALLAS_CONVNEXT`
    (its block kernel in interpret mode wherever it takes the shape, as
    `tests/test_pallas_convnext.py` forces it), the port with `fused_blocks`."""
    from slowtv_monodepth_tpu.models.encoders import ConvNeXtEncoder as JaxEncoder
    from slowtv_monodepth_tpu.models.encoders.import_torch import convert_convnext
    from slowtv_monodepth_tpu.ops import pallas_convnext
    from slowtv_monodepth_tpu_torch.models.encoders import ConvNeXtEncoder
    from slowtv_monodepth_tpu_torch.models.from_jax import _convnext as convnext_from_jax

    nets = {fused: ConvNeXtEncoder(**FUSED_ENC, fused_blocks=fused).eval()
            for fused in (True, False)}
    params = convert_convnext(seeded_state_dict(nets[True], 11), FUSED_ENC['depths'])
    for net in nets.values():
        net.load_state_dict(convnext_from_jax(params))
    x = np.random.RandomState(12).standard_normal(FUSED_SHAPE).astype(np.float32)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SLOWTV_FORCE_PALLAS_CONVNEXT', '1')
        inner = pallas_convnext.fused_convnext_block
        mp.setattr(pallas_convnext, 'fused_convnext_block',
                   lambda *a, **k: calls.append(a[0].shape) or inner(*a, **k))
        ref = JaxEncoder(**FUSED_ENC).apply({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        feats = {fused: [nhwc(f) for f in net(xt)] for fused, net in nets.items()}
    return {'nets': nets, 'jax': [np.asarray(f) for f in ref], 'port': feats, 'calls': calls}


@pytest.mark.parametrize('stage', [0, 1, 2, 3])
def test_fused_encoder_features_match_jax_fused_encoder(fused_encoder, stage):
    got, want = fused_encoder['port'][True][stage], fused_encoder['jax'][stage]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FEAT_RTOL * np.abs(want).max())


def test_jax_side_of_the_fused_encoder_ran_its_block_kernel(fused_encoder):
    """Four of the five blocks (h >= 6) went through the JAX block kernel."""
    assert fused_encoder['calls'] == [(1, 24, 32, 128), (1, 12, 16, 128), (1, 12, 16, 128),
                                      (1, 6, 8, 256)]


@pytest.mark.parametrize('stage', [0, 1, 2, 3])
def test_fused_encoder_matches_unfused_encoder(fused_encoder, stage):
    got, want = fused_encoder['port'][True][stage], fused_encoder['port'][False][stage]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_state_dict_keys_do_not_depend_on_fused_blocks(fused_encoder):
    on, off = (fused_encoder['nets'][f].state_dict() for f in (True, False))
    assert list(on) == list(off)
    assert all(torch.equal(on[k], off[k]) for k in on)
    cfg = depth_cfg()
    assert list(DepthNet(**cfg, fused_blocks=True).state_dict()) == list(DepthNet(**cfg).state_dict())


@pytest.mark.parametrize('gelu', ['exact', 'tanh'])
def test_fused_depthnet_matches_jax_depthnet(gelu):
    """`DepthNet(fused_blocks=True)` at widths off the 128 lanes (ConvNeXt-atto:
    40..320), where the JAX package runs its unfused blocks."""
    cfg = depth_cfg(gelu=gelu)
    net, params = seeded_pair(cfg, seed=13, fused_blocks=True)
    x = _input(seed=14)
    ref = JaxDepthNet(**cfg, pretrained=False).apply({'params': params}, jnp.asarray(x),
                                                     train=False)
    out = port_forward(net, x)
    for s in range(4):
        np.testing.assert_allclose(nhwc(out['disp'][s]), np.asarray(ref['disp'][s]),
                                   atol=DISP_ATOL)
