"""Pretrained encoder weights: the port's graft against the JAX package's.

A seeded `convnext_atto` state dict in timm's layout (`chip_smoke.timm_state_dict`:
the encoder's keys and timm's `head.*`) is written under a temporary model
root as `.npz` and as `.pth` (wrapped in {'state_dict': ...}). The JAX
package's `load_pretrained_encoder` grafts it into a param tree, carried into
the port's keys by the weight bridge (`models.from_jax`); the port's
`load_pretrained_encoder` grafts it into a `DepthNet` (3 input channels) and a
`PoseNet` (6: the stem tiled and scaled by 3 / 6). Both must be bitwise equal:
the same float32 numbers moved, one float32 product for the pose stem.

Also: a missing key raises naming it; `head.*` is ignored; the weights are
what `MonoDepthTrainer` trains from in both nets (after the initial draw, not
overwritten by it), also with `fused_blocks`, whose forward then reads them.
Teeth: an unadapted stem (tiled, not scaled) fails the pose case.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from slowtv_monodepth_tpu.models.encoders import pretrained as jpre
from slowtv_monodepth_tpu_torch import paths
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.models import DepthNet, PoseNet
from slowtv_monodepth_tpu_torch.models.encoders import import_torch, pretrained
from slowtv_monodepth_tpu_torch.models.from_jax import _convnext
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

ENC = 'convnext_atto'
NET = {'depth': {'enc_name': ENC, 'pretrained': True, 'dec_name': 'monodepth',
                 'out_scales': [0, 1, 2, 3]},
       'pose': {'enc_name': ENC, 'pretrained': True, 'learn_K': True}}
LOSS = {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
        'disp_smooth': {'weight': 0.001, 'use_edges': True}}


@pytest.fixture(scope='module')
def timm_sd() -> dict:
    return chip_smoke.timm_state_dict(ENC, seed=3)


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A model root searched first by both packages (the JAX module binds
    `MODEL_ROOTS` at import)."""
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path] + list(paths.MODEL_ROOTS))
    monkeypatch.setattr(jpre, 'MODEL_ROOTS', [tmp_path])
    return tmp_path


def _jax_graft(in_chans: int) -> dict:
    variables = jpre.load_pretrained_encoder({'params': {}}, ENC, in_chans)
    return {k: v.numpy() for k, v in _convnext(variables['params']['encoder']).items()}


def _port_graft(in_chans: int) -> dict:
    net = (DepthNet if in_chans == 3 else PoseNet)(enc_name=ENC)
    assert pretrained.load_pretrained_encoder(net, ENC, in_chans)
    return {k: v.numpy() for k, v in net.encoder.state_dict().items()}


def _faults(got: dict, want: dict) -> list:
    assert sorted(got) == sorted(want)
    return [k for k in want if not (got[k].dtype == want[k].dtype and
                                   np.array_equal(got[k], want[k]))]


@pytest.mark.parametrize('in_chans', [3, 6], ids=['depth', 'pose'])
@pytest.mark.parametrize('suffix', ['.npz', '.pth'])
def test_graft_equals_the_jax_loader_bitwise(root, timm_sd, suffix, in_chans):
    chip_smoke.write_timm_file(root, ENC, suffix, timm_sd)
    assert _faults(_port_graft(in_chans), _jax_graft(in_chans)) == []


def test_pose_stem_is_tiled_and_scaled(root, timm_sd):
    chip_smoke.write_timm_file(root, ENC, '.npz', timm_sd)
    stem = _port_graft(6)['stem.0.weight']
    w = timm_sd['stem.0.weight']
    assert stem.shape == (w.shape[0], 6) + w.shape[2:]
    np.testing.assert_array_equal(stem, np.concatenate([w, w], 1) * np.float32(0.5))


def test_unadapted_stem_fails_the_pose_case(root, timm_sd, monkeypatch):
    chip_smoke.write_timm_file(root, ENC, '.npz', timm_sd)
    want = _jax_graft(6)
    monkeypatch.setattr(import_torch, 'adapt_input_conv',
                        lambda w, n: np.tile(w, (1, n // w.shape[1], 1, 1)))
    assert _faults(_port_graft(6), want) == ['stem.0.weight']


def test_a_missing_key_raises_naming_it(root, timm_sd):
    sd = {k: v for k, v in timm_sd.items() if k != 'stages.2.blocks.5.mlp.fc2.bias'}
    chip_smoke.write_timm_file(root, ENC, '.npz', sd)
    with pytest.raises(KeyError, match='stages.2.blocks.5.mlp.fc2.bias'):
        _port_graft(3)
    with pytest.raises(KeyError, match='stages.2.blocks.5.mlp.fc2.bias'):
        _jax_graft(3)


def test_head_keys_are_ignored(root, timm_sd):
    assert any(k.startswith('head.') for k in timm_sd)
    chip_smoke.write_timm_file(root, ENC, '.npz', timm_sd)
    with_head = _port_graft(3)
    chip_smoke.write_timm_file(root, ENC, '.npz',
                               {k: v for k, v in timm_sd.items() if not k.startswith('head.')})
    assert _faults(_port_graft(3), with_head) == []


@pytest.mark.parametrize('fused_blocks', [False, True], ids=['unfused', 'fused'])
def test_the_trainer_trains_from_the_grafted_weights(root, timm_sd, fused_blocks):
    """Both nets carry the file's weights after `MonoDepthTrainer` built them
    (the initial draw first), and the fused blocks' forward reads them: it
    gives the unfused net's output."""
    chip_smoke.write_timm_file(root, ENC, '.pth', timm_sd)
    net_cfg = {k: {**v, 'fused_blocks': fused_blocks} for k, v in NET.items()}
    torch.manual_seed(0)
    trainer = MonoDepthTrainer({'net': net_cfg, 'loss': LOSS})
    for key, in_chans in (('depth', 3), ('pose', 6)):
        got = {k: v.numpy() for k, v in trainer.nets[key].encoder.state_dict().items()}
        assert _faults(got, _port_graft(in_chans)) == [], key
    if not fused_blocks:
        return
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 64, 96).astype(np.float32))
    unfused = DepthNet(enc_name=ENC)
    unfused.load_state_dict(trainer.nets['depth'].state_dict())
    with torch.no_grad():
        want = unfused(x)['disp'][0]
        got = trainer.nets['depth'](x)['disp'][0]
        blank = DepthNet(enc_name=ENC, fused_blocks=True)(x)['disp'][0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert not np.allclose(blank.numpy(), want.numpy(), atol=1e-3)
