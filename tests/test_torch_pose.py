"""Port differential: `models.PoseNet` (ConvNeXt, learned intrinsics) vs the JAX package's.

Weights: `models.seeded_state_dict` for the port's keys -> the JAX
package's `convert_reference_ckpt` (`nets.pose.` keys) -> the port's
`pose_state_dict_from_jax`, so both bridges carry the weights. The JAX
side runs its ConvNeXt blocks on XLA (the JAX package's training default);
the port's depthwise convs take their plain version (CPU tensors).

Tolerance: outputs atol 1e-5 (float32 through ~12 residual blocks and the
heads; R and t are scaled by pose_eps = 0.01).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.models import PoseNet as JaxPoseNet
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch.models import PoseNet, pose_state_dict_from_jax, seeded_state_dict
from torch_threads import two_torch_threads  # noqa: F401

CFG = {'enc_name': 'convnext_atto', 'learn_K': True}
ATOL = 1e-5


def _jax_params(sd: dict, cfg=CFG) -> dict:
    params, _ = convert_reference_ckpt({f'nets.pose.{k}': v for k, v in sd.items()},
                                       {'net': {'pose': cfg}})
    return params['pose']


@pytest.fixture(scope='module')
def pair():
    net = PoseNet(**CFG).eval()
    params = _jax_params(seeded_state_dict(net, 0))
    net.load_state_dict(pose_state_dict_from_jax(params))
    x = np.random.RandomState(1).rand(3, 64, 96, 6).astype(np.float32)
    want = JaxPoseNet(**CFG).apply({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, jax.tree.map(np.asarray, want), params


@pytest.mark.parametrize('key', ['R', 't', 'fs', 'cs'])
def test_outputs_match_jax(pair, key):
    got, want, _ = pair
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key].numpy(), want[key], atol=ATOL)


def test_build_K_matches_jax():
    rs = np.random.RandomState(2)
    fs, cs = rs.rand(4, 2).astype(np.float32), rs.rand(4, 2).astype(np.float32)
    np.testing.assert_array_equal(
        PoseNet.build_K(torch.from_numpy(fs), torch.from_numpy(cs)).numpy(),
        np.asarray(JaxPoseNet.build_K(jnp.asarray(fs), jnp.asarray(cs))))


def test_state_dict_round_trip_through_jax_converter(pair):
    """JAX params -> port state dict -> `convert_reference_ckpt` -> equal leaves."""
    _, _, params = pair
    net = PoseNet(**CFG)
    net.load_state_dict(pose_state_dict_from_jax(params))  # strict: every key
    back = _jax_params({k: v.numpy() for k, v in net.state_dict().items()})
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, back))[0])
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0]
    assert len(ref) == len(flat)
    for path, leaf in ref:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_differential_has_teeth(pair):
    """Focal and offset heads swapped fail the learned-intrinsics outputs."""
    got, want, params = pair
    swapped = dict(params, decoders_focal=params['decoders_offset'],
                   decoders_offset=params['decoders_focal'])
    net = PoseNet(**CFG).eval()
    net.load_state_dict(pose_state_dict_from_jax(swapped))
    x = np.random.RandomState(1).rand(3, 64, 96, 6).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(out['fs'].numpy(), want['fs'], atol=ATOL)


def test_without_learned_intrinsics():
    net = PoseNet(enc_name='convnext_atto')
    assert sorted(net.decoders) == ['pose']
    assert sorted(net(torch.zeros(1, 6, 32, 32))) == ['R', 't']


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        PoseNet(enc_name='convnext_atto', input_scale=2)
    with pytest.raises(NotImplementedError, match='queue A item 10'):
        PoseNet(enc_name='hrnet_w18')
