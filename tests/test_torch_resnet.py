"""Port differentials for the ResNet and ResNeXt encoders, their BatchNorm state,
the weight bridges that carry it, and serving a BatchNorm checkpoint.

Same numpy inputs (seeded) through the JAX package and the port, float32, the
port on the CPU. Weights: `models.seeded_state_dict` draws the port's keys
(BatchNorm buffers included: a positive running variance); the JAX package's
converters (`import_torch.convert_resnet`, `convert_reference_ckpt`) carry them
to its params and `batch_stats`, and `models.from_jax` carries trees back.

- the encoders: ResNet-18 (basic blocks, as published) at 3 and 6 input
  channels, a bottleneck ResNet (at 3) and a ResNeXt (groups 32, width 8; at 6)
  cut to one block a stage, on (2, 64, 96) images: features in eval and train
  mode, the running statistics after two train-mode passes against flax's
  mutated `batch_stats`, and the gradient of every parameter, the JAX side in
  float64 (`jax_encoder_run` says why);
- `models.norm.BatchNorm2d` on the (4, 3, 3, 2) input that shows flax's update;
- `convert_resnet`: a timm-layout `.npz` grafted by both packages' loaders;
- the `from_jax` bridge with `batch_stats`, `train_state_from_jax` with `aux`;
- a reference-layout checkpoint with buffers served by `BenchmarkPredictor`
  against the JAX package's forward on the same file (ResNet-18, and a
  ResNeXt-101 32x8d cut to one block a stage).

Tolerances: features (the port in float32, eval and train mode) 1e-5 of each
map's largest magnitude; running statistics 1e-5 of each tensor's largest value;
gradients: the port's float64 pass per tensor 1e-6 of the largest magnitude
(agreement to ~3e-8), its float32 pass as one vector within 2e-3 relative L2 of
the float64 oracle (measured 1.4e-5 to 4.6e-4: a ReLU within float32 rounding of
its threshold flips a gate, so one tensor of the float32 gradient can be 1e-2 off
while the port's float64 one is not); served disparities atol 1e-5
(`tests/test_torch_predictors.py`). Every check has a fault that fails it.
"""
import functools
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
from slowtv_monodepth_tpu.models.encoders import RESNET_SPECS as JAX_RESNET_SPECS
from slowtv_monodepth_tpu.models.encoders import pretrained as jpre
from slowtv_monodepth_tpu.models.encoders.import_torch import convert_resnet as jax_convert
from slowtv_monodepth_tpu.models.encoders.resnet import ResNetEncoder as JaxResNet
from slowtv_monodepth_tpu.models.import_reference import (convert_reference_ckpt,
                                                          load_reference_ckpt)
from slowtv_monodepth_tpu_torch import paths
from slowtv_monodepth_tpu_torch.core import save_checkpoint
from slowtv_monodepth_tpu_torch.core.predictors import BenchmarkPredictor
from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
from slowtv_monodepth_tpu_torch.models import norm
from slowtv_monodepth_tpu_torch.models.encoders import RESNET_SPECS, import_torch, pretrained
from slowtv_monodepth_tpu_torch.models.encoders.resnet import Bottleneck, ResNetEncoder
from slowtv_monodepth_tpu_torch.models.from_jax import _resnet
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

B, H, W = 2, 64, 96
FEAT_RTOL, STATS_RTOL = 1e-5, 1e-5
GRAD64_RTOL, GRAD32_L2 = 1e-6, 2e-3
DISP_ATOL = 1e-5
CUT = (1, 1, 1, 1)
ARCHS = {'resnet18': dict(block='basic', layers=(2, 2, 2, 2)),
         'bottleneck_cut': dict(block='bottleneck', layers=CUT),
         'resnext_32x8d_cut': dict(block='bottleneck', layers=CUT, groups=32,
                                   width_per_group=8)}


def _images(seed: int, c: int = 3, b: int = B) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((b, H, W, c)).astype(np.float32)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _buffers(params: dict, stats: dict) -> dict:
    """A flax `ResNetEncoder`'s params and `batch_stats` -> {port key: running statistic}."""
    sd = _resnet(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    return {k: v.numpy() for k, v in sd.items() if k.endswith(('running_mean', 'running_var'))}


# ------------------------------------------------------------------ 1. the encoders
def seeded_encoder_weights(arch: str, in_chans: int) -> dict:
    with torch.device('meta'):
        enc = ResNetEncoder(in_chans=in_chans, **ARCHS[arch])
    return seeded_state_dict(enc, 0)


def _projections(shapes) -> list[np.ndarray]:
    rs = np.random.RandomState(7)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _proj_loss(feats_nhwc, proj) -> torch.Tensor:
    return sum((f * torch.from_numpy(p).to(f.dtype)).sum() for f, p in zip(feats_nhwc, proj))


def port_encoder_run(arch: str, in_chans: int) -> dict:
    """Eval forward, then two train-mode passes, the first with a backward of a
    random projection of every feature map; the gradient also in float64."""
    sd = seeded_encoder_weights(arch, in_chans)
    x1, x2 = (torch.from_numpy(_images(s, in_chans)).permute(0, 3, 1, 2) for s in (1, 2))
    out = {}
    for dtype in (torch.float64, torch.float32):
        enc = ResNetEncoder(in_chans=in_chans, **ARCHS[arch])
        enc.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        enc.to(dtype)
        with torch.no_grad():
            out['eval'] = [_nhwc(f) for f in enc.eval()(x1.to(dtype))]
        feats = [f.permute(0, 2, 3, 1) for f in enc.train()(x1.to(dtype))]
        out['train'] = [f.detach().numpy() for f in feats]
        _proj_loss(feats, _projections([f.shape for f in feats])).backward()
        key = 'grads64' if dtype == torch.float64 else 'grads'
        out[key] = {k: p.grad.numpy() for k, p in enc.named_parameters()}
    with torch.no_grad():
        enc(x2)
    out['stats'] = {k: v.numpy() for k, v in enc.state_dict().items()
                    if k.endswith(('running_mean', 'running_var'))}
    out['counts'] = {k: int(v) for k, v in enc.state_dict().items()
                     if k.endswith('num_batches_tracked')}
    return out


@functools.lru_cache(maxsize=None)
def jax_encoder_run(arch: str, in_chans: int) -> dict:
    """The JAX package's encoder on the same weights and images, in float64 (one jit):
    eval and train features, `batch_stats` after the two train passes, the gradient.

    flax computes a batch variance as E[x^2] - E[x]^2. In float32 that cancels where
    a channel's mean is large against its deviation (post-ReLU maps into a 1x1 conv,
    12 to 48 values a channel at strides 16 and 32): its own float32 gradient is then
    off by up to 7e-3 of a tensor's largest (the bottleneck's layer4 bn1) and its
    train-mode features by ~3e-5. In float64 the same formula is the oracle."""
    spec = ARCHS[arch]
    sd = {k: v.astype(np.float64) if v.dtype == np.float32 else v
          for k, v in seeded_encoder_weights(arch, in_chans).items()}
    enc = JaxResNet(in_chans=in_chans, **spec)
    with jax.enable_x64(True):
        params, stats = jax_convert(sd, spec['layers'], spec['block'], in_chans=in_chans)

        def run(p, st, x1, x2):
            ev = enc.apply({'params': p, 'batch_stats': st}, x1, train=False)

            def loss(p):
                feats, upd = enc.apply({'params': p, 'batch_stats': st}, x1, train=True,
                                       mutable=['batch_stats'])
                proj = _projections([f.shape for f in feats])
                return sum((f * q.astype(np.float64)).sum() for f, q in zip(feats, proj)), \
                    (feats, upd['batch_stats'])
            (_, (tr, st1)), g = jax.value_and_grad(loss, has_aux=True)(p)
            _, upd = enc.apply({'params': p, 'batch_stats': st1}, x2, train=True,
                               mutable=['batch_stats'])
            return ev, tr, upd['batch_stats'], g
        x1, x2 = (np.float64(_images(s, in_chans)) for s in (1, 2))
        ev, tr, st, g = jax.tree.map(np.asarray, jax.jit(run)(params, stats, x1, x2))
    return {'eval': ev, 'train': tr, 'stats': _buffers(params, st),
            'grads': {k: v.numpy() for k, v in _resnet(g, None).items()}}


# ResNet-18 at both widths of input (the depth net's 3 channels, the pose net's 6); the
# cut bottleneck ResNet at 3, the cut ResNeXt at 6 (the stem's adaptation is one code path).
CASES = [('resnet18', 3), ('resnet18', 6), ('bottleneck_cut', 3), ('resnext_32x8d_cut', 6)]


@pytest.fixture(scope='module', params=CASES, ids=[f'{a}-in{c}' for a, c in CASES])
def encoder_pair(request):
    return port_encoder_run(*request.param), jax_encoder_run(*request.param)


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_resnet_features_match_jax(encoder_pair, mode):
    port, want = encoder_pair
    assert len(port[mode]) == len(want[mode]) == 5
    for s, (g, w) in enumerate(zip(port[mode], want[mode])):
        assert g.dtype == np.float32 and g.shape[1:3] == (H >> (s + 1), W >> (s + 1))
        _close(g, w, FEAT_RTOL, f'stride {2 ** (s + 1)}')


def _stats_faults(got: dict, want: dict) -> list:
    assert sorted(got) == sorted(want)
    return [k for k in want
            if not np.abs(got[k] - want[k]).max() <= STATS_RTOL * np.abs(want[k]).max()]


def test_resnet_running_statistics_match_flax(encoder_pair):
    """Two train-mode passes: flax's update, once a pass, in every BatchNorm."""
    port, want = encoder_pair
    assert _stats_faults(port['stats'], want['stats']) == []
    assert set(port['counts'].values()) == {2}


def _grad_faults(got: dict, want: dict) -> list:
    assert sorted(got) == sorted(want)
    return [k for k, w in want.items()
            if not float(np.abs(got[k] - w).max()) <= GRAD64_RTOL * float(np.abs(w).max())]


def _l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def test_resnet_gradients_match_jax(encoder_pair):
    """Every parameter's gradient: the port's float64 pass tensor by tensor, its
    float32 pass as one vector (its ReLU gates may flip within rounding)."""
    port, want = encoder_pair
    assert _grad_faults(port['grads64'], want['grads']) == []
    assert _l2(port['grads'], want['grads']) <= GRAD32_L2
    assert all(np.abs(g).max() > 0 for g in port['grads'].values())


def test_gradient_check_has_teeth(monkeypatch):
    """BatchNorm that normalises by its batch statistics but passes no gradient
    through them fails."""
    want = jax_encoder_run('resnet18', 3)

    def stats_detached(self, x):
        var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
        return F.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0, self.eps)
    monkeypatch.setattr(norm.BatchNorm2d, 'forward', stats_detached)
    got = port_encoder_run('resnet18', 3)
    assert _grad_faults(got['grads64'], want['grads'])
    assert _l2(got['grads'], want['grads']) > GRAD32_L2


def test_batchnorm_update_is_flax_s():
    """One train pass of a (4, 3, 3, 2) input (NHWC) from 1.0: 0.9 + 0.1 x the biased
    variance, as flax's `nn.BatchNorm` mutates it; torch's update folds in the
    unbiased one."""
    x = np.arange(72, dtype=np.float32).reshape(4, 3, 3, 2) % 7 / 3.0
    bn = norm.BatchNorm2d(2)
    bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * x.reshape(-1, 2).var(0),
                               rtol=1e-6)
    _, upd = fnn.BatchNorm(momentum=0.9, epsilon=1e-5).apply(
        {'params': {'scale': jnp.ones(2), 'bias': jnp.zeros(2)},
         'batch_stats': {'mean': jnp.zeros(2), 'var': jnp.ones(2)}},
        jnp.asarray(x), use_running_average=False, mutable=['batch_stats'])
    np.testing.assert_allclose(bn.running_var.numpy(), upd['batch_stats']['var'], rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd['batch_stats']['mean'], rtol=1e-6)
    plain = torch.nn.BatchNorm2d(2).train()
    plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(plain.running_var.numpy(), upd['batch_stats']['var'], rtol=1e-3)


def _torch_unbiased(self, x):  # nn.BatchNorm2d's own update (momentum 0.1, n / (n - 1))
    return torch.nn.BatchNorm2d.forward(self, x)


def _momentum_read_the_torch_way(self, x):  # flax's 0.9 handed to torch: 0.1 old + 0.9 new
    self.momentum = 0.9
    return torch.nn.BatchNorm2d.forward(self, x)


@pytest.mark.parametrize('fault', [_torch_unbiased, _momentum_read_the_torch_way],
                         ids=['torch_unbiased_update', 'momentum_read_the_torch_way'])
def test_running_statistics_check_has_teeth(fault, monkeypatch):
    monkeypatch.setattr(norm.BatchNorm2d, 'forward', fault)
    assert _stats_faults(port_encoder_run('resnet18', 3)['stats'],
                         jax_encoder_run('resnet18', 3)['stats'])


def test_feature_check_has_teeth(monkeypatch):
    """A bottleneck striding its first 1x1 conv (ResNet v1's layout, not timm's) fails."""
    init = Bottleneck.__init__

    def strided_1x1(self, in_ch, planes, stride=1, *a, **kw):
        init(self, in_ch, planes, stride, *a, **kw)
        self.conv1.stride, self.conv2.stride = (stride, stride), (1, 1)
    monkeypatch.setattr(Bottleneck, '__init__', strided_1x1)
    got = port_encoder_run('bottleneck_cut', 3)
    with pytest.raises(AssertionError):
        _close(got['eval'][4], jax_encoder_run('bottleneck_cut', 3)['eval'][4], FEAT_RTOL)


# --------------------------------------------------------------- 2. pretrained graft
def timm_resnet_file(root, enc_name: str, seed: int) -> dict:
    """A seeded ResNet state dict in timm's layout (`api/data/export_timm.py`'s
    `.npz`): the encoder's parameters, running statistics (a positive variance)
    and counters at 3 input channels, and timm's classifier `fc.*`."""
    with torch.device('meta'):
        enc = ResNetEncoder(**{k: v for k, v in RESNET_SPECS[enc_name].items()
                               if k in ('block', 'layers', 'groups', 'width_per_group')})
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith('num_batches_tracked'):
            sd[k] = np.asarray(rng.integers(1, 1000), np.int64)
        elif k.endswith('running_var'):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            sd[k] = 0.02 * rng.standard_normal(v.shape, dtype=np.float32)
    sd.update({'fc.weight': 0.02 * rng.standard_normal((1000, 512), dtype=np.float32),
               'fc.bias': np.zeros(1000, np.float32)})
    (root / 'timm').mkdir(parents=True, exist_ok=True)
    np.savez(root / 'timm' / f'{enc_name}.npz', **sd)
    return sd


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    monkeypatch.setattr(jpre, 'MODEL_ROOTS', [tmp_path])
    return tmp_path


def _jax_graft(in_chans: int) -> dict:
    v = jpre.load_pretrained_encoder({'params': {}, 'batch_stats': {}}, 'resnet18', in_chans)
    sd = _resnet(jax.tree.map(np.asarray, v['params']['encoder']),
                 jax.tree.map(np.asarray, v['batch_stats']['encoder']))
    return {k: t.numpy() for k, t in sd.items() if not k.endswith('num_batches_tracked')}


def _port_graft(in_chans: int) -> dict:
    from slowtv_monodepth_tpu_torch.models import PoseNet
    net = (DepthNet if in_chans == 3 else PoseNet)(enc_name='resnet18')
    assert pretrained.load_pretrained_encoder(net, 'resnet18', in_chans)
    return {k: v.numpy() for k, v in net.encoder.state_dict().items()}


def _graft_faults(got: dict, want: dict) -> list:
    assert sorted(k for k in got if not k.endswith('num_batches_tracked')) == sorted(want)
    return [k for k in want if not (got[k].dtype == want[k].dtype
                                    and np.array_equal(got[k], want[k]))]


@pytest.mark.parametrize('in_chans', [3, 6], ids=['depth', 'pose'])
def test_resnet_graft_equals_the_jax_loader_bitwise(root, in_chans):
    """Parameters and running statistics as the JAX loader grafts them (the pose stem
    tiled and scaled by 3 / 6); the counters are the file's; `fc.*` is ignored."""
    sd = timm_resnet_file(root, 'resnet18', seed=5)
    got = _port_graft(in_chans)
    assert _graft_faults(got, _jax_graft(in_chans)) == []
    assert all(int(got[k]) == int(sd[k]) for k in got if k.endswith('num_batches_tracked'))


def test_resnet_graft_check_has_teeth(root, monkeypatch):
    """A graft that leaves the running statistics at their initial 0 / 1 fails."""
    timm_resnet_file(root, 'resnet18', seed=5)
    want = _jax_graft(3)
    convert = import_torch.convert_resnet

    def no_stats(*a, **kw):
        return {k: (np.zeros_like(v) if k.endswith('running_mean') else
                    np.ones_like(v) if k.endswith('running_var') else v)
                for k, v in convert(*a, **kw).items()}
    monkeypatch.setattr(pretrained, 'convert_resnet', no_stats)
    bad = _graft_faults(_port_graft(3), want)
    assert bad and all('running' in k for k in bad)


# ------------------------------------------------------------------ 3. the bridges
NET = {'depth': {'enc_name': 'resnet18', 'pretrained': False, 'dec_name': 'monodepth',
                 'out_scales': [0, 1]},
       'pose': {'enc_name': 'resnet18', 'pretrained': False}}
LOSS = {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True}}


@functools.lru_cache(maxsize=None)
def jax_state() -> tuple:
    """A JAX `TrainState` of ResNet-18 depth and pose nets under Adam: the seeded
    weights (running statistics drawn, not flax's 0 / 1) through the JAX package's
    checkpoint converter -> (cfg, TrainState with numpy leaves)."""
    from slowtv_monodepth_tpu import parsers as jparsers
    from slowtv_monodepth_tpu.core.trainer import TrainState
    from slowtv_monodepth_tpu_torch import parsers
    cfg = {'net': NET, 'loss': LOSS, 'optimizer': {'type': 'adam', 'lr': 1e-4}}
    with torch.device('meta'):
        nets = parsers.get_net(NET)
    weights = {f'nets.{k}.{kk}': v for k, net in nets.items()
               for kk, v in seeded_state_dict(net, 3).items()}
    params, aux = convert_reference_ckpt(weights, cfg)
    state = TrainState(step=np.int32(0), params=params, aux=aux,
                       opt_state=jparsers.make_optimizer(cfg).init(params), bad_step=np.int32(-1))
    return cfg, jax.tree.map(np.asarray, state)


def _port_net(name: str):
    from slowtv_monodepth_tpu_torch.models import PoseNet
    return (DepthNet if name == 'depth' else PoseNet)(**NET[name]).eval()


def _bridge(name: str, params: dict, batch_stats) -> dict:
    from slowtv_monodepth_tpu_torch.models import (depth_state_dict_from_jax,
                                                   pose_state_dict_from_jax)
    if name == 'depth':
        return depth_state_dict_from_jax(params, NET['depth']['out_scales'], batch_stats)
    return pose_state_dict_from_jax(params, batch_stats)


@functools.lru_cache(maxsize=None)
def jax_eval(name: str) -> tuple:
    """(images, the JAX net's eval output with the JAX state's parameters and running
    statistics): the disparity at scale 0, or the pose net's [R | t]."""
    from slowtv_monodepth_tpu.models import PoseNet as JaxPoseNet
    _, state = jax_state()
    x = _images(9, 3 if name == 'depth' else 6)
    jnet = (JaxDepthNet if name == 'depth' else JaxPoseNet)(**NET[name])
    out = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {'params': state.params[name], **state.aux[name]}, x)
    if name == 'depth':
        return x, np.asarray(out['disp'][0])
    return x, np.concatenate([out['R'], out['t']], -1)


def _eval_outputs(name: str, net) -> tuple:
    """The port net's eval output beside the JAX net's, on the same images."""
    x, want = jax_eval(name)
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    if name == 'depth':
        return _nhwc(out['disp'][0]), want
    return torch.cat([out['R'], out['t']], -1).numpy(), want


@pytest.mark.parametrize('name', ['depth', 'pose'])
def test_from_jax_carries_the_batch_stats(name):
    """The bridge's state dict (parameters and buffers) loads strictly, and the port's
    eval outputs are the JAX package's with those running statistics."""
    _, state = jax_state()
    net = _port_net(name)
    net.load_state_dict(_bridge(name, state.params[name], state.aux[name]['batch_stats']))
    got, want = _eval_outputs(name, net)
    np.testing.assert_allclose(got, want, atol=DISP_ATOL if name == 'depth' else 1e-6)


def test_from_jax_check_has_teeth():
    """The parameters without the running statistics (the buffers left at 0 / 1) fail."""
    _, state = jax_state()
    net = _port_net('depth')
    missing, _ = net.load_state_dict(_bridge('depth', state.params['depth'], None), strict=False)
    assert missing and all(k.endswith(('running_mean', 'running_var', 'num_batches_tracked'))
                           for k in missing)
    got, want = _eval_outputs('depth', net)
    assert not np.allclose(got, want, atol=DISP_ATOL)


def _carried_buffers(aux_of_state) -> list:
    """`train_state_from_jax` into fresh port nets -> the buffers that differ from the
    JAX state's running statistics."""
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.core.checkpoint import train_state_from_jax
    cfg, state = jax_state()
    nets = torch.nn.ModuleDict({k: _port_net(k) for k in NET})
    opt = parsers.make_optimizer(cfg, nets)
    assert train_state_from_jax(state.replace(aux=aux_of_state), nets, opt,
                                NET['depth']['out_scales']) == 0
    bad = []
    for name, net in nets.items():
        want = _bridge(name, state.params[name], state.aux[name]['batch_stats'])
        bad += [f'{name}.{k}' for k, b in net.named_buffers() if not torch.equal(b, want[k])]
    return bad


def test_train_state_from_jax_carries_aux():
    _, state = jax_state()
    assert _carried_buffers(state.aux) == []


def test_train_state_check_has_teeth():
    """A state carried without its `aux` (the buffers left as initialised) fails."""
    bad = _carried_buffers({k: {} for k in NET})
    assert bad and all(k.endswith(('running_mean', 'running_var')) for k in bad)


# ------------------------------------------------------------------ 4. serving
SERVED = ['resnet18', 'ssl_resnext101_32x8d']


@pytest.fixture(scope='module', params=SERVED)
def served(request, tmp_path_factory) -> dict:
    """A reference-layout checkpoint of seeded depth weights (buffers included) ->
    the port's `BenchmarkPredictor` (the net as it loads, in eval mode, and again in
    train mode) and the JAX package's predictor on the same file. The ResNeXt keeps
    its published widths and groups, cut to one block a stage on both sides."""
    from slowtv_monodepth_tpu.core.predictors import BenchmarkPredictor as JaxPredictor
    from slowtv_monodepth_tpu.core.predictors import arg_jitted_forward
    from test_torch_predictors import _Loader
    enc_name = request.param
    with pytest.MonkeyPatch.context() as mp:
        if enc_name.endswith('resnext101_32x8d'):
            for specs in (RESNET_SPECS, JAX_RESNET_SPECS):
                mp.setitem(specs, enc_name, dict(specs[enc_name], layers=CUT))
        cfg = {'net': {'depth': {'enc_name': enc_name, 'pretrained': True,
                                 'dec_name': 'monodepth', 'out_scales': [0, 1, 2, 3]}},
               'trainer': {'min_depth': 0.1, 'max_depth': 100}}
        with torch.device('meta'):
            meta = DepthNet(**cfg['net']['depth'])
        sd = seeded_state_dict(meta, 4)
        path = tmp_path_factory.mktemp('served') / 'ref.ckpt'
        save_checkpoint(path, {'depth': {k: torch.from_numpy(v) for k, v in sd.items()}}, cfg)
        dl = _Loader(_images(10, b=3), b=3)
        port = BenchmarkPredictor('cpu')
        net = port.load_model(path)
        out = {'eval_mode': not net.training, 'got': port(net, dl),
               'got_train_mode': port(net.train(), dl)}
        sd_np, jcfg = load_reference_ckpt(path)
        params, aux = convert_reference_ckpt(sd_np, jcfg)
        jax_pred = JaxPredictor()
        jax_pred.min_depth, jax_pred.max_depth = 0.1, 100
        fwd = arg_jitted_forward(JaxDepthNet(**jcfg['net']['depth']),
                                 {'params': params['depth'], **aux['depth']})
        out['want'] = jax_pred(fwd, dl)
    shutil.rmtree(path.parent)  # both predictors have read it
    return out


def test_a_reference_checkpoint_with_buffers_serves_as_jax(served):
    assert served['eval_mode']
    assert served['got'].shape == served['want'].shape == (3, H, W)
    np.testing.assert_allclose(served['got'], served['want'], atol=DISP_ATOL)


def test_serving_check_has_teeth(served):
    """The net served in train mode (batch statistics, not the checkpoint's) fails."""
    assert not np.allclose(served['got_train_mode'], served['want'], atol=DISP_ATOL)
