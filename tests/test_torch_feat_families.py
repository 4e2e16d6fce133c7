"""Port differentials for Depth-VO-Feat's and FeatDepth's modules: the image
autoencoder and its weight bridge, feature reconstruction, the autoencoder's image
reconstruction, feature peakiness and smoothness, the trainer's automask noises and the
depth encoder's support pass.

Same numpy inputs (seeded) through the JAX package and the port, the port in float32 on
the CPU (its kernels' plain versions). The JAX package runs its XLA paths, as its own
tests run them on the CPU. Where BatchNorm is in the chain (the ResNet-18 autoencoder
and pose net) the JAX side runs in float64 (`jax.enable_x64`), as
`tests/test_torch_resnet.py` does: flax's float32 batch variance is E[x^2] - E[x]^2,
itself ~1e-2 off at strides 16-32.

- `AutoencoderNet` (ResNet-18, 4 scales, as FeatDepth publishes it) on (2, 64, 96)
  images: features and images in eval and train mode, the running statistics after
  two train-mode passes;
- the weight bridge: JAX params -> `autoencoder_state_dict_from_jax` -> a port-written
  `nets.autoencoder.*` checkpoint -> the JAX package's `convert_reference_ckpt` gives
  back the same params and `batch_stats`; `train_state_from_jax` fills the port's
  autoencoder;
- `FeatPeakReg` and `FeatSmoothReg` with and without edges, on features with ReLU
  zeros: values and gradients w.r.t. the features and the image;
- the handlers `feat_recon` (stride-4 features of a pyramid, l1 and l2 with the
  automask: the features get no gradient, the depths do, and the warp makes no image
  cotangent), `autoenc_recon` and `feat_smooth`;
- the trainer's two automask noises: handed over as a dict, each reaches its own
  loss; drawn from a generator, each is drawn apart (the cfgs' steps against the JAX
  package's: `tests/test_torch_feat_families_steps.py`);
- a ResNet-18 depth net with `feat_recon`: the depth encoder's support pass leaves
  the running statistics and counters as the target pass left them.

Tolerances:
- the autoencoder's maps 1e-5 of each map's largest magnitude in eval mode, 5e-5 in
  train mode (measured up to 1.2e-5 at stride 32, where BatchNorm normalises 12 values
  a channel: the float32 rounding of the mean and variance is amplified), running
  statistics 1e-5 of each tensor's largest value (`tests/test_torch_resnet.py`'s);
- the bridge: bitwise;
- regularizers and handlers: values rtol 1e-5, gradients 1e-4 of the largest JAX
  magnitude (`tests/test_torch_families.py`'s, float32 on both sides: no BatchNorm);
- the running statistics after the depth encoder's support pass: bitwise those of the
  target pass alone.
Every tolerance has a fault that fails it.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu import losses as jlosses
from slowtv_monodepth_tpu import ops as jops
from slowtv_monodepth_tpu.core import handlers as jh
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.core.trainer import TrainState
from slowtv_monodepth_tpu.models.autoencoder import AutoencoderNet as JaxAutoencoderNet
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch import losses as tlosses
from slowtv_monodepth_tpu_torch import ops as tops
from slowtv_monodepth_tpu_torch import parsers
from slowtv_monodepth_tpu_torch.config import load_merge_yaml
from slowtv_monodepth_tpu_torch.core import handlers as th
from slowtv_monodepth_tpu_torch.core import load_checkpoint, save_checkpoint
from slowtv_monodepth_tpu_torch.core.checkpoint import train_state_from_jax
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.losses import regularizers as tregs
from slowtv_monodepth_tpu_torch.models import (AutoencoderNet, autoencoder_state_dict_from_jax,
                                               norm, seeded_state_dict)
from test_torch_families import (_K, _assert_same, _close, _grads, _images, _poses, _scales, _t,
                                 make_batch, port_trainer, seeded_weights, supp_of)
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

CFG = Path(__file__).resolve().parents[1] / 'cfg'
B, H, W = 2, 64, 96
MAP_RTOL, STATS_RTOL = {'eval': 1e-5, 'train': 5e-5}, 1e-5
LOSS_RTOL = 1e-5
ACCUMULATE = 2
AE_CFG = {'enc_name': 'resnet18', 'pretrained': False, 'dec_name': 'monodepth',
          'out_scales': [0, 1, 2, 3]}


def _x64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel_faults(got: dict, want: dict, rtol: float) -> list:
    assert sorted(got) == sorted(want) and want
    return [k for k, w in want.items()
            if not np.abs(got[k] - w).max() <= rtol * np.abs(w).max()]


# -------------------------------------------------------------- 1. the autoencoder
def ae_weights() -> dict:
    with torch.device('meta'):
        net = AutoencoderNet(**AE_CFG)
    return seeded_state_dict(net, 0)


def _ae_images(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((B, H, W, 3)).astype(np.float32)


def port_autoencoder_run(train_mode: bool = True) -> dict:
    """Eval forward, then two passes in the training mode (train mode unless a fault
    asks otherwise): features, images, running statistics and counters."""
    net = AutoencoderNet(**AE_CFG)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in ae_weights().items()})
    x1, x2 = (torch.from_numpy(_ae_images(s)).permute(0, 3, 1, 2) for s in (1, 2))
    out = {}
    with torch.no_grad():
        for mode, x in (('eval', x1), ('train', x1), (None, x2)):
            net.train(train_mode and mode != 'eval')
            o = net(x)
            if mode:
                out[mode] = {'feats': [_nhwc(f) for f in o['autoenc_feats']],
                             'imgs': {s: _nhwc(v) for s, v in o['autoenc_imgs'].items()}}
    sd = net.state_dict()
    out['stats'] = {k: v.numpy() for k, v in sd.items() if 'running' in k}
    out['counts'] = {int(v) for k, v in sd.items() if k.endswith('num_batches_tracked')}
    return out


def _jax_stats(params: dict, aux: dict) -> dict:
    sd = autoencoder_state_dict_from_jax(jax.tree.map(np.asarray, params), AE_CFG['out_scales'],
                                         jax.tree.map(np.asarray, aux['batch_stats']))
    return {k: v.numpy() for k, v in sd.items() if 'running' in k}


@functools.lru_cache(maxsize=None)
def jax_autoencoder_run() -> dict:
    """The JAX package's autoencoder on the same weights and images, in float64."""
    net = JaxAutoencoderNet(enc_name='resnet18', pretrained=False, out_scales=(0, 1, 2, 3))
    cfg = {'net': {'autoencoder': AE_CFG}}
    with jax.enable_x64(True):
        params, aux = convert_reference_ckpt(
            _x64({f'nets.autoencoder.{k}': v for k, v in ae_weights().items()}), cfg)
        params, st = params['autoencoder'], aux['autoencoder']['batch_stats']

        def run(p, st, x1, x2):
            ev = net.apply({'params': p, 'batch_stats': st}, x1, train=False)
            tr, upd = net.apply({'params': p, 'batch_stats': st}, x1, train=True,
                                mutable=['batch_stats'])
            _, upd = net.apply({'params': p, 'batch_stats': upd['batch_stats']}, x2, train=True,
                               mutable=['batch_stats'])
            return ev, tr, upd
        x1, x2 = (np.float64(_ae_images(s)) for s in (1, 2))
        ev, tr, upd = jax.tree.map(np.asarray, jax.jit(run)(params, st, x1, x2))
    return {'eval': {'feats': ev['autoenc_feats'], 'imgs': ev['autoenc_imgs']},
            'train': {'feats': tr['autoenc_feats'], 'imgs': tr['autoenc_imgs']},
            'stats': _jax_stats(params, upd)}


def _map_faults(got: dict, want: dict, rtol: float) -> list:
    bad = []
    pairs = [(f'feat {i}', g, w) for i, (g, w) in enumerate(zip(got['feats'], want['feats']))]
    pairs += [(f'img {s}', got['imgs'][s], want['imgs'][s]) for s in want['imgs']]
    assert len(got['feats']) == len(want['feats']) == 5 and sorted(got['imgs']) == [0, 1, 2, 3]
    for what, g, w in pairs:
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if not np.abs(g - w).max() <= rtol * np.abs(w).max():
            bad.append(what)
    return bad


@pytest.fixture(scope='module')
def autoencoder_pair():
    return port_autoencoder_run(), jax_autoencoder_run()


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_autoencoder_matches_jax(autoencoder_pair, mode):
    port, want = autoencoder_pair
    assert _map_faults(port[mode], want[mode], MAP_RTOL[mode]) == []
    assert port[mode]['imgs'][0].shape == (B, H, W, 3)
    assert all(0 < v.min() and v.max() < 1 for v in port[mode]['imgs'].values())  # sigmoid


def test_autoencoder_running_statistics_match_flax(autoencoder_pair):
    """Two train-mode passes, the second on the first's update, as the trainer's
    target and support passes."""
    port, want = autoencoder_pair
    assert _rel_faults(port['stats'], want['stats'], STATS_RTOL) == []
    assert port['counts'] == {2}


def test_autoencoder_checks_have_teeth(monkeypatch):
    """The decoder's output stage without its sigmoid fails the maps; BatchNorm on its
    running statistics in train mode fails the train-mode maps and the statistics."""
    want = jax_autoencoder_run()
    eval_mode = port_autoencoder_run(train_mode=False)
    assert _rel_faults(eval_mode['stats'], want['stats'], STATS_RTOL)
    from slowtv_monodepth_tpu_torch.models.decoders import monodepth
    monkeypatch.setitem(monodepth.ACT, 'sigmoid', lambda x: x)
    assert _map_faults(port_autoencoder_run()['eval'], want['eval'], MAP_RTOL['eval'])
    monkeypatch.undo()
    monkeypatch.setattr(norm.BatchNorm2d, 'forward', lambda self, x: F.batch_norm(
        x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps))
    assert _map_faults(port_autoencoder_run()['train'], want['train'], MAP_RTOL['train'])


# --------------------------------------------------------------- 2. the weight bridge
@functools.lru_cache(maxsize=None)
def _jax_autoencoder_state() -> tuple:
    """flax's own initial params of the JAX autoencoder and running statistics moved off
    0 / 1 by one train-mode pass."""
    net = JaxAutoencoderNet(enc_name='resnet18', pretrained=False, out_scales=(0, 1, 2, 3))
    x = jnp.asarray(_ae_images(3))
    variables = jax.jit(lambda k, x: net.init(k, x, train=False))(jax.random.PRNGKey(4), x)
    _, upd = jax.jit(lambda v, x: net.apply(v, x, train=True, mutable=['batch_stats']))(
        variables, x)
    return (jax.tree.map(np.asarray, variables['params']),
            jax.tree.map(np.asarray, upd['batch_stats']))


def _bridge_faults(tmp_path, fault=None) -> list:
    params, stats = _jax_autoencoder_state()
    sd = autoencoder_state_dict_from_jax(params, AE_CFG['out_scales'], stats)
    if fault == 'stats_swapped':  # two BatchNorms of one block
        for k in ('running_mean', 'running_var'):
            a, b = f'encoder.layer1.0.bn1.{k}', f'encoder.layer1.0.bn2.{k}'
            sd[a], sd[b] = sd[b], sd[a]
    net = AutoencoderNet(**AE_CFG)
    net.load_state_dict(sd)  # strict: the port's keys and shapes
    save_checkpoint(tmp_path / 'ae.ckpt', {'autoencoder': net.state_dict()},
                    {'net': {'autoencoder': AE_CFG}})
    written, cfg = load_checkpoint(tmp_path / 'ae.ckpt')
    back, aux = convert_reference_ckpt({k: v.numpy() for k, v in written.items()}, cfg)
    back = jax.tree.map(np.asarray, back['autoencoder'])
    back_stats = jax.tree.map(np.asarray, aux['autoencoder']['batch_stats'])
    bad = []
    for tree, want in ((back, params), (back_stats, stats)):
        got_l, want_l = jax.tree_util.tree_leaves_with_path(tree), \
            jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        bad += [str(p) for (p, g), (_, w) in zip(got_l, want_l) if not np.array_equal(g, w)]
    return bad


def test_the_autoencoder_bridge_round_trips_bitwise(tmp_path):
    assert _bridge_faults(tmp_path) == []


def test_the_bridge_check_has_teeth(tmp_path):
    """The running statistics of two BatchNorms of a block swapped fail."""
    assert _bridge_faults(tmp_path, 'stats_swapped')


def test_train_state_from_jax_fills_the_autoencoder():
    """A JAX TrainState with an autoencoder (params and `batch_stats`) carried into the
    port's nets: every tensor equal to the bridge's."""
    import optax
    params, stats = _jax_autoencoder_state()
    tx = optax.adam(1e-4)
    state = TrainState(step=np.asarray(3), params={'autoencoder': params},
                       aux={'autoencoder': {'batch_stats': stats}},
                       opt_state=jax.tree.map(np.asarray, tx.init({'autoencoder': params})),
                       bad_step=None)
    nets = torch.nn.ModuleDict({'autoencoder': AutoencoderNet(**AE_CFG)})
    opt = parsers.make_optimizer({'optimizer': {'type': 'adam', 'lr': 1e-4}}, nets, 1)
    assert train_state_from_jax(state, nets, opt) == 3
    want = autoencoder_state_dict_from_jax(params, AE_CFG['out_scales'], stats)
    got = nets['autoencoder'].state_dict()
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


# ------------------------------------------------------------- 3. the regularizers
def _feat_inputs(rng, c=8, h=16, w=24):
    """Features with ReLU zeros (ties at 0 in their differences) and an image."""
    feat = np.maximum(rng.standard_normal((B, h, w, c)), 0).astype(np.float32)
    return feat, _images(rng, h=h, w=w)


REGS = {'peaky': ('FeatPeakReg', False), 'peaky_edges': ('FeatPeakReg', True),
        'smooth': ('FeatSmoothReg', False), 'smooth_edges': ('FeatSmoothReg', True)}


def _reg_run(case: str, fault=None):
    name, edges = REGS[case]
    rng = np.random.default_rng(30)
    jcrit, tcrit = getattr(jlosses, name)(edges), getattr(tlosses, name)(edges)
    sign = -1.0 if fault == 'sign_flipped' else 1.0
    with pytest.MonkeyPatch.context() as mp:
        if fault == 'no_cross_terms':  # dxy, dyx replaced by dxx, dyy
            lap = tregs.compute_laplacian
            mp.setattr(tregs, 'compute_laplacian', lambda x, **kw: (
                lambda d: (d[0], d[1], d[0], d[1]))(lap(x, **kw)))
        feat, img = _feat_inputs(rng)
        if edges:  # the image's gradient too
            return _grads(lambda f, i: jcrit(f, i)[0], lambda f, i: sign * tcrit(f, i)[0],
                          feat, img)
        return _grads(lambda f: jcrit(f, jnp.asarray(img))[0],
                      lambda f: sign * tcrit(f, _t(img))[0], feat)


@pytest.mark.parametrize('case', list(REGS))
def test_feature_regularizers_match_jax(case):
    jv, jg, tv, tg = _reg_run(case)
    _assert_same(jv, jg, tv, tg)
    assert all(np.abs(g).max() > 0 for g in tg)


@pytest.mark.parametrize('case,fault', [('peaky', 'sign_flipped'),
                                        ('smooth_edges', 'no_cross_terms')])
def test_feature_regularizer_check_has_teeth(case, fault):
    with pytest.raises(AssertionError):
        _assert_same(*_reg_run(case, fault))


# ------------------------------------------------------------------ 4. the handlers
def _pyramid(rng, c0, lead=(B,), h=H, w=W):
    """Encoder features at strides 2-32 (a ResNet's five); stride 4 is `[-4]`."""
    return [np.maximum(rng.standard_normal(lead + (h >> s, w >> s, c0 * 2 ** (s - 1))), 0)
            .astype(np.float32) for s in range(1, 6)]


def _feat_recon_inputs(seed: int, n=2):
    rng = np.random.default_rng(seed)
    depths = _scales(rng, 1, 10)
    feats, supp_feats = _pyramid(rng, 4), _pyramid(rng, 4, (n, B))
    aa, t = _poses(rng, n)
    return depths, feats, supp_feats, aa, t


FEAT_RECON = {'l1': dict(loss_name='l1'),
              'l2_min_automask': dict(loss_name='l2', use_min=True, use_automask=True)}


def _feat_recon_run(case: str, fault=None):
    """Gradients w.r.t. the depths and both feature pyramids; the port's feature
    leaves must get none (`.grad` None), the JAX package's are zeros."""
    kw = FEAT_RECON[case]
    depths, feats, supp_feats, aa, t = _feat_recon_inputs(31)
    key = jax.random.PRNGKey(32)
    noise = np.asarray(jax.random.normal(key, (B, H, W, 1)))
    Ts_j, Ts_t = jops.T_from_AAt(aa, t), tops.T_from_AAt(_t(aa), _t(t))
    jfn = lambda d, f, sf: jh.feat_recon(  # noqa: E731
        jlosses.ReconstructionLoss(**kw), d, None, f, sf, Ts_j, jnp.asarray(_K()), rng=key)[0]
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2)))(
        *jax.tree.map(jnp.asarray, (depths, feats, supp_feats)))
    td, tf, tsf = jax.tree.map(lambda a: _t(a).requires_grad_(), (depths, feats, supp_feats))
    with pytest.MonkeyPatch.context() as mp:
        if fault == 'nearest':
            resize = th.resize_like
            mp.setattr(th, 'resize_like', lambda a, b, method='bilinear': resize(a, b, 'nearest'))
        tv, ld = th.feat_recon(tlosses.ReconstructionLoss(**kw), td, tf, tsf, Ts_t, _t(_K()),
                               noise=_t(noise))
        tv.backward()
    return (float(jv), jax.tree.map(np.asarray, jg), tv.item(),
            ({s: None if d.grad is None else d.grad.numpy() for s, d in td.items()},
             [f.grad for f in tf],
             [f.grad for f in tsf]), ld)


@pytest.mark.parametrize('case', list(FEAT_RECON))
def test_feat_recon_matches_jax(case, monkeypatch):
    """`feats[-4]` (stride 4, C = 8) resized to scale 0 and warped by its depth only.
    The features get no gradient, the depth does, and the warp's backward makes no
    4-corner scatter-add (its image cotangent)."""
    calls = []
    index_add = torch.Tensor.index_add_
    monkeypatch.setattr(torch.Tensor, 'index_add_',
                        lambda self, *a, **kw: calls.append(1) or index_add(self, *a, **kw))
    jv, (jd, jf, jsf), tv, (td, tf, tsf), ld = _feat_recon_run(case)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL)
    assert sorted(td) == sorted(jd) == [0, 1]
    _close(td[0], jd[0], what='depth 0')
    assert np.abs(td[0]).max() > 0 and td[1] is None and not np.abs(jd[1]).any()
    assert all(g is None for g in tf + tsf) and calls == []
    assert not any(np.abs(np.asarray(g)).any() for g in jf + jsf)
    assert list(ld) == ['supp_feats_warp'] and ld['supp_feats_warp'].shape == (2, B, H, W, 8)


def test_feat_recon_check_has_teeth():
    """Features resized by nearest neighbours (not bilinearly) fail."""
    jv, _, tv, _, _ = _feat_recon_run('l1', 'nearest')
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL)


def _autoenc_inputs(seed: int, n=3, n_sc=4):
    rng = np.random.default_rng(seed)
    preds = {s: rng.random((B, H, W, 3), dtype=np.float32) for s in range(n_sc)}
    supp_preds = {s: rng.random((n, B, H, W, 3), dtype=np.float32) for s in range(n_sc)}
    imgs = _images(rng)
    supp = np.stack([np.roll(imgs, 3 * (i + 1), axis=2) for i in range(n)])
    return preds, supp_preds, imgs, supp


def _autoenc_run(fault=None):
    preds, supp_preds, imgs, supp = _autoenc_inputs(33)
    tsupp = _t(supp).flip(0) if fault == 'supports_reversed' else _t(supp)
    return _grads(
        lambda p, sp: jh.autoenc_recon(jlosses.ReconstructionLoss(), p, jnp.asarray(imgs), sp,
                                       jnp.asarray(supp))[0],
        lambda p, sp: th.autoenc_recon(tlosses.ReconstructionLoss(), p, _t(imgs), sp, tsupp)[0],
        preds, supp_preds)


def test_autoenc_recon_matches_jax():
    """SSIM + L1 of every scale's target and support images at once (4 x (2 + 3 x 2))."""
    _assert_same(*_autoenc_run())


def test_autoenc_recon_check_has_teeth():
    with pytest.raises(AssertionError):
        _assert_same(*_autoenc_run('supports_reversed'))


def _feat_smooth_run(name: str, fault=None):
    rng = np.random.default_rng(34)
    feats, supp_feats = _pyramid(rng, 4), _pyramid(rng, 4, (3, B))
    imgs = _images(rng)
    supp = np.stack([np.roll(imgs, 3 * (i + 1), axis=2) for i in range(3)])
    jcrit, tcrit = getattr(jlosses, name)(True), getattr(tlosses, name)(True)
    tsupp = _t(supp) if fault is None else _t(np.ascontiguousarray(supp[::-1]))
    return _grads(
        lambda f, sf: jh.feat_smooth(jcrit, f, jnp.asarray(imgs), sf, jnp.asarray(supp))[0],
        lambda f, sf: th.feat_smooth(tcrit, f, _t(imgs), sf, tsupp)[0], feats, supp_feats)


@pytest.mark.parametrize('name', ['FeatPeakReg', 'FeatSmoothReg'])
def test_feat_smooth_matches_jax(name):
    """Each of the five stages against the images resized to it, weighted by 1 / 2**s,
    for the targets and (added) the supports."""
    _assert_same(*_feat_smooth_run(name))


def test_feat_smooth_check_has_teeth():
    """The supports' features against the images of another support fail."""
    with pytest.raises(AssertionError):
        _assert_same(*_feat_smooth_run('FeatPeakReg', 'supports_reversed'))


# ------------------------------------------ 5. the cfgs at test size: the noises
def feat_cfg(name: str) -> dict:
    """`cfg/benchmark/default.yaml` + `<name>.yaml` as they stand, cut to test size: a
    convnext_atto depth net with 2 scales, no pretrained files, 2 micro-steps an
    update. The ResNet-18 pose net and autoencoder stay as published."""
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / f'{name}.yaml')
    cfg['net']['depth'].update(enc_name='convnext_atto', pretrained=False, out_scales=[0, 1])
    cfg['net']['pose']['pretrained'] = False
    if cfg['net'].get('autoencoder'):
        cfg['net']['autoencoder']['pretrained'] = False
        assert cfg['net']['autoencoder']['enc_name'] == 'resnet18'
    assert cfg['net']['pose']['enc_name'] == 'resnet18'
    cfg['trainer']['accumulate_grad_batches'] = ACCUMULATE
    return cfg


def key(i: int):
    return jax.random.PRNGKey(2000 + i)


def batch(cfg: dict, i: int) -> tuple[dict, dict]:
    return make_batch(supp_of(cfg), hints=False, seed=200 + i)


def noise(cfg: dict, i: int, jt=None):
    """Micro-step i's automask noises, as `JaxTrainer.forward_loss` draws them in
    float64: one key per loss from the loss key (`loss_fn` splits the step key first);
    `img_recon`'s over its n_scales x B stack, `feat_recon`'s over B at scale 0."""
    losses = list((jt or JaxTrainer(cfg)).losses)
    n_sc = len(cfg['net']['depth']['out_scales'])
    shapes = {'img_recon': (n_sc * B, H, W, 1), 'feat_recon': (B, H, W, 1)}
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.split(key(i))[1], len(losses))
        out = {k: torch.from_numpy(np.asarray(jax.random.normal(keys[losses.index(k)], s,
                                                               jnp.float64), np.float32))
               for k, s in shapes.items() if cfg['loss'][k].get('use_automask')}
    return out or None


class _Recording(tlosses.ReconstructionLoss):
    """The port's reconstruction loss, keeping the noise and generator it was given."""

    def __call__(self, *a, generator=None, noise=None, **kw):
        self.seen = (generator, noise)
        return super().__call__(*a, generator=generator, noise=noise, **kw)


def _noises_seen(given: str, swapped: bool = False) -> tuple:
    """FeatDepth's loss at test size with the automask noises `given` as a dict or drawn
    from a generator -> ({loss: (generator, noise)} as each reconstruction loss saw them,
    the noises given, the generator)."""
    cfg = feat_cfg('feat_depth')
    trainer = port_trainer(cfg, seeded_weights(cfg))
    for k in ('img_recon', 'feat_recon'):
        c = trainer.losses[k]
        trainer.losses[k] = _Recording(c.loss_name, c.use_min, c.use_automask, c.mask_name)
    x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, 0))
    gen = torch.Generator().manual_seed(0) if given == 'generator' else None
    nz = noise(cfg, 0) if given == 'dict' else None
    with pytest.MonkeyPatch.context() as mp:
        if swapped:  # `feat_recon` handed `img_recon`'s noise
            feat_recon = th.feat_recon
            mp.setattr(th, 'feat_recon', lambda *a, noise=None, **kw: feat_recon(
                *a, noise=nz['img_recon'][:B], **kw))
        with torch.no_grad():
            trainer.loss_fn(x, y, supp_of(cfg), generator=gen, noise=nz)
    return {k: trainer.losses[k].seen for k in ('img_recon', 'feat_recon')}, nz, gen


def _noise_faults(given: str, swapped: bool = False) -> list:
    seen, nz, gen = _noises_seen(given, swapped)
    if given == 'dict':
        return [k for k in seen if seen[k][1] is not nz[k]]
    img, feat = seen['img_recon'], seen['feat_recon']
    return [k for k, ok in (('img_recon', img[1] is not None and img[1].shape == (2 * B, H, W, 1)),
                            ('feat_recon', feat[0] is gen and feat[1] is None)) if not ok]


@pytest.mark.parametrize('given', ['dict', 'generator'])
def test_each_automask_takes_its_own_noise(given):
    """Handed over, each loss's noise reaches its own loss (the tests hand JAX's draws
    from each loss's key, `noise`); from a generator, the trainer draws `img_recon`'s
    over its n_scales x B stack and `feat_recon`'s loss draws its own over B."""
    assert _noise_faults(given) == []


def test_the_noise_check_has_teeth():
    assert _noise_faults('dict', swapped=True) == ['feat_recon']


# --------------------------------------- 6. the depth encoder's support pass and its statistics
def _resnet_depth_step(restore: bool = True) -> tuple:
    """Depth-VO-Feat with a ResNet-18 depth net: the buffers after one micro-step's
    forward and loss, and those after a train-mode pass of the targets alone."""
    cfg = feat_cfg('depth_vo_feat')
    cfg['net']['depth'].update(enc_name='resnet18')
    trainer = port_trainer(cfg, seeded_weights(cfg))
    alone = port_trainer(cfg, seeded_weights(cfg)).nets['depth'].train()
    x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, 0))
    with pytest.MonkeyPatch.context() as mp:
        if not restore:  # the plain port: the support pass folds in its update, as torch does
            def folded(self, fwd, x):
                n, b = x['supp_imgs'].shape[:2]
                with torch.no_grad():
                    supp = self.nets['depth'].encoder(
                        x['supp_imgs'].flatten(0, 1).permute(0, 3, 1, 2).contiguous())
                return ([f.permute(0, 2, 3, 1) for f in fwd['depth_feats']],
                        [f.permute(0, 2, 3, 1).unflatten(0, (n, b)) for f in supp])
            mp.setattr(MonoDepthTrainer, 'extract_features', folded)
        trainer.nets.train()
        trainer.loss_fn(x, y, supp_of(cfg))[0].backward()
    with torch.no_grad():
        alone(x['imgs'].permute(0, 3, 1, 2))
    return ({k: v.clone() for k, v in trainer.nets['depth'].named_buffers()},
            dict(alone.named_buffers()))


def test_the_depth_encoder_support_pass_leaves_the_statistics():
    got, want = _resnet_depth_step()
    assert sorted(got) == sorted(want) and any('running_var' in k for k in got)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    assert {int(v) for k, v in got.items() if k.endswith('num_batches_tracked')} == {1}


def test_the_statistics_check_has_teeth():
    got, want = _resnet_depth_step(restore=False)
    assert [k for k in want if not torch.equal(got[k], want[k])]


# ------------------------------------------------------------------ 7. the image logger
class _Writer:
    def __init__(self):
        self.scalars, self.images = [], {}

    def add_scalar(self, tag, val, step):
        self.scalars.append((tag, val, step))

    def add_images(self, tag, imgs, global_step):
        self.images[tag] = np.asarray(imgs)

    def add_text(self, *a, **kw):
        pass


def test_image_logger_panels_match_jax():
    """The autoencoder's images and the warped features: the JAX logger's tags and grids
    on the same host arrays."""
    from slowtv_monodepth_tpu.core.heavy_logger import HeavyLogger as JaxLogger
    from slowtv_monodepth_tpu_torch.core.heavy_logger import HeavyLogger
    rng = np.random.default_rng(40)
    fwd = {'autoenc_imgs': {0: rng.random((B, 16, 24, 3), dtype=np.float32),
                            1: rng.random((B, 8, 12, 3), dtype=np.float32)}}
    ld = {'supp_feats_warp': rng.random((2, B, 16, 24, 8), dtype=np.float32)}
    out = []
    for cls in (HeavyLogger, JaxLogger):
        logger, w = cls(2, 2), _Writer()
        logger.writer, logger.mode = w, 'train'
        logger.log_fwd(fwd, (-1, 1))
        logger.log_loss(ld, (-1, 1))
        out.append(w.images)
    assert sorted(out[0]) == sorted(out[1]) == ['train_loss/feat_warp', 'train_pred/autoenc']
    for k in out[1]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


# --------------------------------------------------------------- 8. FeatDepth's training run
def test_feat_depth_trains_resumes_and_serves_on_the_cpu(tmp_path, monkeypatch, caplog):
    """`default.yaml` + `feat_depth.yaml` through `MonoDepthLoop` (what `slowtv-train-torch`
    runs), cut to test size: a convnext_atto depth net, the ResNet-18 pose net and
    autoencoder as published (pretrained, no files: the warnings), a synthetic KITTI
    pack at 64x192, 4 items, batch 2, the image logger. One epoch of 2 micro-steps:
    `last.ckpt` holds every tensor of the autoencoder, its BatchNorm buffers those of
    the trainer with the counters at 2 a micro-step. The run resumes from it for a
    second epoch, and `BenchmarkPredictor` serves its depth net (it reads
    `nets.depth.*` only) as the trainer's eval forward."""
    import logging
    import random

    from slowtv_monodepth_tpu_torch import paths
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor, HeavyLogger, MonoDepthLoop
    from test_torch_families import _write_dvso_pack
    random.seed(0)
    np.random.seed(0)
    pack = tmp_path / 'kitti_raw_sync_lmdb'
    _write_dvso_pack(pack)
    monkeypatch.setitem(paths.DATA_PATHS, 'kitti_raw_lmdb', pack)
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path / 'models'])
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / 'feat_depth.yaml')
    cfg['net']['depth'].update(enc_name='convnext_atto')
    cfg['dataset']['kitti_lmdb'].update(split='tiny', shape=[64, 192], max_len=4)
    cfg['loader'].update(batch_size=2, train={'num_workers': 0, 'shuffle': True},
                         val={'num_workers': 0, 'shuffle': False})
    cfg['trainer'].update(max_epochs=1, log_every_n_steps=1, limit_val_batches=1,
                          matmul='highest')
    run, writer = tmp_path / 'run', _Writer()
    with caplog.at_level(logging.WARNING):
        loop = MonoDepthLoop(cfg, run, device='cpu', writer=writer, heavy_logger=HeavyLogger(2, 2))
    assert 'No pretrained weights for "resnet18"' in caplog.text
    loop.fit()
    assert loop.global_step == 2 and list(loop.trainer.nets) == ['depth', 'pose', 'autoencoder']
    logged = {tag for tag, _, _ in writer.scalars}
    assert {f'train_losses/{k}' for k in ('feat_recon', 'autoenc_recon', 'feat_peaky',
                                          'feat_smooth')} <= logged, logged
    assert all(np.isfinite(v) for _, v, _ in writer.scalars)
    assert {'train_pred/autoenc', 'train_loss/feat_warp'} <= set(writer.images)

    sd, _ = load_checkpoint(run / 'last.ckpt')
    live = loop.trainer.nets['autoencoder'].state_dict()
    pre = 'nets.autoencoder.'
    ae = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    assert sorted(ae) == sorted(live) and any(k.startswith('decoder.decoder.') for k in ae)
    assert [k for k in live if not torch.equal(ae[k], live[k])] == []
    assert {int(v) for k, v in ae.items() if k.endswith('num_batches_tracked')} == {4}

    (run / 'finished').unlink()
    cfg['trainer']['max_epochs'] = 2
    loop = MonoDepthLoop(cfg, run, device='cpu')
    loop.fit()
    assert loop.start_epoch == 1 and loop.global_step == 4
    counts = {int(b) for k, b in loop.trainer.nets['autoencoder'].named_buffers()
              if k.endswith('num_batches_tracked')}
    assert counts == {8}  # the checkpoint's 4, then 2 a micro-step

    predictor = BenchmarkPredictor('cpu')
    net = predictor.load_model(run / 'last.ckpt')
    imgs = torch.from_numpy(_ae_images(5)).permute(0, 3, 1, 2)[:, :, :, :64].repeat(1, 1, 1, 3)
    with torch.no_grad():
        got = predictor.forward(net, imgs)
        want = loop.trainer.nets['depth'].eval()(imgs)['disp'][0]
    assert got.shape == (B, 1, 64, 192) and torch.equal(got, want)


@pytest.mark.parametrize('mode', ['train', 'val'])
def test_chip_smoke_feat_depth_stand_in_yields_the_readers_layout(tmp_path, monkeypatch, mode):
    """`chip_smoke.StereoHintLoader` with FeatDepth's supports and no hints yields the keys (in
    order), dtypes and shapes that `kitti_lmdb` yields with `feat_depth.yaml`'s datum at
    the cfg's batch (6) and shape."""
    import chip_smoke
    from slowtv_monodepth_tpu_torch import paths
    from test_torch_families import _write_dvso_pack
    from test_torch_recipe import _layout
    pack = tmp_path / 'kitti_raw_sync_lmdb'
    _write_dvso_pack(pack)
    monkeypatch.setitem(paths.DATA_PATHS, 'kitti_raw_lmdb', pack)
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml', CFG / 'benchmark' / 'feat_depth.yaml')
    cfg['dataset']['kitti_lmdb'].update(split='tiny', max_len=8)
    cfg['loader'].update(train={'num_workers': 0, 'shuffle': True},
                         val={'num_workers': 0, 'shuffle': False})
    b, supp = cfg['loader']['batch_size'], tuple(cfg['dataset']['kitti_lmdb']['supp_idxs'])
    assert tuple(cfg['dataset']['kitti_lmdb']['shape']) == chip_smoke.FAMILY_SHAPE
    assert chip_smoke.FEAT_WARP['feat_depth'] == (len(supp) * b, 64)
    real = next(iter(parsers.get_dl(mode, cfg['dataset'], cfg['loader'])))
    scenes = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    stand_in = next(iter(chip_smoke.StereoHintLoader(scenes, 1, mode == 'train', 0, supp, False, b)))
    assert _layout(stand_in) == _layout(real)
