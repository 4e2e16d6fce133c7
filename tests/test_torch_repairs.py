"""Faults of the port against the JAX package, each held by a test that the
unrepaired port fails (ROADMAP queue C items 1, 2, 3, 5, 7 and 9).

1. Initial weights: flax's `lecun_normal` kernels and zero biases, LayerNorm
   1 / 0, layer scale 1e-6, compared parameter by parameter with the JAX
   package's `MonoDepthTrainer.init_state` at convnext_atto. The two sides
   draw from different generators, so the test compares statistics: each
   weight's mean and standard deviation within 6 standard errors of the
   JAX draw's (a tensor of n values from a deviation-s law has a mean good to
   s / sqrt(n) and a deviation good to under s / sqrt(n) each; the smallest
   tensor has 144 values), every value inside flax's truncation at twice the
   deviation, and biases, LayerNorm and layer scale exactly equal. PyTorch's
   own defaults (kaiming-uniform, uniform biases) fail it.
2. `pretrained: True`: a warning when `<model_root>/timm/` holds no file;
   when it holds one (`.npz` or `.pth`), its weights in the encoder (A7b
   ported the graft; `tests/test_torch_pretrained.py` holds it to the JAX
   package's loader). The test keeps its name from when a file raised.
3. A warm start (`trainer.load_ckpt`) restores the optimizer state when the
   file has it and starts the step count from 0.
5. `dec_phase_up` / `enc_remat` (exact transforms) are accepted and change
   nothing.
7. An unknown dataset raises `KeyError` listing the registry, as the JAX
   package's `get_ds` does (every dataset of the JAX registry is ported).
9. `trainer.logger: 'wandb'` without wandb installed warns and logs to
   tensorboard, as the JAX package's entry point does (`api/train/train.py:64-72`).
"""
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu_torch import parsers, paths
from slowtv_monodepth_tpu_torch.core import MonoDepthLoop, load_checkpoint, save_checkpoint
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.models import (DepthNet, PoseNet, depth_state_dict_from_jax,
                                               pose_state_dict_from_jax)
from slowtv_monodepth_tpu_torch.models.init import TRUNC_STD
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

NET = {'depth': {'enc_name': 'convnext_atto', 'pretrained': False, 'dec_name': 'monodepth',
                 'out_scales': [0, 1, 2, 3]},
       'pose': {'enc_name': 'convnext_atto', 'pretrained': False, 'learn_K': True}}
LOSS = {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
        'disp_smooth': {'weight': 0.001, 'use_edges': True}}
SIGMAS = 6


# ------------------------------------------------------------ 1. initial weights
@pytest.fixture(scope='module')
def jax_init() -> dict:
    """The JAX package's initial weights in the port's keys and layouts."""
    trainer = JaxTrainer({'net': NET, 'loss': LOSS})
    state = trainer.init_state(jax.random.PRNGKey(0), {'imgs': jnp.zeros((1, 64, 96, 3))}, (-1, 1))
    params = jax.tree.map(np.asarray, state.params)
    return {'depth': {k: v.numpy() for k, v in depth_state_dict_from_jax(
                params['depth'], NET['depth']['out_scales']).items()},
            'pose': {k: v.numpy() for k, v in pose_state_dict_from_jax(params['pose']).items()}}


def _port_nets(torch_defaults: bool = False) -> dict:
    torch.manual_seed(0)
    nets = {'depth': DepthNet(**NET['depth']), 'pose': PoseNet(**NET['pose'])}
    if torch_defaults:  # the fault: PyTorch's own initializers
        for net in nets.values():
            for m in net.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                    m.reset_parameters()
    return {k: {kk: v.numpy() for kk, v in net.state_dict().items()} for k, net in nets.items()}


def _init_faults(port: dict, want: dict) -> list[str]:
    bad = []
    for name in want:
        assert sorted(port[name]) == sorted(want[name])
        for key, w in want[name].items():
            p = port[name][key]
            if w.ndim == 1 or key.endswith('gamma'):  # biases, LayerNorm, layer scale
                if not np.array_equal(p, w):
                    bad.append(f'{name}.{key}: {p[:3]} vs {w[:3]}')
                continue
            n, sd = w.size, float(w.std())
            cut = 2 / np.sqrt(np.prod(w.shape[1:])) / TRUNC_STD  # flax's truncation at 2 sigma
            if abs(float(p.mean()) - float(w.mean())) > SIGMAS * sd * np.sqrt(2 / n) \
                    or abs(float(p.std()) - sd) > SIGMAS * sd / np.sqrt(n) \
                    or float(np.abs(p).max()) > cut * (1 + 1e-6):
                bad.append(f'{name}.{key}: mean {p.mean():.3g} vs {w.mean():.3g}, '
                           f'std {p.std():.4g} vs {sd:.4g}, max {np.abs(p).max():.3g}')
    return bad


def test_initial_weights_are_drawn_as_the_jax_package_draws_them(jax_init):
    assert _init_faults(_port_nets(), jax_init) == []


def test_initial_weight_check_has_teeth(jax_init):
    bad = _init_faults(_port_nets(torch_defaults=True), jax_init)
    assert any('std' in b for b in bad) and any('bias' in b for b in bad)


def test_initializer_works_on_the_meta_device():
    with torch.device('meta'):
        net = DepthNet(**NET['depth'])
    assert all(p.is_meta for p in net.parameters())


# ------------------------------------------------------------------ 2. pretrained
@pytest.mark.parametrize('net', ['depth', 'pose'])
def test_pretrained_without_a_file_warns_and_goes_on(net, tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    cfg = {'net': {**NET, net: {**NET[net], 'pretrained': True}}, 'loss': LOSS}
    with caplog.at_level(logging.WARNING):
        MonoDepthTrainer(cfg)
    assert 'No pretrained weights for "convnext_atto" under <model_root>/timm/' in caplog.text


@pytest.mark.parametrize('suffix', ['.npz', '.pth'])
def test_pretrained_with_a_file_raises_naming_the_roadmap_item(suffix, tmp_path, monkeypatch):
    """A file in the second model root is found and loaded into the depth
    encoder; the pose net (`pretrained: False`) keeps its initial draw."""
    import chip_smoke
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path / 'empty', tmp_path])
    sd = chip_smoke.timm_state_dict('convnext_atto', seed=1)
    chip_smoke.write_timm_file(tmp_path, 'convnext_atto', suffix, sd)
    cfg = {'net': {**NET, 'depth': {**NET['depth'], 'pretrained': True}}, 'loss': LOSS}
    nets = MonoDepthTrainer(cfg).nets
    got = nets['depth'].encoder.state_dict()
    assert all(np.array_equal(v.numpy(), sd[k]) for k, v in got.items())
    assert not np.array_equal(nets['pose'].encoder.state_dict()['stages.0.blocks.0.gamma'],
                              sd['stages.0.blocks.0.gamma'])
    blank = MonoDepthTrainer({'net': NET, 'loss': LOSS}).nets  # pretrained: False never looks
    assert not np.array_equal(blank['depth'].encoder.state_dict()['stem.0.weight'],
                              sd['stem.0.weight'])


# ------------------------------------------------------------------ 3. warm start
class _NoBatches:
    def __len__(self):
        return 0

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(())


def _loop(tmp_path, name, **trainer):
    cfg = {'net': NET, 'loss': LOSS, 'optimizer': {'type': 'adamw', 'lr': 1e-4, 'weight_decay': 1e-3},
           'scheduler': {'linear': {'start_factor': 0.5, 'total_iters': 2}},
           'trainer': {'max_epochs': 1, 'accumulate_grad_batches': 2, 'min_depth': 0.1,
                       'max_depth': 100, **trainer}}
    return MonoDepthLoop(cfg, tmp_path / name, device='cpu', train_dl=_NoBatches(), use_markers=False)


def _opt_tensors(opt) -> list:
    sd = opt.state_dict()
    return [t for s in sd['opt']['state'].values() for t in s.values()] + sd['grads']


@pytest.mark.parametrize('with_optimizer', [True, False], ids=['training_ckpt', 'released_ckpt'])
def test_warm_start_restores_the_optimizer_state_and_starts_at_step_0(tmp_path, with_optimizer):
    src = _loop(tmp_path, 'src')
    rs = np.random.RandomState(0)
    for _ in range(3):  # one update, then one micro-step accumulated
        for p in src.opt.params():
            p.grad = torch.from_numpy(rs.standard_normal(p.shape).astype(np.float32))
        src.opt.step()
    nets = {k: net.state_dict() for k, net in src.trainer.nets.items()}
    path = tmp_path / 'warm.ckpt'
    save_checkpoint(path, nets, src.cfg, opt=src.opt if with_optimizer else None, epoch=4, step=17)

    dst = _loop(tmp_path, 'dst', load_ckpt=str(path), resume_training=False)
    dst._init_state()
    got = {k: net.state_dict() for k, net in dst.trainer.nets.items()}
    assert all(torch.equal(got[n][k], v) for n in nets for k, v in nets[n].items())
    assert dst.global_step == 0 and int(dst.trainer.step_count) == 0
    assert int(dst.trainer.bad_step) == -1
    if with_optimizer:
        assert (dst.opt.updates, dst.opt.micro) == (src.opt.updates, src.opt.micro) == (1, 1)
        want = _opt_tensors(src.opt)
        assert len(want) > 3 * len(src.opt.params())
        assert all(torch.equal(a, b) for a, b in zip(_opt_tensors(dst.opt), want))
    else:
        assert (dst.opt.updates, dst.opt.micro, dst.opt.opt.state_dict()['state']) == (0, 0, {})
    path.unlink()


def test_resume_refuses_a_last_checkpoint_without_optimizer_state(tmp_path):
    """A warm start takes a released checkpoint; a resume needs a training one."""
    src = _loop(tmp_path, 'src')
    nets = {k: net.state_dict() for k, net in src.trainer.nets.items()}
    save_checkpoint(tmp_path / 'run' / 'last.ckpt', nets, src.cfg, epoch=4, step=17)
    with pytest.raises(ValueError, match='not a training checkpoint'):
        _loop(tmp_path, 'run')._init_state()


@pytest.mark.parametrize('async_ckpt', [True, False, None], ids=['on', 'off', 'absent'])
def test_async_checkpoints_raise_naming_the_roadmap_item(tmp_path, async_ckpt):
    """`trainer.async_ckpt` (the JAX loop's asynchronous saves, ported in A7b;
    the test keeps its name from when it raised): on, the loop builds with a
    background saver; off or absent, without one. Either way an epoch's save
    writes `last` and `best` holding the nets' weights once `finalize` returns."""
    trainer = {} if async_ckpt is None else {'async_ckpt': async_ckpt}
    loop = _loop(tmp_path, 'run', **trainer)
    assert (loop.ckpt.saver is not None) == bool(async_ckpt)
    loop.ckpt.step(loop.trainer.nets, loop.opt, loop.cfg, 0, 0, {loop.monitor: 1.0})
    loop.ckpt.finalize()
    for name in ('last', 'best'):
        sd, _ = load_checkpoint(tmp_path / 'run' / f'{name}.ckpt')
        want = loop.trainer.nets['depth'].state_dict()
        assert all(torch.equal(sd[f'nets.depth.{k}'], v) for k, v in want.items())
        (tmp_path / 'run' / f'{name}.ckpt').unlink()


# ---------------------------------------------------------- 5. TPU recipe options
def test_a_tpu_recipe_depth_cfg_builds_and_serves_the_same_maps():
    """`cfg/kbr/tpu.yaml`'s net.depth with the two exact transforms it may carry."""
    base = {**NET['depth'], 'gelu': 'tanh', 'dec_pad_mode': 'zeros'}
    torch.manual_seed(0)
    plain = DepthNet(**base).eval()
    tpu = DepthNet(**base, dec_phase_up=True, enc_remat='dots').eval()
    tpu.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 64, 96).astype(np.float32))
    with torch.no_grad():
        a, b = plain(x)['disp'], tpu(x)['disp']
    assert a.keys() == b.keys() and all(torch.equal(a[s], b[s]) for s in a)


# --------------------------------------------------------------------- 7. message
def test_an_unknown_dataset_raises_key_error_like_jax():
    """Both packages' `get_ds` refuse a name that no dataset registered, with the
    same `KeyError` naming it and listing the registry."""
    from slowtv_monodepth_tpu import parsers as jparsers
    errors = []
    for get_ds in (parsers.get_ds, jparsers.get_ds):
        with pytest.raises(KeyError, match='Unknown dataset "nope_ds"') as e:
            get_ds({'nope_ds': {'mode': 'val'}})
        errors.append(e.value.args[0])
    assert errors[0] == errors[1] and "'ddad'" in errors[0] and "'tum'" in errors[0]


# --------------------------------------------------------------------- 9. logger
def test_wandb_without_the_package_warns_and_logs_to_tensorboard(tmp_path, monkeypatch, caplog):
    from slowtv_monodepth_tpu_torch.train import make_writer
    monkeypatch.setitem(sys.modules, 'wandb', None)  # `import wandb` raises ImportError
    with caplog.at_level(logging.WARNING):
        writer = make_writer('wandb', tmp_path / 'logs', name='run_000')
    assert 'wandb unavailable; falling back to tensorboard.' in caplog.text
    writer.add_scalar('train_losses/loss', 0.5, 1)
    writer.close()
    assert list((tmp_path / 'logs').glob('events.out.tfevents.*'))


# ------------------------------------------------------------ T2. SWA over BatchNorm nets
def _swa_run(tmp_path, epochs: int = 4) -> tuple:
    """`MonoDepthLoop`'s SWA callbacks over ResNet-18 nets, `epochs` epochs of which the
    last quarter averages: each epoch moves every parameter and buffer as training
    would -> (the snapshots seen by the averaging epochs, the nets, swa.ckpt's tensors)."""
    net = {'depth': {'enc_name': 'resnet18', 'pretrained': False, 'dec_name': 'monodepth',
                     'out_scales': [0]},
           'pose': {'enc_name': 'resnet18', 'pretrained': False}}
    cfg = {'net': net, 'loss': LOSS, 'optimizer': {'type': 'adam', 'lr': 1e-4},
           'trainer': {'max_epochs': epochs, 'swa': True}}
    loop = MonoDepthLoop(cfg, tmp_path / 'run', device='cpu', train_dl=_NoBatches(),
                         use_markers=False)
    gen = torch.Generator().manual_seed(2)
    seen = []
    with torch.no_grad():
        for epoch in range(epochs):
            if epoch >= int(0.75 * epochs):  # the averaging epochs: new values each
                for p in loop.trainer.nets.parameters():
                    p.add_(torch.randn(p.shape, generator=gen))
                for k, b in loop.trainer.nets.named_buffers():
                    b.add_(1 if k.endswith('num_batches_tracked') else
                           float(torch.rand((), generator=gen)) + 0.1)
                seen.append({f'nets.{n}.{k}': v.clone()
                             for n, net_ in loop.trainer.nets.items()
                             for k, v in net_.state_dict().items()})
            loop._swa_update(epoch)
    loop._swa_finalize()
    return seen, loop.trainer.nets, load_checkpoint(tmp_path / 'run' / 'swa.ckpt')[0]


def test_swa_averages_the_parameters_and_keeps_the_buffers(tmp_path):
    """swa.ckpt holds the mean of the parameters over the averaging epochs and the
    buffers' last values (BatchNorm's running statistics, int64 counters), as the JAX
    package's `state.replace(params=avg)` keeps its `batch_stats`. The parent averaged
    every `state_dict` entry, counters cast to float."""
    seen, nets, swa = _swa_run(tmp_path, epochs=8)
    assert len(seen) == 2
    params = {f'nets.{n}.{k}' for n, net in nets.items() for k, _ in net.named_parameters()}
    buffers = {f'nets.{n}.{k}' for n, net in nets.items() for k, _ in net.named_buffers()}
    assert sorted(swa) == sorted(params | buffers) and buffers
    for k in params:
        torch.testing.assert_close(swa[k], (seen[0][k] + seen[1][k]) / 2, rtol=0, atol=1e-6)
    for k in buffers:
        assert swa[k].dtype == seen[-1][k].dtype and torch.equal(swa[k], seen[-1][k]), k
    assert {swa[k].dtype for k in buffers if k.endswith('num_batches_tracked')} == {torch.int64}
