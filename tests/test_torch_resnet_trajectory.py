"""The published Monodepth2-M recipe with its ResNet-18 pose net: the port's training
trajectory against the JAX package's, BatchNorm running statistics included; and
`frozen_bn` against the JAX package's optimizer.

- Monodepth2-M: `cfg/benchmark/default.yaml` + `monodepth2_M.yaml` as they stand
  (ResNet-18 pose net, min-reprojection + automask, supports (-1, 1), Adam under
  StepLR), cut to test size: a convnext_atto depth net, 2 scales, B=2, 64x96, no
  pretrained files, `accumulate_grad_batches: 2`. Both sides start from one set of
  seeded weights (the pose net's running statistics drawn, not 0 / 1) and take
  N_UPDATES updates over the same batches (`tests/test_torch_families.py:make_batch`),
  the JAX side as ONE jit of its step, the automask noise drawn from each
  micro-step's key. The pose net runs once on all 2 x B pairs, so its batch
  statistics span them, as in the JAX package.
- `frozen_bn`: one clipped AdamW update of a ResNet-18 pose net from the same
  gradients; the frozen set is read from the JAX optimizer's behaviour (the
  parameters it leaves where they were under gradients of ones).
- BatchNorm's modes in the port: the validation step and the image logger's
  rerun leave the running statistics alone (eval mode), the training step
  updates them once a micro-step, also when its loss is not finite (the JAX
  step carries `new_aux` on every call, `core/trainer.py:424-438`).

Tolerances:
- each micro-step's loss: rtol 1e-5 before the first update (measured 1e-6), then
  1e-3 (`tests/test_torch_trajectory.py`; measured up to 4.6e-4);
- the parameters after the last update, per net as one vector: the distance to
  the JAX package's over the length of the JAX package's own change, at most
  1e-2 for the depth net (measured 1.3e-3) and 0.3 for the pose net (measured
  0.11). The pose net's gradient is tiny (its outputs are scaled by 0.01), and
  both float32 sides are off the float64 gradient at micro-step 1 by ~1e-3
  relative L2 (the JAX package 1.1e-3, through its E[x^2] - E[x]^2 batch
  variance; the port 5.5e-4). Adam's m / sqrt(v) takes every value's sign and
  not its size, so those errors in the small values move whole updates;
- the running statistics after the last micro-step: 2e-2 of each tensor's
  largest value (measured 7.8e-3: they follow the pose net's activations,
  which follow its parameters; `tests/test_torch_resnet.py` holds the update
  itself at 1e-5);
- `frozen_bn`'s update: 1e-6 of each tensor's largest magnitude (one AdamW step
  of gradients away from zero is lr * sign(g) on both sides); the frozen
  parameters bitwise unchanged.
Teeth: BatchNorm in eval mode during the training step fails the trajectory;
picking `frozen_bn`'s set by the name `bn` (which misses `downsample.1`) fails;
nets left in train mode by the validation step and the logger fail.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.core.trainer import TrainState
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch import parsers
from slowtv_monodepth_tpu_torch.config import load_merge_yaml
from slowtv_monodepth_tpu_torch.models import PoseNet, norm, pose_state_dict_from_jax
from test_torch_families import port_layout, port_trainer, seeded_weights, supp_of
from test_torch_families_trajectory import batch, key, noise
from torch_threads import two_torch_threads  # noqa: F401

CFG = Path(__file__).resolve().parents[1] / 'cfg'
N_UPDATES, ACCUMULATE, STEPS_PER_EPOCH = 4, 2, 2
EARLY_MICRO_STEPS, EARLY_RTOL, LOSS_RTOL = ACCUMULATE, 1e-5, 1e-3
UPDATE_L2 = {'depth': 1e-2, 'pose': 0.3}
STATS_RTOL = 2e-2
FROZEN_RTOL = 1e-6


def monodepth2_m_cfg() -> dict:
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml',
                          CFG / 'benchmark' / 'monodepth2_M.yaml')
    cfg['net']['depth'].update(enc_name='convnext_atto', pretrained=False, out_scales=[0, 1])
    cfg['net']['pose'].update(pretrained=False)
    assert cfg['net']['pose']['enc_name'] == 'resnet18'
    cfg['trainer']['accumulate_grad_batches'] = ACCUMULATE
    return cfg


def _buffers(params: dict, aux: dict) -> dict:
    """JAX params + aux -> {'pose.<key>': running statistic} in the port's keys."""
    sd = pose_state_dict_from_jax(params['pose'], aux['pose']['batch_stats'])
    return {f'pose.{k}': v.numpy() for k, v in sd.items()
            if k.endswith(('running_mean', 'running_var'))}


@pytest.fixture(scope='module')
def jax_run() -> dict:
    cfg = monodepth2_m_cfg()
    weights = seeded_weights(cfg)
    params, aux = convert_reference_ckpt(weights, cfg)
    assert 'batch_stats' in aux['pose'] and 'depth' not in aux
    tx = jparsers.make_optimizer(cfg, steps_per_epoch=STEPS_PER_EPOCH, accumulate=ACCUMULATE)
    step = jax.jit(JaxTrainer(cfg).make_step_fn(supp_of(cfg), tx))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       aux={k: aux.get(k, {}) for k in params},
                       opt_state=tx.init(params), bad_step=jnp.asarray(-1, jnp.int32))
    losses = []
    for i in range(N_UPDATES * ACCUMULATE):
        x, y = jax.tree.map(jnp.asarray, batch(cfg, i))
        state, sc = step(state, x, y, key(i))
        losses.append(float(sc['loss']))
    state = jax.tree.map(np.asarray, state)
    return {'cfg': cfg, 'weights': weights, 'losses': losses,
            'params': port_layout(state.params, cfg), 'stats': _buffers(state.params, state.aux)}


def port_run(run: dict, micro_steps: int) -> dict:
    cfg = run['cfg']
    trainer = port_trainer(cfg, run['weights'])
    opt = parsers.make_optimizer(cfg, trainer.nets, steps_per_epoch=STEPS_PER_EPOCH,
                                 accumulate=ACCUMULATE)
    step = trainer.make_step_fn(supp_of(cfg), opt)
    losses = []
    for i in range(micro_steps):
        x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, i))
        losses.append(step(x, y, noise=noise(cfg, i))['loss'].item())
    return {'losses': losses, 'trainer': trainer,
            'params': {f'{n}.{k}': p.detach().numpy() for n, net in trainer.nets.items()
                       for k, p in net.named_parameters()},
            'stats': {f'{n}.{k}': b.numpy() for n, net in trainer.nets.items()
                      for k, b in net.named_buffers() if 'running' in k}}


def _loss_faults(got: list, want: list) -> list:
    return [f'micro-step {i}: {g:.7g} vs {w:.7g}' for i, (g, w) in enumerate(zip(got, want))
            if not abs(g - w) <= (EARLY_RTOL if i < EARLY_MICRO_STEPS else LOSS_RTOL) * abs(w)]


def _update_l2(got: dict, run: dict, net: str) -> float:
    """|port - JAX| over |JAX - initial| of one net's parameters, as one vector."""
    keys = [k for k in run['params'] if k.startswith(f'{net}.')]
    init = {k: run['weights'][f'nets.{k}'] for k in keys}
    num = sum(float(((got[k] - run['params'][k]) ** 2).sum()) for k in keys)
    return (num / sum(float(((run['params'][k] - init[k]) ** 2).sum()) for k in keys)) ** 0.5


def test_monodepth2_m_trajectory_matches_jax(jax_run):
    got = port_run(jax_run, N_UPDATES * ACCUMULATE)
    assert _loss_faults(got['losses'], jax_run['losses']) == []
    assert sorted(got['params']) == sorted(jax_run['params'])
    for net, bound in UPDATE_L2.items():
        assert _update_l2(got['params'], jax_run, net) <= bound, net
    assert sorted(got['stats']) == sorted(jax_run['stats']) and got['stats']
    bad = [k for k, w in jax_run['stats'].items()
           if not np.abs(got['stats'][k] - w).max() <= STATS_RTOL * np.abs(w).max()]
    assert bad == []
    counts = {int(b) for k, b in got['trainer'].nets['pose'].named_buffers()
              if k.endswith('num_batches_tracked')}
    assert counts == {N_UPDATES * ACCUMULATE}


def test_trajectory_check_has_teeth(jax_run, monkeypatch):
    """BatchNorm on its running statistics (eval mode) in the training step fails at
    the first micro-step."""
    monkeypatch.setattr(norm.BatchNorm2d, 'forward', lambda self, x: F.batch_norm(
        x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps))
    assert _loss_faults(port_run(jax_run, 1)['losses'], jax_run['losses'][:1])


# ------------------------------------------------------------------ frozen_bn
OPT = {'type': 'adamw', 'lr': 1e-3, 'weight_decay': 1e-2, 'frozen_bn': True}
GRAD_CLIP = 0.5


def _jax_update(cfg: dict, params: dict, grads: dict, clip=GRAD_CLIP) -> dict:
    """One update of the JAX package's `make_optimizer(cfg)` (one jit) -> the pose
    net's new parameters in the port's keys."""
    tx = jparsers.make_optimizer(cfg, grad_clip=clip)
    new = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        params, grads)
    new = pose_state_dict_from_jax(jax.tree.map(np.asarray, new))
    return {k: v.numpy() for k, v in new.items()}


@functools.lru_cache(maxsize=None)
def jax_frozen() -> dict:
    """A seeded ResNet-18 pose net and seeded gradients; the JAX optimizer's frozen set
    (the parameters it leaves unchanged under gradients of ones) and its clipped AdamW
    update from those gradients."""
    cfg = {'net': {'pose': {'enc_name': 'resnet18', 'pretrained': False}}, 'optimizer': OPT}
    weights = seeded_weights(cfg)
    rs = np.random.RandomState(11)
    grads = {k: v if 'running' in k or k.endswith('num_batches_tracked')
             else rs.standard_normal(v.shape).astype(np.float32) for k, v in weights.items()}
    params = convert_reference_ckpt(weights, cfg)[0]['pose']
    before = {k: v.numpy() for k, v in pose_state_dict_from_jax(params).items()}
    ones = _jax_update({**cfg, 'optimizer': {'type': 'adam', 'lr': 1e-3, 'frozen_bn': True}},
                       params, jax.tree.map(jnp.ones_like, params), clip=None)
    return {'cfg': cfg, 'weights': weights, 'grads': grads,
            'frozen': {k for k in before if np.array_equal(before[k], ones[k])},
            'update': _jax_update(cfg, params, convert_reference_ckpt(grads, cfg)[0]['pose'])}


def _frozen_faults() -> list:
    """The port's `frozen_bn` set and one clipped update from the same gradients,
    against `jax_frozen` -> the faults."""
    run = jax_frozen()
    net = PoseNet(**run['cfg']['net']['pose'])
    net.load_state_dict({k[len('nets.pose.'):]: torch.from_numpy(v)
                         for k, v in run['weights'].items()})
    for k, p in net.named_parameters():
        p.grad = torch.from_numpy(run['grads'][f'nets.pose.{k}']).clone()
    opt = parsers.make_optimizer(run['cfg'], torch.nn.ModuleDict({'pose': net}),
                                 grad_clip=GRAD_CLIP)
    names = {id(p): k for k, p in net.named_parameters()}
    faults = []
    if {names[id(p)] for p in opt.frozen} != run['frozen']:
        faults.append(f'frozen set {sorted({names[id(p)] for p in opt.frozen} ^ run["frozen"])}')
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    assert opt.step()
    want = run['update']
    for k, p in net.named_parameters():
        if k in run['frozen'] and not torch.equal(p, before[k]):
            faults.append(f'{k} moved')
        elif not np.abs(p.detach().numpy() - want[k]).max() <= FROZEN_RTOL * np.abs(want[k]).max():
            faults.append(f'{k} off')
    return faults


def test_frozen_bn_matches_jax():
    """The frozen set (every BatchNorm's scale and bias, `downsample.1` included) is
    the JAX optimizer's; one clipped AdamW update leaves it where it was and moves
    every other parameter as the JAX package does (the clip's norm counting the
    frozen gradients, the decay skipping 1-D parameters)."""
    frozen = jax_frozen()['frozen']
    assert any('downsample.1' in k for k in frozen)
    assert all(k.startswith('encoder.') and k.endswith(('.weight', '.bias')) for k in frozen)
    assert _frozen_faults() == []


def test_frozen_bn_check_has_teeth(monkeypatch):
    """Picking the set by the substring `bn` in the port's (timm's) names misses the
    downsample's BatchNorm, `downsample.1`."""
    monkeypatch.setattr(parsers, 'bn_params', lambda nets: [
        p for n, p in nets.named_parameters() if any('bn' in part for part in n.split('.'))])
    faults = _frozen_faults()
    assert faults and 'downsample.1' in faults[0]


# ------------------------------------------------------------------ BatchNorm's modes
class _Writer:
    def add_images(self, *a, **kw):
        pass

    def add_text(self, *a, **kw):
        pass


def _buffers_of(trainer) -> dict:
    return {f'{n}.{k}': b.clone() for n, net in trainer.nets.items()
            for k, b in net.named_buffers()}


def _mode_faults(trainer_eval_noop: bool = False) -> list:
    """Monodepth2-M's validation step and the image logger's rerun (eval mode: the
    running statistics) leave every buffer as it was, and the training step after
    them updates each BatchNorm once -> the buffers that broke that."""
    from slowtv_monodepth_tpu_torch.core import HeavyLogger
    cfg = monodepth2_m_cfg()
    trainer = port_trainer(cfg, seeded_weights(cfg))
    if trainer_eval_noop:  # the fault: the nets stay in train mode
        trainer.nets.eval = lambda: trainer.nets
    supp = supp_of(cfg)
    x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, 0))
    before = _buffers_of(trainer)
    trainer.make_step_fn(supp, train=False)(x, y, noise=noise(cfg, 0))
    HeavyLogger(2, 1).log_step(trainer, (x, y, {}), supp, _Writer(), epoch=0, noise=noise(cfg, 0))
    faults = [k for k, b in _buffers_of(trainer).items() if not torch.equal(b, before[k])]
    opt = parsers.make_optimizer(cfg, trainer.nets)
    trainer.make_step_fn(supp, opt)(x, y, noise=noise(cfg, 0))
    after = _buffers_of(trainer)
    faults += [k for k, b in after.items() if k.endswith('num_batches_tracked')
               and int(b) != int(before[k]) + 1 + (2 if trainer_eval_noop else 0)]
    return faults


def test_validation_and_the_image_logger_use_the_running_statistics():
    assert _mode_faults() == []


def test_mode_check_has_teeth():
    """Nets left in train mode by the validation step and the logger fail."""
    assert _mode_faults(trainer_eval_noop=True)


def test_running_statistics_update_on_a_non_finite_micro_step():
    """As the JAX step carries `new_aux` on every call: a micro-step whose loss is not
    finite still updates every BatchNorm (here to NaN), and trips `bad_step`."""
    cfg = monodepth2_m_cfg()
    trainer = port_trainer(cfg, seeded_weights(cfg))
    x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, 0))
    x['supp_imgs'] = torch.full_like(x['supp_imgs'], float('nan'))
    opt = parsers.make_optimizer(cfg, trainer.nets, accumulate=ACCUMULATE)
    loss = trainer.make_step_fn(supp_of(cfg), opt)(x, y, noise=noise(cfg, 0))['loss']
    assert not torch.isfinite(loss) and int(trainer.bad_step) == 0
    bufs = _buffers_of(trainer)
    assert all(int(b) == 1 for k, b in bufs.items() if k.endswith('num_batches_tracked'))
    assert all(torch.isnan(b).any() for k, b in bufs.items() if 'running' in k)
