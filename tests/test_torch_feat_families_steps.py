"""Depth-VO-Feat's and FeatDepth's training steps in the port against the JAX package's.

Both cfgs as they stand (`cfg/benchmark/default.yaml` + `depth_vo_feat.yaml` or
`feat_depth.yaml`), cut to test size as `tests/test_torch_feat_families.py:feat_cfg`
cuts them: a convnext_atto depth net with 2 scales, no pretrained files, B=2, 64x96,
the ResNet-18 pose net and autoencoder as published, `accumulate_grad_batches: 2`.
ONE jit of each cfg's JAX step (`make_step_fn`) in float64 (BatchNorm is in the
chain: flax's float32 batch variance is E[x^2] - E[x]^2) gives micro-step 1's loss
terms, its gradient (optax `MultiSteps`' state after one micro-step) and running
statistics, and for FeatDepth a trajectory of 3 updates (6 micro-steps). Both
automask noises are JAX's draws, each from its own loss key (`noise`). The port runs
in float32.

Tolerances:
- micro-step 1: every loss term rtol 1e-5 (measured <= 6e-7); the depth net's
  gradients per tensor 1e-3 of the tensor's largest JAX magnitude plus 1e-7
  (`compare_grads`; measured 6e-7 relative L2); the pose net's and the autoencoder's
  as one vector per net within 5e-3 relative L2 of the float64 oracle (measured: the
  port 2.6e-4 and 2.2e-3, the JAX package's own float32 step 6.1e-4 and 2.9e-3: a
  ReLU or an |x| within float32 rounding of its threshold flips, so single tensors are
  up to 3e-2 off on both sides); running statistics 1e-5 of each tensor's largest
  value, counters exactly 1 (pose) and 2 (autoencoder: target and support passes);
- the trajectory: each micro-step's loss rtol 1e-5 up to the first update, then 1e-3
  (`tests/test_torch_families_trajectory.py`); the running statistics after the last
  micro-step 2e-2 of each tensor's largest value (`tests/test_torch_resnet_trajectory.py`:
  they follow the nets' parameters).
Teeth: the autoencoder's support pass run on the targets fails the loss terms, the
running statistics and the trajectory; BatchNorm without a gradient through its
batch statistics fails the BatchNorm nets' gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.core.trainer import TrainState
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch import parsers
from slowtv_monodepth_tpu_torch.models import (autoencoder_state_dict_from_jax, norm,
                                               pose_state_dict_from_jax)
from test_torch_families import compare_grads, port_layout, port_trainer, seeded_weights, supp_of
from test_torch_feat_families import (ACCUMULATE, STATS_RTOL, _rel_faults, _x64, batch, feat_cfg,
                                      key, noise)
from torch_threads import two_torch_threads  # noqa: F401

LOSS_RTOL, BN_GRAD_L2 = 1e-5, 5e-3
N_UPDATES, STEPS_PER_EPOCH = 3, 2
EARLY_MICRO_STEPS, LATE_RTOL, LATE_STATS_RTOL = ACCUMULATE, 1e-3, 2e-2


def _stats_layout(params: dict, aux: dict, cfg: dict) -> dict:
    out = {}
    for net, a in aux.items():
        if 'batch_stats' not in a:
            continue
        fn = pose_state_dict_from_jax if net == 'pose' else functools.partial(
            autoencoder_state_dict_from_jax, out_scales=cfg['net'][net]['out_scales'])
        sd = fn(params[net], batch_stats=a['batch_stats'])
        out.update({f'{net}.{k}': v.numpy() for k, v in sd.items() if 'running' in k})
    return out


MICRO_STEPS = {'depth_vo_feat': 2, 'feat_depth': N_UPDATES * ACCUMULATE}


@functools.lru_cache(maxsize=None)
def jax_run(name: str) -> dict:
    """The JAX package in float64: one jit of `make_step_fn`, `MICRO_STEPS[name]`
    micro-steps; micro-step 1's gradient from `MultiSteps`' state and the running
    statistics after it."""
    cfg = feat_cfg(name)
    weights = seeded_weights(cfg)
    jt = JaxTrainer(cfg)
    with jax.enable_x64(True):
        params, aux = convert_reference_ckpt(_x64(weights), cfg)
        tx = jparsers.make_optimizer(cfg, steps_per_epoch=STEPS_PER_EPOCH, accumulate=ACCUMULATE)
        step = jax.jit(jt.make_step_fn(supp_of(cfg), tx))
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           aux={k: aux.get(k, {}) for k in params}, opt_state=tx.init(params),
                           bad_step=jnp.asarray(-1, jnp.int32))
        scalars = []
        for i in range(MICRO_STEPS[name]):
            x, y = jax.tree.map(jnp.asarray, _x64(batch(cfg, i)))
            state, sc = step(state, x, y, key(i))
            scalars.append({k: float(v) for k, v in sc.items()})
            if i == 0:
                first = jax.tree.map(np.asarray, (state.opt_state.acc_grads, state.aux))
        state = jax.tree.map(np.asarray, state)
    return {'name': name, 'cfg': cfg, 'weights': weights, 'scalars': scalars,
            'grads': port_layout(first[0], cfg), 'stats': _stats_layout(params, first[1], cfg),
            'last_stats': _stats_layout(state.params, state.aux, cfg),
            'noises': [noise(cfg, i, jt) for i in range(MICRO_STEPS[name])]}


def port_run(run: dict, micro_steps: int, fault=None) -> dict:
    cfg = run['cfg']
    trainer = port_trainer(cfg, run['weights'])
    opt = parsers.make_optimizer(cfg, trainer.nets, steps_per_epoch=STEPS_PER_EPOCH,
                                 accumulate=ACCUMULATE)
    step = trainer.make_step_fn(supp_of(cfg), opt)

    def stats():
        return {f'{n}.{k}': b.numpy().copy() for n, net in trainer.nets.items()
                for k, b in net.named_buffers() if 'running' in k}
    out = {'scalars': []}
    with pytest.MonkeyPatch.context() as mp:
        if fault == 'batch_statistics_detached':
            def detached(self, x):
                var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
                return F.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0, self.eps)
            mp.setattr(norm.BatchNorm2d, 'forward', detached)
        if fault == 'autoencoder_support_pass_on_the_targets':
            fwd = trainer.forward

            def same_frames(x, supp_idxs):
                return fwd({**x, 'supp_imgs': torch.stack([x['imgs']] * len(x['supp_imgs']))},
                           supp_idxs)
            mp.setattr(trainer, 'forward', same_frames)
        for i in range(micro_steps):
            x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, i))
            out['scalars'].append({k: v.item() for k, v in step(x, y, noise=run['noises'][i])
                                   .items()})
            if i == 0:
                out['grads'] = {f'{n}.{k}': p.grad.numpy().copy()
                                for n, net in trainer.nets.items()
                                for k, p in net.named_parameters()}
                out['stats'] = stats()
                out['counts'] = {n: {int(b) for k, b in net.named_buffers()
                                     if k.endswith('num_batches_tracked')}
                                 for n, net in trainer.nets.items()}
    out['last_stats'], out['updates'] = stats(), opt.updates
    return out


def _l2(got: dict, want: dict, net: str) -> float:
    keys = [k for k in want if k.startswith(f'{net}.')]
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((want[k] ** 2).sum()) for k in keys)) ** 0.5


def _step_faults(got: dict, run: dict) -> list:
    """Micro-step 1 of the port against the JAX package's."""
    want = run['scalars'][0]
    terms = sorted(k for k in want if k.startswith('loss'))
    bad = [] if terms == sorted(k for k in got['scalars'][0] if k.startswith('loss')) \
        else [f'terms {terms}']
    bad += [f'{k}: {got["scalars"][0][k]:.7g} vs {want[k]:.7g}' for k in terms
            if not abs(got['scalars'][0][k] - want[k]) <= LOSS_RTOL * abs(want[k])]
    depth = {k: v for k, v in got['grads'].items() if k.startswith('depth.')}
    bad += compare_grads(depth, {k: run['grads'][k] for k in depth})
    for net in {k.split('.')[0] for k in run['grads']} - {'depth'}:
        if not _l2(got['grads'], run['grads'], net) <= BN_GRAD_L2:
            bad.append(f'{net} gradient {_l2(got["grads"], run["grads"], net):.2e} relative L2')
    bad += [f'stats {k}' for k in _rel_faults(got['stats'], run['stats'], STATS_RTOL)]
    return bad


FEAT_CFGS = ('depth_vo_feat', 'feat_depth')


@pytest.fixture(scope='module', params=FEAT_CFGS)
def feat_run(request) -> dict:
    return jax_run(request.param)


def test_first_micro_step_matches_jax(feat_run):
    """Loss terms, every gradient and the running statistics of micro-step 1."""
    got = port_run(feat_run, 1)
    assert _step_faults(got, feat_run) == []
    terms = {k for k in got['scalars'][0] if k.startswith('loss_')}
    assert {'loss_img_recon', 'loss_feat_recon'} <= terms
    want_counts = {'depth': set(), 'pose': {1}}
    if feat_run['name'] == 'feat_depth':
        assert {'loss_autoenc_recon', 'loss_feat_peaky', 'loss_feat_smooth'} <= terms
        want_counts['autoencoder'] = {2}  # the target pass and the support pass
    assert got['counts'] == want_counts
    assert all(np.abs(g).max() > 0 for g in got['grads'].values())


def test_first_micro_step_check_has_teeth():
    """FeatDepth's autoencoder support pass given the targets fails the loss terms and
    the running statistics; BatchNorm that passes no gradient through its batch
    statistics (`tests/test_torch_resnet.py`'s fault) fails the BatchNorm nets'
    gradients."""
    run = jax_run('feat_depth')
    faults = _step_faults(port_run(run, 1, 'autoencoder_support_pass_on_the_targets'), run)
    assert any(f.startswith('loss_autoenc_recon') for f in faults)
    assert any(f.startswith('stats autoencoder.') for f in faults)
    faults = _step_faults(port_run(run, 1, 'batch_statistics_detached'), run)
    assert {f.split()[0] for f in faults if 'relative L2' in f} == {'pose', 'autoencoder'}


def test_feat_depth_trajectory_matches_jax():
    """3 updates of 2 micro-steps: each micro-step's loss, the running statistics after
    the last."""
    run = jax_run('feat_depth')
    got = port_run(run, MICRO_STEPS['feat_depth'])
    assert got['updates'] == N_UPDATES
    want = np.array([s['loss'] for s in run['scalars']])
    rel = np.abs(np.array([s['loss'] for s in got['scalars']]) - want) / np.abs(want)
    bound = np.where(np.arange(len(want)) < EARLY_MICRO_STEPS, LOSS_RTOL, LATE_RTOL)
    assert np.all(rel <= bound), rel
    assert _rel_faults(got['last_stats'], run['last_stats'], LATE_STATS_RTOL) == []
    assert want[-1] != want[0]


def test_trajectory_check_has_teeth():
    run = jax_run('feat_depth')
    got = port_run(run, 2, 'autoencoder_support_pass_on_the_targets')
    want = np.array([s['loss'] for s in run['scalars'][:2]])
    assert (np.abs(np.array([s['loss'] for s in got['scalars']]) - want) / want).max() > LOSS_RTOL
