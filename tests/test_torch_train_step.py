"""Port differential for the training slice as a whole: one accumulated
optimizer update of the port's `MonoDepthTrainer` against the JAX package's
`make_step_fn`.

The KBR recipe (`cfg/kbr/default.yaml`: img_recon with min-reprojection and
automask, edge-aware disp_smooth, AdamW lr 1e-4 wd 1e-3 under StepLR x
LinearLR, accumulate 2, min/max depth 0.1/100, `always_fwd_pose` False) on
convnext_atto depth and pose nets with learned intrinsics, 4 scales, B=2 at
64x96. `steps_per_epoch=1`, so the warm-up schedule moves every update and
counting micro-steps instead of updates would show.

Weights: `models.seeded_state_dict` for the port's keys, carried into JAX by
`convert_reference_ckpt`; grads and updated params come back through the
port's bridge (`depth_state_dict_from_jax`, `pose_state_dict_from_jax`).
The JAX side runs both micro-steps and the first micro-step's gradient in
ONE jit (`SLOWTV_FORCE_PALLAS_{WARP,PHOTO}`: its warp and photometric
kernels in interpret mode, with their custom VJPs). The automask tie-break
noise of each micro-step is JAX's own draw from that step's key, handed to
the port. The port runs on the CPU (plain versions behind its autograd
Functions).

Tolerances (float32, sums in another order through ~20 residual blocks):
- losses: rtol 1e-5;
- gradients: per tensor, atol 1e-3 of that tensor's largest JAX magnitude
  plus 1e-7;
- parameters after the update: atol 2e-7 (2% of the first update,
  lr * 0.1 = 1e-5 per element) wherever the gradient averaged over the two
  micro-steps is above 1e-3 of its tensor's largest. Adam's first update is
  about lr * sign(averaged gradient), so where the two micro-steps' grads
  cancel to below the grads' own float32 agreement the sign is noise: there
  the bound is two updates, 2e-5 + 2e-7, and fewer than 1 element in 10^3
  may be off by more than 2e-7 (measured: about 1 in 10^4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.core.trainer import TrainState
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch import parsers
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.models import (depth_state_dict_from_jax,
                                               pose_state_dict_from_jax, seeded_state_dict)
from torch_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 64, 96
SUPP = (-1, 1)
N_SCALES = 4
CFG = {
    'net': {'depth': {'enc_name': 'convnext_atto', 'pretrained': False, 'dec_name': 'monodepth',
                      'out_scales': [0, 1, 2, 3]},
            'pose': {'enc_name': 'convnext_atto', 'pretrained': False, 'learn_K': True}},
    'loss': {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
             'disp_smooth': {'weight': 0.001, 'use_edges': True}},
    'optimizer': {'type': 'adamw', 'lr': 1e-4, 'weight_decay': 1e-3},
    'scheduler': {'steplr': {'step_size': 40, 'gamma': 0.1},
                  'linear': {'start_factor': 0.1, 'total_iters': 4}},
    'trainer': {'min_depth': 0.1, 'max_depth': 100, 'always_fwd_pose': False},
}
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-7
PARAM_ATOL = 2e-7
UPDATE = 1e-5  # lr 1e-4 x the warm-up's first factor 0.1


def make_batch(seed: int) -> tuple[dict, dict]:
    """Random images, supports shifted by +-2 px (as `bench.py`), a fixed K."""
    imgs = np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)
    supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
    K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    x = {'imgs': imgs, 'supp_imgs': supp}
    return x, dict(x, K=np.ascontiguousarray(np.broadcast_to(K, (B, 4, 4))))


def jax_noise(key) -> np.ndarray:
    """The automask noise `JaxTrainer.loss_fn` draws from a step key."""
    _, rng_loss = jax.random.split(key)
    rng_recon = jax.random.split(rng_loss, len(CFG['loss']))[0]  # img_recon is first
    return np.asarray(jax.random.normal(rng_recon, (N_SCALES * B, H, W, 1)))


def port_layout(tree: dict) -> dict:
    """JAX {depth, pose} trees -> {'depth.<key>': array, 'pose.<key>': array}."""
    sds = {'depth': depth_state_dict_from_jax(tree['depth'], CFG['net']['depth']['out_scales']),
           'pose': pose_state_dict_from_jax(tree['pose'])}
    return {f'{net}.{k}': v.numpy() for net, sd in sds.items() for k, v in sd.items()}


def seeded_weights() -> dict:
    nets = MonoDepthTrainer(CFG).nets
    return {f'nets.{k}.{kk}': v for k in nets for kk, v in seeded_state_dict(nets[k], 0).items()}


@pytest.fixture(scope='module')
def ref():
    """The JAX package: two micro-steps of `make_step_fn`, plus micro-step 1's grads."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SLOWTV_FORCE_PALLAS_WARP', '1')
        mp.setenv('SLOWTV_FORCE_PALLAS_PHOTO', '1')
        params, _ = convert_reference_ckpt(seeded_weights(), CFG)
        trainer = JaxTrainer(CFG)
        tx = jparsers.make_optimizer(CFG, steps_per_epoch=1, accumulate=2)
        step = trainer.make_step_fn(SUPP, tx)
        batches = [tuple(jax.tree.map(jnp.asarray, b)) for b in (make_batch(1), make_batch(2))]
        keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]

        def run(params):
            state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, aux={},
                               opt_state=tx.init(params), bad_step=jnp.asarray(-1, jnp.int32))
            scalars = []
            for (x, y), key in zip(batches, keys):
                state, sc = step(state, x, y, key)
                scalars.append(sc)
            x, y = batches[0]
            grads = jax.grad(lambda p: trainer.loss_fn(p, {}, x, y, SUPP, keys[0], True)[0])(params)
            return scalars, grads, state.params, state.bad_step

        scalars, grads, new_params, bad = jax.tree.map(np.asarray, jax.jit(run)(params))
    return {'params': port_layout(jax.tree.map(np.asarray, params)),
            'scalars': scalars, 'grads': port_layout(grads),
            'new_params': port_layout(new_params), 'bad_step': int(bad),
            'noise': [jax_noise(k) for k in keys]}


def run_port(ref, fault=None) -> dict:
    trainer = MonoDepthTrainer(CFG)
    for name, net in trainer.nets.items():
        net.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v)
                             for k, v in ref['params'].items() if k.startswith(f'{name}.')})
    if fault == 'pose_pairs_swapped':
        trainer.always_fwd_pose = True
    opt = parsers.make_optimizer(CFG, trainer.nets, steps_per_epoch=1, accumulate=2)
    if fault == 'schedule_counts_micro_steps':
        opt.lrs = lambda: [lr * opt.sched(opt.updates * 2 + opt.micro - 1) for lr in opt.base_lrs]
    step = trainer.make_step_fn(SUPP, opt)
    out = {'scalars': []}
    names = {id(p): f'{n}.{k}' for n, net in trainer.nets.items()
             for k, p in net.named_parameters()}
    inner_step = opt.opt.step

    def recording_step():  # the averaged grads the update sees
        out['avg_grads'] = {names[id(p)]: p.grad.numpy().copy()
                            for g in opt.opt.param_groups for p in g['params']}
        return inner_step()

    opt.opt.step = recording_step
    for i, seed in enumerate((1, 2)):
        x, y = (jax.tree.map(torch.from_numpy, b) for b in make_batch(seed))
        noise = torch.from_numpy(ref['noise'][i].copy())
        out['scalars'].append({k: v.item() for k, v in
                               step(x, y, noise=noise).items()})
        if i == 0:
            out['grads'] = {f'{n}.{k}': p.grad.numpy().copy()
                            for n, net in trainer.nets.items()
                            for k, p in net.named_parameters()}
            out['after_micro_1'] = {f'{n}.{k}': v.numpy().copy()
                                    for n, net in trainer.nets.items()
                                    for k, v in net.state_dict().items()}
    out['new_params'] = {f'{n}.{k}': v.numpy() for n, net in trainer.nets.items()
                         for k, v in net.state_dict().items()}
    out['bad_step'] = trainer.bad_step.item()
    out['updates'] = opt.updates
    return out


@pytest.fixture(scope='module')
def port(ref):
    return run_port(ref)


@pytest.mark.parametrize('micro', [0, 1])
def test_losses_match_jax(ref, port, micro):
    want, got = ref['scalars'][micro], port['scalars'][micro]
    for key in ('loss', 'loss_img_recon', 'loss_disp_smooth'):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)


def test_summaries_match_jax(ref, port):
    want, got = ref['scalars'][0], port['scalars'][0]
    assert sorted(got) == sorted(k for k in want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-7, err_msg=key)


def _compare(got: dict, want: dict, net: str, tol):
    keys = sorted(k for k in want if k.startswith(f'{net}.'))
    assert keys and keys == sorted(k for k in got if k.startswith(f'{net}.'))
    bad = []
    for k in keys:
        atol = tol(want[k])
        err = float(np.abs(got[k] - want[k]).max())
        if not err <= atol:
            bad.append(f'{k}: {err:.3g} > {atol:.3g}')
    assert not bad, '\n'.join(bad)


@pytest.mark.parametrize('net', ['depth', 'pose'])
def test_every_gradient_matches_jax(ref, port, net):
    _compare(port['grads'], ref['grads'], net,
             lambda w: GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL)


@pytest.mark.parametrize('net', ['depth', 'pose'])
def test_every_gradient_is_nonzero(port, net):
    for k, g in port['grads'].items():
        if k.startswith(f'{net}.'):
            assert np.isfinite(g).all() and np.abs(g).max() > 0, k


def _compare_update(port: dict, ref: dict, net: str) -> float:
    """-> the share of elements off by more than PARAM_ATOL."""
    bad, off, n = [], 0, 0
    for k, g in port['avg_grads'].items():
        if not k.startswith(f'{net}.'):
            continue
        err = np.abs(port['new_params'][k] - ref['new_params'][k])
        stable = np.abs(g) > 1e-3 * np.abs(g).max()
        off, n = off + int((err > PARAM_ATOL).sum()), n + err.size
        if not (err[stable].max(initial=0) <= PARAM_ATOL and err.max() <= 2 * UPDATE + PARAM_ATOL):
            bad.append(f'{k}: {err[stable].max(initial=0):.3g} where stable, {err.max():.3g} in all')
    assert not bad, '\n'.join(bad)
    return off / n


@pytest.mark.parametrize('net', ['depth', 'pose'])
def test_params_after_the_update_match_jax(ref, port, net):
    assert port['updates'] == 1
    assert sorted(port['new_params']) == sorted(ref['new_params'])
    assert _compare_update(port, ref, net) < 1e-3


def test_first_micro_step_leaves_the_params(ref, port):
    for k, v in port['after_micro_1'].items():
        np.testing.assert_array_equal(v, ref['params'][k], err_msg=k)


def test_tripwire_clean(ref, port):
    assert port['bad_step'] == ref['bad_step'] == -1


def test_slice_differential_has_teeth(ref):
    """Pose pairs in the wrong order change the loss; an LR schedule that
    counts micro-steps changes the update."""
    swapped = run_port(ref, 'pose_pairs_swapped')
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(swapped['scalars'][0]['loss'], ref['scalars'][0]['loss'],
                                   rtol=LOSS_RTOL)
    counted = run_port(ref, 'schedule_counts_micro_steps')
    with pytest.raises(AssertionError):
        _compare_update(counted, ref, 'depth')


def test_tripwire_records_the_first_bad_step():
    """A non-finite loss sets `bad_step` to that micro-step's index, on the device."""
    cfg = dict(CFG, net=dict(CFG['net'], depth=dict(CFG['net']['depth'], out_scales=[0])))
    trainer = MonoDepthTrainer(cfg)
    opt = parsers.make_optimizer(cfg, trainer.nets, accumulate=2)
    step = trainer.make_step_fn(SUPP, opt)
    x, y = (jax.tree.map(torch.from_numpy, b) for b in make_batch(3))
    gen = torch.Generator().manual_seed(0)
    step(x, y, gen)
    y = dict(y, imgs=y['imgs'].clone())
    y['imgs'][0, 5, 5, 0] = float('nan')
    step(x, y, gen)
    step(x, y, gen)
    assert trainer.bad_step.item() == 1 and trainer.step_count.item() == 3
