"""Loss trajectories of the port's DVSO and Depth-Hints training against the
JAX package's, and each family's first micro-step tensor by tensor.

The cfgs as they stand (`cfg/benchmark/default.yaml` + `dvso.yaml` or
`depth_hints_MS.yaml`), cut as `tests/test_torch_families.py:family_cfg`
cuts them (convnext_atto nets, the Depth-Hints pose net in place of its
ResNet-18, 2 scales), at B=2, 64x96, wired as
`tests/test_trajectory_parity.py:215-345` wires them: DVSO with no pose net, a
stereo-only support and virtual stereo; Depth-Hints with supports (-1, 1, 0),
min-reprojection + automask and log-l1 hints behind the hint automask. Both
sides start from one set of seeded weights and take N_UPDATES Adam updates
(the cfg's own optimizer and StepLR) over the same batches (new images every
micro-step, both signs of `T_stereo` in each batch), accumulating 2
micro-steps an update: optax's `MultiSteps` then holds micro-step 1's
gradient itself in its state after that micro-step, so ONE jit of the JAX
step gives the trajectory and the gradient to hold the port's to. The
automask noise is JAX's draw from each micro-step's key.

Tolerances:
- micro-step 1: every loss term rtol 1e-5, every gradient per tensor 1e-3 of
  its largest JAX magnitude plus 1e-7 (`tests/test_torch_train_step.py`).
  Depth-Hints' hint automask is a binary gate with no tie-break. Its bits
  may flip only within NET_GATE_MARGIN (1e-4) of a tie, at most 1e-3 of
  them (`test_torch_families.check_gate`, against the JAX gate re-stated
  from the JAX step's own depths with its margin; measured about 10 of 24576
  flips, at margins up to 3.4e-5, and as many between JAX's own jit and
  eager runs). A flip moves `loss_depth_regr` by ~1e-4, so that term and
  the total are held at rtol 5e-3 (the JAX package's own hints trajectory
  bound, `tests/test_trajectory_parity.py`). With flips, the pose net's
  gradients are held at 1e-2 of each tensor's largest magnitude (measured
  1.6e-3: the image automask's near-tie flips reach it), and the depth net's
  gradient as one vector within 1e-1 relative L2 (measured 3.3e-2: the
  flipped pixels' terms are a few % of sums that mostly cancel at init).
  `tests/test_torch_families.py` holds the regression behind the gate
  strictly;
- the trajectory, each micro-step's loss: rtol 1e-5 up to the second update,
  then 1e-3, as `tests/test_torch_trajectory.py` (Adam's early updates are
  about lr * sign(g), so a near-zero averaged gradient is a float32 coin
  toss on each side); 5e-3 for Depth-Hints (its gate).
Teeth: DVSO picking the virtual-stereo channel by the opposite sign of
`T_stereo`, and Depth-Hints keeping the hints that reconstruct worse, fail.
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
from slowtv_monodepth_tpu_torch.core import handlers as th
from slowtv_monodepth_tpu.core import handlers as jh
from test_torch_families import (RecordingRegression, check_gate, compare_grads, family_cfg,
                                 jax_noise, make_batch, port_layout, port_trainer,
                                 seeded_weights, supp_of)
from torch_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 64, 96
N_SCALES = 2
N_UPDATES, ACCUMULATE, STEPS_PER_EPOCH = 8, 2, 2
EARLY_MICRO_STEPS, EARLY_RTOL, LOSS_RTOL = 2 * ACCUMULATE, 1e-5, 1e-3
HINTS_RTOL, HINTS_POSE_GRAD_RTOL, HINTS_DEPTH_GRAD_L2 = 5e-3, 1e-2, 1e-1
# The depths that reach the gate come out of the nets, whose float32 outputs
# agree to ~1e-5 between the packages (and between JAX's jit and eager runs):
# the gate's bits may flip within 1e-4 of a tie (measured up to 3.4e-5).
NET_GATE_MARGIN = 1e-4
FAMILIES = ('dvso', 'depth_hints_MS')


def key(i: int):
    return jax.random.PRNGKey(1000 + i)


def batch(cfg: dict, i: int) -> tuple[dict, dict]:
    return make_batch(supp_of(cfg), hints='depth_regr' in cfg['loss'], seed=100 + i)


def noise(cfg: dict, i: int):
    """Micro-step i's automask noise, or None where the cfg has no automask."""
    if not cfg['loss']['img_recon'].get('use_automask'):
        return None
    _, rng_loss = jax.random.split(key(i))
    return torch.from_numpy(jax_noise(cfg, rng_loss, (N_SCALES * B, H, W, 1)))


@pytest.fixture(scope='module', params=FAMILIES)
def jax_run(request) -> dict:
    """The JAX package: one jit of `make_step_fn`, 2 * N_UPDATES micro-steps."""
    name = request.param
    cfg = family_cfg(name)
    weights = seeded_weights(cfg)
    params, _ = convert_reference_ckpt(weights, cfg)
    tx = jparsers.make_optimizer(cfg, steps_per_epoch=STEPS_PER_EPOCH, accumulate=ACCUMULATE)
    step = jax.jit(JaxTrainer(cfg).make_step_fn(supp_of(cfg), tx))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       aux={k: {} for k in params},  # the step's own: one compile
                       opt_state=tx.init(params), bad_step=jnp.asarray(-1, jnp.int32))
    scalars = []
    for i in range(N_UPDATES * ACCUMULATE):
        x, y = jax.tree.map(jnp.asarray, batch(cfg, i))
        state, sc = step(state, x, y, key(i))
        scalars.append({k: float(v) for k, v in sc.items()})
        if i == 0:  # MultiSteps' running mean after one micro-step: its gradient
            grads = port_layout(jax.tree.map(np.asarray, state.opt_state.acc_grads), cfg)
    return {'name': name, 'cfg': cfg, 'weights': weights, 'scalars': scalars, 'grads': grads}


def port_run(run: dict, fault=None, micro_steps=None) -> dict:
    cfg, supp = run['cfg'], supp_of(run['cfg'])
    trainer = port_trainer(cfg, run['weights'])
    opt = parsers.make_optimizer(cfg, trainer.nets, steps_per_epoch=STEPS_PER_EPOCH,
                                 accumulate=ACCUMULATE)
    step = trainer.make_step_fn(supp, opt)
    out = {'scalars': []}
    with pytest.MonkeyPatch.context() as mp:
        if fault == 'stereo_channel_flipped':
            post = trainer.forward_postprocess

            def flipped(fwd, x, y, supp_idxs):
                fwd['disp_stereo'] = {s: d.flip(-1) for s, d in fwd['disp_stereo'].items()}
                return post(fwd, x, y, supp_idxs)
            mp.setattr(trainer, 'forward_postprocess', flipped)
        if fault == 'hint_gate_reversed':
            regr = th.depth_regr
            mp.setattr(th, 'depth_regr', lambda crit, photo, *a, **kw: regr(
                crit, lambda p, t: -photo(p, t), *a, **kw))
        if 'depth_regr' in trainer.losses:  # keep the (scale-tiled) mask the regression sees
            c = trainer.losses['depth_regr']
            trainer.losses['depth_regr'] = RecordingRegression(c.loss_name, c.invert,
                                                               c.use_automask)
        for i in range(micro_steps or N_UPDATES * ACCUMULATE):
            x, y = (jax.tree.map(torch.from_numpy, b) for b in batch(cfg, i))
            out['scalars'].append({k: v.item() for k, v in step(x, y, noise=noise(cfg, i)).items()})
            if i == 0:
                out['grads'] = {f'{n}.{k}': p.grad.numpy().copy()
                                for n, net in trainer.nets.items()
                                for k, p in net.named_parameters()}
                if 'depth_regr' in trainer.losses:
                    out['hint_mask'] = trainer.losses['depth_regr'].seen.numpy()
    out['updates'], out['bad_step'] = opt.updates, trainer.bad_step.item()
    return out


def _jax_hint_gate(run: dict) -> tuple[np.ndarray, np.ndarray]:
    """Micro-step 1's full hint gate (every scale) in the JAX package, and its
    margin `photo(depth warp) - photo(hint warp)`: re-stated from the JAX
    step's own outputs (one jit of its forward), and held to the scale-0 bits
    its handler returns, near-tie flips aside."""
    cfg = run['cfg']
    params, _ = convert_reference_ckpt(run['weights'], cfg)
    x, y = jax.tree.map(jnp.asarray, batch(cfg, 0))
    trainer = JaxTrainer(cfg)
    ld, fwd = jax.jit(lambda p: trainer.loss_fn(p, {}, x, y, supp_of(cfg), key(0), True)[1][:2])(
        params)
    n_sc = len(fwd['depth_up'])
    cat = lambda a: jnp.concatenate([a] * n_sc, axis=1)  # noqa: E731
    supp_s, Ts_s = cat(y['supp_imgs']), cat(fwd['Ts'])
    Ks_s, imgs_s = jnp.concatenate([y['K']] * n_sc), jnp.concatenate([y['imgs']] * n_sc)
    depths_s = jnp.concatenate([fwd['depth_up'][s] for s in sorted(fwd['depth_up'])])
    photo = trainer.losses['img_recon'].compute_photo
    margin = np.asarray(
        photo(jh._batched_synth(supp_s, depths_s, Ts_s, Ks_s), imgs_s)
        - photo(jh._batched_synth(supp_s, jnp.concatenate([y['depth_hints']] * n_sc), Ts_s, Ks_s),
                imgs_s))
    # Even within the JAX package, this eager re-statement and the jitted step
    # disagree on bits near a tie (measured 11 of 12288): XLA fuses the chain.
    check_gate(margin[:B] > 0, np.asarray(ld['automask_hints']), margin[:B], NET_GATE_MARGIN)
    hints = np.concatenate([np.asarray(y['depth_hints'])] * n_sc)
    return (hints > 0) & (margin > 0), margin


def test_first_micro_step_matches_jax(jax_run):
    got = port_run(jax_run, micro_steps=1)
    want = jax_run['scalars'][0]
    flips = 0
    if jax_run['name'] == 'depth_hints_MS':
        gate, margin = _jax_hint_gate(jax_run)
        flips = check_gate(got['hint_mask'], gate, margin, NET_GATE_MARGIN)
    terms = sorted(k for k in want if k.startswith('loss'))
    assert terms == sorted(k for k in got['scalars'][0] if k.startswith('loss'))
    for k in terms:
        rtol = HINTS_RTOL if flips and k in ('loss', 'loss_depth_regr') else EARLY_RTOL
        np.testing.assert_allclose(got['scalars'][0][k], want[k], rtol=rtol, err_msg=k)
    if jax_run['name'] == 'dvso':
        assert {'loss_stereo_img_recon', 'loss_stereo_disp_smooth',
                'loss_stereo_const'} <= set(terms)
    if not flips:
        assert compare_grads(got['grads'], jax_run['grads']) == []
        return
    pose = {k: v for k, v in got['grads'].items() if k.startswith('pose.')}
    bad = [k for k, v in pose.items() if not np.abs(v - jax_run['grads'][k]).max()
           <= HINTS_POSE_GRAD_RTOL * np.abs(jax_run['grads'][k]).max() + 1e-7]
    assert pose and bad == []
    keys = [k for k in jax_run['grads'] if k.startswith('depth.')]
    want_g = np.concatenate([jax_run['grads'][k].ravel() for k in keys])
    diff = np.concatenate([(got['grads'][k] - jax_run['grads'][k]).ravel() for k in keys])
    assert np.linalg.norm(diff) <= HINTS_DEPTH_GRAD_L2 * np.linalg.norm(want_g)


def _faults(got: list, want: list, late_rtol: float) -> list:
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(np.array(want))
    return [f'micro-step {i}: {got[i]:.7f} vs {want[i]:.7f} (rel {r:.2e})'
            for i, r in enumerate(rel)
            if not r <= (EARLY_RTOL if i < EARLY_MICRO_STEPS else late_rtol)]


def test_loss_trajectory_matches_jax(jax_run):
    got = port_run(jax_run)
    assert got['updates'] == N_UPDATES and got['bad_step'] == -1
    want = [s['loss'] for s in jax_run['scalars']]
    losses = [s['loss'] for s in got['scalars']]
    if jax_run['name'] == 'depth_hints_MS':  # the gate: the JAX bound from the first micro-step on
        rel = np.abs(np.array(losses) - want) / np.abs(want)
        assert rel.max() <= HINTS_RTOL, rel
    else:
        assert _faults(losses, want, LOSS_RTOL) == []
    assert losses[-1] != losses[0]  # it trained


TEETH = {'dvso': 'stereo_channel_flipped', 'depth_hints_MS': 'hint_gate_reversed'}


def test_trajectory_differential_has_teeth(jax_run):
    got = port_run(jax_run, TEETH[jax_run['name']], micro_steps=2)
    want = [s['loss'] for s in jax_run['scalars'][:2]]
    rel = np.abs(np.array([s['loss'] for s in got['scalars']]) - want) / np.abs(want)
    assert rel.max() > (HINTS_RTOL if jax_run['name'] == 'depth_hints_MS' else EARLY_RTOL)
