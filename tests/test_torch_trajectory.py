"""A loss trajectory of the port's KBR training against the JAX package's.

The KBR family (`cfg/kbr/default.yaml`'s wiring: convnext_atto depth and pose
nets with learned intrinsics, 4 scales, min-reprojection + automask,
edge-aware smoothness, AdamW with the decay mask under LinearLR x StepLR,
accumulate 2) at B=2, 64x96: both sides start from one set of seeded weights
(`models.seeded_state_dict`, carried into JAX by `convert_reference_ckpt`) and
take `N_UPDATES` optimizer updates over the same sequence of batches (a new
pair of random images every micro-step, supports shifted by +-2 px), each
micro-step's automask noise JAX's draw from its key. `steps_per_epoch=2`, so
the warm-up's LR moves every second update. The JAX side runs one jit of its
step (its XLA paths); the port runs on the CPU (plain versions behind its
autograd Functions). Where `tests/test_torch_train_step.py` holds one update
tensor by tensor, this holds the composition over many: the loss of every
micro-step.

Tolerance, on each micro-step's loss: rtol 1e-5 up to the second update
(measured: under 1.6e-6), then 1e-3. AdamW's updates are about
lr * sign(g), so a parameter whose averaged gradient is near zero takes a
float32 coin toss on each side (`test_torch_train_step.py`), and the
trajectories drift apart: measured 1.3e-5 at micro-step 6, 9.7e-5 at 13,
4.0e-4 at 14. Teeth: the schedule counting micro-steps instead of updates
fails (off by 7e-3 to 0.7 from micro-step 4 on).

The same wiring with `optimizer.backbone_lr` (1e-5 for every parameter under
an `encoder`, 1e-4 for the rest, weight decay on all of them: the
reference's explicit groups bypass timm's bias/norm filter) is held the same
way; its teeth: the two groups' LRs swapped.
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
from slowtv_monodepth_tpu_torch.models import seeded_state_dict
from torch_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 64, 96
SUPP = (-1, 1)
N_SCALES = 4
N_UPDATES, ACCUMULATE, STEPS_PER_EPOCH = 8, 2, 2
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
BLR_CFG = {**CFG, 'optimizer': {**CFG['optimizer'], 'backbone_lr': 1e-5}}
EARLY_MICRO_STEPS, EARLY_RTOL = 2 * ACCUMULATE, 1e-5
LOSS_RTOL = 1e-3


def make_batch(i: int) -> tuple[dict, dict]:
    imgs = np.random.RandomState(100 + i).rand(B, H, W, 3).astype(np.float32)
    supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
    K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    x = {'imgs': imgs, 'supp_imgs': supp}
    return x, dict(x, K=np.ascontiguousarray(np.broadcast_to(K, (B, 4, 4))))


def key(i: int):
    return jax.random.PRNGKey(1000 + i)


def jax_noise(i: int) -> np.ndarray:
    """The automask noise `JaxTrainer.loss_fn` draws from micro-step i's key."""
    _, rng_loss = jax.random.split(key(i))
    rng_recon = jax.random.split(rng_loss, len(CFG['loss']))[0]  # img_recon is first
    return np.asarray(jax.random.normal(rng_recon, (N_SCALES * B, H, W, 1)))


@pytest.fixture(scope='module')
def weights() -> dict:
    nets = MonoDepthTrainer(CFG).nets
    return {f'nets.{k}.{kk}': v for k in nets for kk, v in seeded_state_dict(nets[k], 0).items()}


def jax_run(weights: dict, cfg: dict) -> list:
    params, _ = convert_reference_ckpt(weights, cfg)
    tx = jparsers.make_optimizer(cfg, steps_per_epoch=STEPS_PER_EPOCH, accumulate=ACCUMULATE)
    step = jax.jit(JaxTrainer(cfg).make_step_fn(SUPP, tx))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       aux={'depth': {}, 'pose': {}},  # the step's own: one compile
                       opt_state=tx.init(params), bad_step=jnp.asarray(-1, jnp.int32))
    losses = []
    for i in range(N_UPDATES * ACCUMULATE):
        x, y = jax.tree.map(jnp.asarray, make_batch(i))
        state, scalars = step(state, x, y, key(i))
        losses.append(float(scalars['loss']))
    return losses


@pytest.fixture(scope='module')
def jax_losses(weights) -> list:
    return jax_run(weights, CFG)


@pytest.fixture(scope='module')
def jax_losses_backbone_lr(weights) -> list:
    return jax_run(weights, BLR_CFG)


def port_losses(weights: dict, fault=None, cfg: dict = CFG) -> list:
    trainer = MonoDepthTrainer(cfg)
    for name, net in trainer.nets.items():
        net.load_state_dict({k[len(name) + 6:]: torch.from_numpy(v) for k, v in weights.items()
                             if k.startswith(f'nets.{name}.')})
    opt = parsers.make_optimizer(cfg, trainer.nets, steps_per_epoch=STEPS_PER_EPOCH,
                                 accumulate=ACCUMULATE)
    if fault == 'schedule_counts_micro_steps':
        opt.lrs = lambda: [lr * opt.sched(opt.updates * 2 + opt.micro - 1) for lr in opt.base_lrs]
    if fault == 'backbone_lr_swapped':
        assert len(opt.base_lrs) == 2
        opt.base_lrs = opt.base_lrs[::-1]
    step = trainer.make_step_fn(SUPP, opt)
    losses = []
    for i in range(N_UPDATES * ACCUMULATE):
        x, y = (jax.tree.map(torch.from_numpy, b) for b in make_batch(i))
        losses.append(step(x, y, noise=torch.from_numpy(jax_noise(i)))['loss'].item())
    assert opt.updates == N_UPDATES and trainer.bad_step.item() == -1
    return losses


def _faults(got: list, want: list) -> list:
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(np.array(want))
    return [f'micro-step {i}: {got[i]:.7f} vs {want[i]:.7f} (rel {r:.2e})'
            for i, r in enumerate(rel)
            if not r <= (EARLY_RTOL if i < EARLY_MICRO_STEPS else LOSS_RTOL)]


def test_loss_trajectory_matches_jax(weights, jax_losses):
    got = port_losses(weights)
    assert _faults(got, jax_losses) == []
    assert got[-1] != got[0]  # it trained


def test_trajectory_differential_has_teeth(weights, jax_losses):
    assert _faults(port_losses(weights, 'schedule_counts_micro_steps'), jax_losses)


def test_backbone_lr_trajectory_matches_jax(weights, jax_losses_backbone_lr):
    got = port_losses(weights, cfg=BLR_CFG)
    assert _faults(got, jax_losses_backbone_lr) == []
    assert got[-1] != got[0]


def test_backbone_lr_differential_has_teeth(weights, jax_losses_backbone_lr):
    assert _faults(port_losses(weights, 'backbone_lr_swapped', BLR_CFG), jax_losses_backbone_lr)
