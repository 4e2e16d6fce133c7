"""The training run of the port (`core.loop.MonoDepthLoop`).

1. The loop on a SlowTV-style PNG tree through `parsers.get_dl`, as
   `tests/test_loop.py` drives the JAX loop: fit -> markers, last/best
   checkpoints, scalars logged, refusal of a second run, resume at the next
   epoch with the update count continued, the `last` checkpoint served.
2. The slice as a whole against the JAX package: both sides start from ONE
   mid-run `TrainState` (seeded weights, non-zero AdamW moments, two updates
   done, one micro-step accumulated), carried into the port by
   `train_state_from_jax`; the port's loop then trains six micro-steps (three
   accumulated updates) with aspect-ratio augmentation on, and the JAX side
   runs the same host batches through its own `aspect_ratio_aug` and
   `make_step_fn` with the random streams of its loop
   (`core/loop.py:359-374`). The step seeds the port draws must be the JAX
   loop's, the bucket shapes must agree, and the losses must agree.
   JAX runs on its XLA paths (the kernels' modules have differentials of
   their own), one `jax.jit` per bucket shape; the automask noise of each
   step is JAX's draw from that step's key, handed to the port.

Tolerances: losses rtol 1e-4 (float32, ~20 residual blocks, sums in another
order; the later losses also carry three AdamW updates at lr 5e-4..1e-3);
parameters after the run atol 2e-5, 2% of one update.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu_torch import paths
from slowtv_monodepth_tpu_torch.core import (BenchmarkPredictor, MonoDepthLoop, load_checkpoint,
                                             train_state_from_jax)
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

NET = {'depth': {'enc_name': 'convnext_atto', 'pretrained': False, 'dec_name': 'monodepth',
                 'out_scales': [0, 1]},
       'pose': {'enc_name': 'convnext_atto', 'pretrained': False, 'learn_K': True}}
LOSS = {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
        'disp_smooth': {'weight': 0.001, 'use_edges': True}}


# ---------------------------------------------------------------- 1. the PNG tree
@pytest.fixture
def slowtv_root(tmp_path):
    """The tree of tests/test_loop.py:11-31."""
    from PIL import Image
    root = tmp_path / 'slow_tv'
    seq = '00001'
    for stem in range(12):
        p = root / seq / f'{stem:010}.png'
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.random.default_rng(stem).integers(
            0, 255, (48, 64, 3), dtype=np.uint8)).save(p)
    np.savetxt(root / seq / 'intrinsics.txt',
               np.array([[600, 0, 640, 0], [0, 600, 360, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]))
    (root / 'splits' / 'all').mkdir(parents=True)
    (root / 'splits' / 'all' / 'train_files.txt').write_text(
        '\n'.join(f'{seq} {i}' for i in range(2, 8)))
    (root / 'splits' / 'all' / 'val_files.txt').write_text(
        '\n'.join(f'{seq} {i}' for i in range(8, 10)))
    (root / 'splits' / 'categories.txt').write_text('natural-hiking\n')
    paths.DATA_PATHS['slow_tv'] = root
    yield root
    paths.DATA_PATHS.pop('slow_tv', None)


def make_cfg(max_epochs=2, use_aug=True, **trainer):
    return {
        'net': NET, 'loss': LOSS,
        'dataset': {'slow_tv': {
            'split': 'all', 'datum': 'image support K', 'supp_idxs': [-1, 1],
            'device_transform': True,
            'train': {'mode': 'train', 'use_aug': use_aug, 'shape': [64, 96]},
            'val': {'mode': 'val', 'use_aug': False, 'shape': [64, 96]}}},
        'loader': {'batch_size': 2, 'drop_last': True, 'num_workers': 0,
                   'train': {'shuffle': True}, 'val': {'shuffle': False}},
        'optimizer': {'type': 'adamw', 'lr': 1e-4, 'weight_decay': 1e-3},
        'scheduler': {'linear': {'start_factor': 0.5, 'total_iters': 2}},
        'trainer': {'max_epochs': max_epochs, 'min_depth': 0.1, 'max_depth': 100,
                    'always_fwd_pose': False, 'monitor': 'loss', 'log_every_n_steps': 1,
                    'accumulate_grad_batches': 2, 'matmul': 'highest', **trainer}}


class _Writer:
    def __init__(self):
        self.logged = []

    def add_scalar(self, tag, val, step):
        self.logged.append((tag, val, step))


def test_fit_checkpoints_markers_and_serving(slowtv_root, tmp_path):
    ckpt_dir = tmp_path / 'run'
    writer = _Writer()
    loop = MonoDepthLoop(make_cfg(), ckpt_dir, device='cpu', writer=writer)
    loop.fit()

    assert (ckpt_dir / 'last.ckpt').is_file() and (ckpt_dir / 'best.ckpt').is_file()
    assert (ckpt_dir / 'finished').is_file()
    assert not list(ckpt_dir.glob('training_*'))
    assert any(t.startswith('train_losses/') for t, _, _ in writer.logged)
    assert any(t.startswith('val_') for t, _, _ in writer.logged)
    # 2 epochs x 3 batches, accumulate 2: an update pends across the epoch boundary.
    assert loop.global_step == 6 and loop.opt.updates == 3 and loop.opt.micro == 0
    assert int(loop.trainer.bad_step) == -1

    ckpt = torch.load(ckpt_dir / 'last.ckpt', map_location='cpu', weights_only=False)
    assert ckpt['epoch'] == 1 and ckpt['global_step'] == 6
    sd, cfg = load_checkpoint(ckpt_dir / 'last.ckpt')
    assert cfg['net']['depth']['enc_name'] == 'convnext_atto'
    net = BenchmarkPredictor('cpu').load_model(ckpt_dir / 'last.ckpt')
    disp = net(torch.rand(1, 3, 64, 96))['disp'][0]
    assert disp.shape == (1, 1, 64, 96) and torch.isfinite(disp).all()


def test_refuses_double_run(slowtv_root, tmp_path):
    ckpt_dir = tmp_path / 'run'
    ckpt_dir.mkdir()
    (ckpt_dir / 'finished').touch()
    with pytest.raises(ValueError, match='finished'):
        MonoDepthLoop(make_cfg(), ckpt_dir, device='cpu')
    (ckpt_dir / 'finished').unlink()
    (ckpt_dir / 'training_0_host').touch()
    with pytest.raises(ValueError, match='in progress'):
        MonoDepthLoop(make_cfg(), ckpt_dir, device='cpu')


def test_resume_skips_epochs_and_continues_the_update_count(slowtv_root, tmp_path):
    """One epoch of three micro-steps leaves one gradient accumulated; the
    resumed run finishes that update first, so after two epochs the counts
    and the weights are those of an uninterrupted two-epoch run. (Without the
    host augmentations: they draw from Python's global generator, whose state
    a second process would not share either.)"""
    ckpt_dir = tmp_path / 'run'
    loop = MonoDepthLoop(make_cfg(max_epochs=1, use_aug=False), ckpt_dir, device='cpu')
    loop.fit()
    assert (loop.global_step, loop.opt.updates, loop.opt.micro) == (3, 1, 1)

    (ckpt_dir / 'finished').unlink()
    loop2 = MonoDepthLoop(make_cfg(max_epochs=2, use_aug=False), ckpt_dir, device='cpu')
    assert loop2.opt.updates == 0
    loop2.fit()
    assert loop2.start_epoch == 1
    assert (loop2.global_step, loop2.opt.updates, loop2.opt.micro) == (6, 3, 0)
    assert loop2.ckpt.best is not None

    straight = MonoDepthLoop(make_cfg(max_epochs=2, use_aug=False), tmp_path / 'straight',
                             device='cpu')
    straight.fit()
    for (k, p), q in zip(loop2.trainer.nets.named_parameters(),
                         straight.trainer.nets.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6, err_msg=k)


def test_a_failed_epoch_removes_its_marker(slowtv_root, tmp_path):
    loop = MonoDepthLoop(make_cfg(), tmp_path / 'run', device='cpu')
    loop.trainer.nets['depth'].decoders['disp'].get_parameter('decoder.0.conv.weight').data.fill_(
        float('nan'))
    with pytest.raises(ValueError, match='NaN'):
        loop.fit()
    assert not list((tmp_path / 'run').glob('training_*'))
    assert not (tmp_path / 'run' / 'finished').exists()


class _ImageWriter(_Writer):
    def __init__(self):
        super().__init__()
        self.images, self.texts = {}, {}

    def add_images(self, tag, v, global_step):
        self.images[tag] = (v.shape, global_step)

    def add_text(self, tag, v, global_step):
        self.texts[tag] = v


@pytest.mark.parametrize('kw,item', [
    ({'mesh': object()}, 'item 11'), ({'heavy_logger': 'accepted'}, None),
    ({'trainer': {'zero': 1}}, 'item 11'), ({'trainer': {'profile_dir': 'x'}}, 'item 12'),
    ({'trainer': {'precision': 16}}, 'Recipe'), ({'trainer': {'remat': True}}, 'Recipe')])
def test_unported_options_raise(slowtv_root, tmp_path, kw, item):
    """Each unported option raises naming its ROADMAP item; the image logger
    (ported in A7b) is accepted and logs each epoch's last batch."""
    kw = dict(kw)
    cfg = make_cfg(**kw.pop('trainer', {}))
    if item is None:
        from slowtv_monodepth_tpu_torch.core import HeavyLogger
        writer = _ImageWriter()
        MonoDepthLoop(make_cfg(max_epochs=1), tmp_path / 'run', device='cpu', writer=writer,
                      heavy_logger=HeavyLogger(n_imgs=2, n_cols=2)).fit()
        assert writer.images['train_pred/disp'] == ((1, 3, 64, 192), 0)
        assert {'train_imgs_aug/target', 'train_loss/warp_1', 'train_loss/automask'} <= set(writer.images)
        assert 'train_items' in writer.texts
        return
    with pytest.raises(NotImplementedError, match=item):
        MonoDepthLoop(cfg, tmp_path / 'run', device='cpu', **kw)


def test_train_dev_runs_epochs_of_a_few_batches(slowtv_root, tmp_path, monkeypatch, caplog):
    """`slowtv-train-dev-torch` (`train_dev.main`): 2 epochs x 2 batches from a
    cfg file, the loss read at every step, into a fresh temporary directory."""
    import logging
    import tempfile

    import yaml
    from slowtv_monodepth_tpu_torch import train_dev
    cfg_file = tmp_path / 'dev.yaml'
    cfg_file.write_text(yaml.safe_dump(make_cfg(use_aug=False)))
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    with caplog.at_level(logging.INFO):
        train_dev.main(['-c', str(cfg_file), '--epochs', '2', '--batches', '2', '--device', 'cpu'])
    steps = [r.getMessage() for r in caplog.records if ': loss=' in r.getMessage()
             and r.getMessage().startswith('epoch')]
    assert [m.split(':')[0] for m in steps] == ['epoch 0 step 0', 'epoch 0 step 1',
                                                'epoch 1 step 0', 'epoch 1 step 1']
    assert len(list(tmp_path.glob('slowtv_dev_*/last.ckpt'))) == 1


def test_train_dev_raises_on_a_non_finite_loss(slowtv_root, tmp_path):
    from slowtv_monodepth_tpu_torch.train_dev import DevLoop
    loop = DevLoop(make_cfg(), tmp_path / 'dev', device='cpu', use_markers=False, limit_batches=2)
    loop.trainer.nets['depth'].decoders['disp'].get_parameter('decoder.0.conv.weight').data.fill_(
        float('nan'))
    with pytest.raises(ValueError, match='NaN/Infinite loss'):
        loop.fit()
    assert loop.global_step == 1  # raised at the step that made it


def test_early_stopping_and_swa(slowtv_root, tmp_path):
    loop = MonoDepthLoop(make_cfg(max_epochs=4, swa=True, early_stopping=1, precompile_buckets=True),
                         tmp_path / 'run', device='cpu')
    loop.ckpt.mode = 'max'  # the loss falls, so "max" never improves after epoch 0
    loop.fit()
    assert loop.global_step < 12  # stopped early
    assert (tmp_path / 'run' / 'finished').is_file()


# ------------------------------------------------- 2. the slice against the JAX package
B, H, W = 2, 128, 192
SUPP = (-1, 1)
SEED, EPOCH, N_MICRO = 37, 0, 6  # this seed's six batches fall into two buckets (two jits)
SLICE_CFG = {
    'net': NET, 'loss': LOSS, 'seed': SEED,
    'optimizer': {'type': 'adamw', 'lr': 1e-3, 'weight_decay': 1e-3},
    'scheduler': {'linear': {'start_factor': 0.5, 'total_iters': 4}},
    'trainer': {'max_epochs': 1, 'min_depth': 0.1, 'max_depth': 100, 'always_fwd_pose': False,
                'monitor': 'loss', 'accumulate_grad_batches': 2, 'matmul': 'highest',
                'aspect_ratio_aug_prob': 0.7, 'aspect_ratio_ref_shape': [H, W]}}
STEPS_PER_EPOCH = N_MICRO // 2
LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-5


def host_batches():
    """Six seeded batches as the `device_transform` SlowTV dataset ships them."""
    out = []
    for i in range(N_MICRO):
        rs = np.random.RandomState(100 + i)
        imgs = rs.rand(B, H, W, 3).astype(np.float32)
        supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
        K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        x = {'supp_idxs': np.array(SUPP), 'photo_order': np.tile(np.arange(4, dtype=np.int32), (B, 1)),
             'photo_factors': np.ones((B, 4), np.float32), 'photo_on': np.zeros(B, bool)}
        y = {'imgs': imgs, 'supp_imgs': supp, 'K': np.ascontiguousarray(np.broadcast_to(K, (B, 4, 4)))}
        out.append((x, y, {}))
    return out


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter([(dict(x), dict(y), dict(m)) for x, y, m in self.batches])


def _mid_run_state(tx, params):
    """A `TrainState` two updates into a run with one micro-step accumulated."""
    from slowtv_monodepth_tpu.core.trainer import TrainState
    rs = np.random.RandomState(9)

    def like(scale, positive=False):
        return jax.tree.map(lambda p: jnp.asarray(
            (rs.rand(*p.shape) if positive else rs.randn(*p.shape)) * scale, p.dtype), params)

    ostate = tx.init(params)
    adam, decay, sched = ostate.inner_opt_state
    two = jnp.asarray(2, jnp.int32)
    inner = (adam._replace(count=two, mu=like(1e-3), nu=like(1e-5, positive=True)), decay,
             sched._replace(count=two))
    ostate = ostate._replace(mini_step=jnp.asarray(1, jnp.int32), gradient_step=two,
                             inner_opt_state=inner, acc_grads=like(1e-3))
    return TrainState(step=jnp.asarray(5, jnp.int32), params=params, aux={}, opt_state=ostate,
                      bad_step=jnp.asarray(-1, jnp.int32))


@pytest.fixture(scope='module')
def ref():
    """The JAX package on the six batches: its loop's streams, AR-aug and step."""
    from slowtv_monodepth_tpu import parsers as jparsers
    from slowtv_monodepth_tpu.core import aspect_ratio as jar
    from slowtv_monodepth_tpu.core.device_transform import derive_batch as jderive
    from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
    from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
    from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict

    nets = MonoDepthTrainer(SLICE_CFG).nets
    weights = {f'nets.{k}.{kk}': v for k in nets for kk, v in seeded_state_dict(nets[k], 0).items()}
    params, _ = convert_reference_ckpt(weights, SLICE_CFG)
    trainer = JaxTrainer(SLICE_CFG)
    tx = jparsers.make_optimizer(SLICE_CFG, steps_per_epoch=STEPS_PER_EPOCH, accumulate=2)
    state = _mid_run_state(tx, params)
    start = jax.tree.map(np.asarray, state)
    step = jax.jit(trainer.make_step_fn(SUPP, tx))

    tcfg = SLICE_CFG['trainer']
    rng = np.random.default_rng(SEED + 1000003 * EPOCH)       # core/loop.py:360
    ar_rng = random.Random(SEED * 7919 + EPOCH)               # core/loop.py:361
    out = {'start': start, 'losses': [], 'shapes': [], 'seeds': [], 'noise': []}
    for x, y, m in host_batches():
        x = {k: jnp.asarray(v) for k, v in x.items() if k != 'supp_idxs'}
        xb, yb = jderive(x, {k: jnp.asarray(v) for k, v in y.items()})
        xb, yb, _ = jar.aspect_ratio_aug((xb, yb, {}), p=tcfg['aspect_ratio_aug_prob'],
                                         ref_shape=tcfg['aspect_ratio_ref_shape'], rng=ar_rng)
        seed = int(rng.integers(2 ** 31))                     # core/loop.py:374
        key = jax.random.PRNGKey(seed)
        state, scalars = step(state, xb, yb, key)
        h, w = xb['imgs'].shape[1:3]
        rng_recon = jax.random.split(jax.random.split(key)[1], len(LOSS))[0]
        out['noise'].append(np.asarray(jax.random.normal(
            rng_recon, (len(NET['depth']['out_scales']) * B, h, w, 1))))
        out['losses'].append(float(scalars['loss']))
        out['shapes'].append((h, w))
        out['seeds'].append(seed)
    out['end'] = jax.tree.map(np.asarray, state)
    return out


def run_port(ref, tmp_path, fault=None):
    cfg = SLICE_CFG
    if fault == 'ar_stream_seeded_otherwise':
        cfg = dict(cfg, seed=SEED + 1)
    loop = MonoDepthLoop(cfg, tmp_path / (fault or 'run'), device='cpu',
                         train_dl=ListLoader(host_batches()))
    loop.global_step = train_state_from_jax(ref['start'], loop.trainer.nets, loop.opt,
                                            NET['depth']['out_scales'])
    if fault == 'moments_dropped':
        loop.opt.opt.state.clear()
    elif fault == 'accumulator_dropped':
        for p in loop.opt.params():
            p.grad = None
    seeds, noises = [], iter(ref['noise'])
    steps = []  # (bucket shape, loss) per micro-step
    raw = loop._step_fn(SUPP, True)

    def recording(x, y, generator):
        """The loop's step on the JAX run's automask noise instead of the generator's."""
        seeds.append(generator.initial_seed())
        noise = next(noises)
        if noise.shape[1:3] != tuple(x['imgs'].shape[1:3]):  # another bucket: any noise will do
            noise = np.zeros((noise.shape[0],) + tuple(x['imgs'].shape[1:3]) + (1,), np.float32)
        out = raw(x, y, noise=torch.from_numpy(noise.copy()))
        steps.append((tuple(x['imgs'].shape[1:3]), float(out['loss'])))
        return out

    loop._steps[(SUPP, True)] = recording
    loop.fit()
    return loop, seeds, steps


def test_train_state_from_jax_carries_every_piece(ref, tmp_path):
    from slowtv_monodepth_tpu_torch.models import depth_state_dict_from_jax
    loop = MonoDepthLoop(SLICE_CFG, tmp_path / 'carry', device='cpu', use_markers=False,
                         train_dl=ListLoader(host_batches()))
    step = train_state_from_jax(ref['start'], loop.trainer.nets, loop.opt,
                                NET['depth']['out_scales'])
    assert step == 5 and loop.opt.updates == 2 and loop.opt.micro == 1
    adam = ref['start'].opt_state.inner_opt_state[0]
    for tree, get in ((ref['start'].params, lambda p: p.detach()),
                      (adam.mu, lambda p: loop.opt.opt.state[p]['exp_avg']),
                      (adam.nu, lambda p: loop.opt.opt.state[p]['exp_avg_sq']),
                      (ref['start'].opt_state.acc_grads, lambda p: p.grad)):
        want = depth_state_dict_from_jax(tree['depth'], NET['depth']['out_scales'])
        for k, p in loop.trainer.nets['depth'].named_parameters():
            np.testing.assert_array_equal(get(p).numpy(), want[k].numpy(), err_msg=k)
    assert all(float(loop.opt.opt.state[p]['step']) == 2.0 for p in loop.opt.params())
    assert loop.opt.lrs() == [pytest.approx(5e-4)] * 2  # update 2 of 3 per epoch: epoch 0


def test_three_accumulated_updates_with_ar_aug_match_jax(ref, tmp_path):
    from slowtv_monodepth_tpu_torch.models import (depth_state_dict_from_jax,
                                                   pose_state_dict_from_jax)
    loop, seeds, steps = run_port(ref, tmp_path)
    assert seeds == ref['seeds']
    assert [s for s, _ in steps] == ref['shapes']
    assert len(set(ref['shapes'])) >= 2, 'the augmentation never fired'
    assert (loop.opt.updates, loop.opt.micro, loop.global_step) == (5, 1, 11)
    end = ref['end']
    assert int(end.opt_state.gradient_step) == 5 and int(end.opt_state.mini_step) == 1
    np.testing.assert_allclose([l for _, l in steps], ref['losses'], rtol=LOSS_RTOL)
    want = {'depth': depth_state_dict_from_jax(end.params['depth'], NET['depth']['out_scales']),
            'pose': pose_state_dict_from_jax(end.params['pose'])}
    for name, net in loop.trainer.nets.items():
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name][k].numpy(),
                                       atol=PARAM_ATOL, err_msg=f'{name}.{k}')


@pytest.mark.parametrize('fault', ['ar_stream_seeded_otherwise', 'moments_dropped',
                                   'accumulator_dropped'])
def test_slice_differential_has_teeth(ref, tmp_path, fault):
    _, _, steps = run_port(ref, tmp_path, fault)
    with pytest.raises(AssertionError):
        assert [s for s, _ in steps] == ref['shapes']
        np.testing.assert_allclose([l for _, l in steps], ref['losses'], rtol=LOSS_RTOL)
