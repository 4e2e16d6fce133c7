"""The image logger (`core.heavy_logger`) against the JAX package's.

The KBR family at convnext_atto (4 scales, learned intrinsics), B=3 at
64x96, seeded weights carried into JAX by `convert_reference_ckpt` (as
`tests/test_torch_train_step.py`), one batch with a depth target and
metadata, recording writers on both sides (as `tests/test_heavy_logger.py`).
The port is handed the automask noise the JAX rerun drew from
`PRNGKey(epoch)`, so ties break the same way. Both must write the same tags
and the same text. The grids:
- of the batch itself (inputs, the lidar depth): bitwise;
- of the nets' outputs (features, the disparity's and the images' gradients)
  within 1e-5: float32 nets through ~20 residual blocks agree to ~1e-6;
- the warped supports within 1e-4 (`WARP_ATOL`: the reason is there);
- the colormapped ones where both sides' pixels fall in one of the map's 256
  bins: a value within ~1e-6 of a bin edge may take the next colour, so at
  most 1e-3 of the pixels may sit in a neighbouring bin; the automask
  likewise may differ in 1e-3 of its pixels (a float32 tie).
Teeth: the finest disparity's logit off by 1e-2 fails.

Also on seeded input, bitwise: `rgb_from_feat`, `make_grid` and
`rgb_from_disp` against the JAX package's, and the port's 'turbo' table
against matplotlib's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.core import HeavyLogger as JaxHeavyLogger
from slowtv_monodepth_tpu.core import make_grid as jax_make_grid
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.core.trainer import TrainState
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu.tools import rgb_from_disp as jax_rgb_from_disp
from slowtv_monodepth_tpu.tools import rgb_from_feat as jax_rgb_from_feat
from slowtv_monodepth_tpu_torch.core.heavy_logger import HeavyLogger, make_grid
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.models import seeded_state_dict
from slowtv_monodepth_tpu_torch.tools import viz
from torch_threads import two_torch_threads  # noqa: F401

B, H, W = 3, 64, 96
SUPP = (-1, 1)
N_SCALES = 4
EPOCH = 2
CFG = {
    'net': {'depth': {'enc_name': 'convnext_atto', 'pretrained': False, 'dec_name': 'monodepth',
                      'out_scales': [0, 1, 2, 3]},
            'pose': {'enc_name': 'convnext_atto', 'pretrained': False, 'learn_K': True}},
    'loss': {'img_recon': {'weight': 1, 'use_min': True, 'use_automask': True},
             'disp_smooth': {'weight': 0.001, 'use_edges': True}},
    'trainer': {'min_depth': 0.1, 'max_depth': 100, 'always_fwd_pose': False},
}
GRID_ATOL = 1e-5
# The warped supports: coordinates from the two sides' depths and poses agree
# to ~1e-5 px, and these noise images change by up to ~1 per px (2.9e-5 measured).
WARP_ATOL = 1e-4
# Booleans and colormap bins: the share of pixels a float32 tie may flip.
FLIP_SHARE = 1e-3
# The colormapped grids: value (normalized to the map) -> bin of 256.
CMAPPED = ('pred/disp', 'depth/lidar', 'loss/disp_grad', 'loss/image_grad')


class Writer:
    def __init__(self):
        self.images, self.texts = {}, {}

    def add_images(self, tag, v, global_step):
        assert global_step == EPOCH
        self.images[tag] = np.asarray(v)

    def add_text(self, tag, v, global_step):
        self.texts[tag] = v


def make_batch():
    from slowtv_monodepth_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    rs = np.random.RandomState(4)
    imgs = rs.rand(B, H, W, 3).astype(np.float32)
    supp = np.stack([np.roll(imgs, 2, axis=2), np.roll(imgs, -2, axis=2)])
    K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    depth = np.where(rs.rand(B, H, W, 1) < 0.3, 1 + 79 * rs.rand(B, H, W, 1), 0).astype(np.float32)
    std = lambda a: ((a - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)  # noqa: E731
    x = {'imgs': std(imgs), 'supp_imgs': std(supp)}
    y = {'imgs': imgs, 'supp_imgs': supp, 'K': np.ascontiguousarray(np.broadcast_to(K, (B, 4, 4))),
         'depth': depth}
    m = {'items': ['0', '7', '3'], 'items_original': ['10', '11', '12'], 'supp': ['1', '1', '1'],
         'errors': ['', '', ''], 'augs': ['[Photo]', '', '[Flip]']}
    return x, y, m


def seeded_weights() -> dict:
    nets = MonoDepthTrainer(CFG).nets
    return {f'nets.{k}.{kk}': v for k in nets for kk, v in seeded_state_dict(nets[k], 0).items()}


def _log_port(weights: dict, batch, noise: np.ndarray, fault=None) -> Writer:
    trainer = MonoDepthTrainer(CFG)
    for name, net in trainer.nets.items():
        net.load_state_dict({k[len(name) + 6:]: torch.from_numpy(v) for k, v in weights.items()
                             if k.startswith(f'nets.{name}.')})
    if fault == 'disp_head_bias':  # the finest disparity's logit off by 1e-2
        with torch.no_grad():
            trainer.nets['depth'].decoders['disp'].decoder[-4].bias += 1e-2
    x, y, m = batch
    writer = Writer()
    HeavyLogger(n_imgs=6, n_cols=2).log_step(
        trainer, ({k: torch.from_numpy(v) for k, v in x.items()},
                  {k: torch.from_numpy(v) for k, v in y.items()}, m),
        SUPP, writer, EPOCH, noise=torch.from_numpy(noise.copy()))
    return writer


@pytest.fixture(scope='module')
def logged():
    weights = seeded_weights()
    batch = make_batch()
    x, y, m = batch

    params, _ = convert_reference_ckpt(weights, CFG)
    jtrainer = JaxTrainer(CFG)
    # One jit of the rerun (op by op, its first call takes ~50 s on the CPU).
    jtrainer.loss_fn = jax.jit(jtrainer.loss_fn, static_argnames=('supp_idxs', 'train'))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, aux={}, opt_state=None,
                       bad_step=jnp.asarray(-1, jnp.int32))
    jwriter = Writer()
    jbatch = (jax.tree.map(jnp.asarray, x), jax.tree.map(jnp.asarray, y), m)
    JaxHeavyLogger(n_imgs=6, n_cols=2).log_step(jtrainer, state, jbatch, SUPP, jwriter, EPOCH)
    _, rng_loss = jax.random.split(jax.random.PRNGKey(EPOCH))
    rng_recon = jax.random.split(rng_loss, len(CFG['loss']))[0]  # img_recon is first
    noise = np.asarray(jax.random.normal(rng_recon, (N_SCALES * B, H, W, 1)))
    return {'weights': weights, 'batch': batch, 'noise': noise, 'jax': jwriter,
            'port': _log_port(weights, batch, noise)}


def test_tags_and_text_match_jax(logged):
    want, got = logged['jax'], logged['port']
    assert sorted(got.images) == sorted(want.images)
    assert {'train_imgs_aug/target', 'train_imgs/supp_1', 'train_pred/disp', 'train_pred/feats',
            'train_loss/warp_-1', 'train_loss/automask', 'train_depth/lidar',
            'train_loss/disp_grad', 'train_loss/image_grad'} <= set(got.images)
    assert got.texts == want.texts and 'train_augs' in got.texts


def _bins(grid: np.ndarray) -> np.ndarray:
    """A turbo grid -> the index of the colour of each pixel (the map's rows are distinct)."""
    lut = viz._turbo()[:256].astype(np.float32)
    rgb = grid[0].transpose(1, 2, 0).reshape(-1, 3)
    d = np.abs(rgb[:, None] - lut[None]).sum(-1)
    return d.argmin(-1).reshape(grid.shape[2:])


def _grid_faults(got: Writer, want: Writer) -> list:
    bad = []
    for tag, w in want.images.items():
        g, kind = got.images[tag], tag.split('_', 1)[1]
        assert g.shape == w.shape and g.shape[:2] == (1, 3) and np.isfinite(g).all(), tag
        if kind.startswith(('imgs', 'depth/')):  # the batch itself through the same numpy
            if not np.array_equal(g, w):
                bad.append(f'{tag}: not bitwise')
            continue
        if kind == 'loss/automask':
            if (g != w).mean() > FLIP_SHARE:
                bad.append(f'{tag}: {(g != w).any(axis=(0, 1)).sum()} pixels differ')
            continue
        same = np.ones(g.shape[2:], bool)
        if kind in CMAPPED:
            bg, bw = _bins(g), _bins(w)
            same = bg == bw
            if np.abs(bg - bw).max() > 1 or (~same).mean() > FLIP_SHARE:
                bad.append(f'{tag}: {(~same).sum()} pixels in other bins')
        atol = WARP_ATOL if kind.startswith('loss/warp') else GRID_ATOL
        err = float(np.abs(g - w).max(axis=(0, 1))[same].max())
        if not err <= atol:
            bad.append(f'{tag}: {err:.3g} > {atol:.0e}')
    return bad


def test_grids_match_jax(logged):
    assert _grid_faults(logged['port'], logged['jax']) == []


def test_grid_comparison_has_teeth(logged):
    """The finest disparity's logit off by 1e-2 shows."""
    got = _log_port(logged['weights'], logged['batch'], logged['noise'], 'disp_head_bias')
    assert any(f.startswith('train_pred/disp') for f in _grid_faults(got, logged['jax']))


def test_rgb_from_feat_and_make_grid_match_jax_bitwise():
    rs = np.random.RandomState(1)
    feat = rs.standard_normal((3, 8, 12, 20)).astype(np.float32)
    np.testing.assert_array_equal(viz.rgb_from_feat(feat), jax_rgb_from_feat(feat))
    np.testing.assert_array_equal(viz.rgb_from_feat(feat[0]), jax_rgb_from_feat(feat[0]))
    for imgs, kw in ((rs.rand(5, 8, 6, 3), {'n': 4, 'n_cols': 2}), (rs.rand(3, 8, 6, 1), {}),
                     (rs.rand(2, 8, 6), {'n_cols': 3})):
        np.testing.assert_array_equal(make_grid(imgs, **kw), jax_make_grid(imgs, **kw))


def test_turbo_table_is_matplotlibs_bitwise():
    import matplotlib
    rs = np.random.RandomState(2)
    x = (rs.rand(40, 50) * 1.4 - 0.2).astype(np.float32)
    x[0, :4] = [0.0, 1.0, np.nan, 255.5 / 256]
    xn = np.clip(x, 0, 1)
    want = matplotlib.colormaps['turbo'](xn)[..., :3].astype(np.float32)
    got = viz._lookup(xn, viz._turbo()).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    disp = rs.rand(2, 16, 24).astype(np.float32)
    np.testing.assert_array_equal(viz.rgb_from_disp(disp), jax_rgb_from_disp(disp))
    np.testing.assert_array_equal(viz.rgb_from_disp(disp, invert=True, vmax=2.0),
                                  jax_rgb_from_disp(disp, invert=True, vmax=2.0))
