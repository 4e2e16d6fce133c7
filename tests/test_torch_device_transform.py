"""Port differential: on-device input derivation (`core.device_transform`).

The cases of `tests/test_device_transform.py`, held against the JAX module
AND the host numpy pipeline both packages share:
- a sampled (order, factors) jiggle replayed on a (target + supports) stack
  equals the JAX `derive_x` and `ColorJiggle.apply` + standardization;
- a `device_transform` dataset's shipped batch derives to the host dataset's
  `x` (with and without augmentation; items whose jiggle did not fire pass
  through untouched);
- `transfer_uint8` batches widen to the host's float32 images.

Tolerances: atol 2e-5 + rtol 1e-5 against the host pipeline, the JAX test's
own (float32 reductions in another order, values up to ~2.6 after
standardization); against the JAX module atol 2e-5.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.core.device_transform import derive_x as jax_derive_x
from slowtv_monodepth_tpu_torch import paths
from slowtv_monodepth_tpu_torch.core.device_transform import derive_batch, derive_x, needs_derive
from slowtv_monodepth_tpu_torch.data import SlowTvDataset
from slowtv_monodepth_tpu_torch.data.augment import PHOTO_OP_IDS, ColorJiggle
from slowtv_monodepth_tpu_torch.data.base_mde import IMAGENET_MEAN, IMAGENET_STD
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture
def slowtv_root(tmp_path):
    from PIL import Image
    root = tmp_path / 'slow_tv'
    seq = '00001'
    for stem in range(5):
        p = root / seq / f'{stem:010}.png'
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.random.default_rng(stem).integers(
            0, 255, (48, 64, 3), dtype=np.uint8)).save(p)
    np.savetxt(root / seq / 'intrinsics.txt',
               np.array([[600, 0, 640, 0], [0, 600, 360, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]))
    (root / 'splits' / 'all').mkdir(parents=True)
    (root / 'splits' / 'all' / 'train_files.txt').write_text(f'{seq} 1\n{seq} 2\n{seq} 3\n')
    (root / 'splits' / 'categories.txt').write_text('natural-hiking\n')
    paths.DATA_PATHS['slow_tv'] = root
    yield root
    paths.DATA_PATHS.pop('slow_tv', None)


def _t(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _replay_inputs(seed):
    imgs = np.random.default_rng(7).random((3, 16, 24, 3), dtype=np.float32)
    ops = ColorJiggle(rng=random.Random(seed)).sample()
    x = {'photo_order': np.array([[PHOTO_OP_IDS[f] for f, _ in ops]], np.int32),
         'photo_factors': np.array([[v for _, v in ops]], np.float32),
         'photo_on': np.array([True])}
    return imgs, ops, x, {'imgs': imgs[None, 0], 'supp_imgs': imgs[1:, None]}


def _stack(out: dict) -> np.ndarray:
    return np.concatenate([np.asarray(out['imgs'])[None], np.asarray(out['supp_imgs'])], 0)[:, 0]


@pytest.mark.parametrize('seed', range(6))
def test_jiggle_replay_matches_host_and_jax(seed):
    imgs, ops, x, y = _replay_inputs(seed)
    got = derive_x(x, _t(y))  # the jiggle parameters stay numpy, as `_place` leaves them
    want_host = (ColorJiggle.apply(imgs, ops) - IMAGENET_MEAN) / IMAGENET_STD
    want_jax = jax_derive_x({k: jnp.asarray(v) for k, v in x.items()},
                            {k: jnp.asarray(v) for k, v in y.items()})
    got = _stack({k: v.numpy() for k, v in got.items()})
    np.testing.assert_allclose(got, want_host, **TOL)
    np.testing.assert_allclose(got, _stack(want_jax), atol=2e-5)


def test_jiggle_parameters_may_be_tensors():
    imgs, ops, x, y = _replay_inputs(0)
    a, b = derive_x(x, _t(y)), derive_x(_t(x), _t(y))
    assert torch.equal(a['imgs'], b['imgs']) and torch.equal(a['supp_imgs'], b['supp_imgs'])


def test_replay_has_teeth():
    """The contrast mean taken per frame instead of over the item's stack fails."""
    from slowtv_monodepth_tpu_torch.core import device_transform as dt
    imgs, ops, x, y = _replay_inputs(1)
    want = (ColorJiggle.apply(imgs, ops) - IMAGENET_MEAN) / IMAGENET_STD

    def per_frame_contrast(img, factor):
        mean = dt._gray(img).mean((-1, -2), keepdim=True)[..., None]
        return torch.clamp((img - mean) * factor + mean, 0, 1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dt, '_OPS', (dt._brightness, per_frame_contrast, dt._saturation, dt._hue))
        got = _stack({k: v.numpy() for k, v in derive_x(x, _t(y)).items()})
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)


def _batch(ds, items, seed):
    out = []
    for k, it in enumerate(items):
        random.seed(seed + k)  # aligns the flip/photo draws across the two modes
        out.append(ds[it])
    return ds.collate_fn(out)


@pytest.mark.parametrize('use_aug', [True, False])
def test_dataset_device_transform_parity(slowtv_root, use_aug):
    kw = dict(split='all', mode='train', datum='image support K', supp_idxs=[-1, 1],
              shape=(48, 64), use_aug=use_aug, randomize=False)
    host = SlowTvDataset(**kw)
    dev = SlowTvDataset(device_transform=True, **kw)
    xh, yh, _ = _batch(host, [0, 1, 2], seed=123)
    xd, yd, _ = _batch(dev, [0, 1, 2], seed=123)

    assert 'imgs' not in xd and needs_derive(xd)
    np.testing.assert_array_equal(yh['imgs'], yd['imgs'])
    np.testing.assert_array_equal(yh['supp_imgs'], yd['supp_imgs'])
    if use_aug:
        assert xd['photo_on'].any() and not xd['photo_on'].all()  # both branches run

    got = derive_x(xd, _t({'imgs': yd['imgs'], 'supp_imgs': yd['supp_imgs']}))
    assert 'photo_order' not in got
    np.testing.assert_allclose(got['imgs'].numpy(), xh['imgs'], **TOL)
    np.testing.assert_allclose(got['supp_imgs'].numpy(), xh['supp_imgs'], **TOL)


def test_transfer_uint8_widens_to_the_host_images(slowtv_root):
    kw = dict(split='all', mode='train', datum='image support K', supp_idxs=[-1, 1],
              shape=(48, 64), use_aug=True, randomize=False)
    host = SlowTvDataset(**kw)
    dev = SlowTvDataset(device_transform=True, transfer_uint8=True, **kw)
    xh, yh, _ = _batch(host, [0, 1, 2], seed=321)
    xd, yd, _ = _batch(dev, [0, 1, 2], seed=321)
    assert yd['imgs'].dtype == np.uint8 and yd['supp_imgs'].dtype == np.uint8

    xd.pop('supp_idxs')
    got_x, got_y = derive_batch(xd, _t({k: yd[k] for k in ('imgs', 'supp_imgs', 'K')}))
    np.testing.assert_allclose(got_y['imgs'].numpy(), yh['imgs'], rtol=2e-7)
    np.testing.assert_allclose(got_y['supp_imgs'].numpy(), yh['supp_imgs'], rtol=2e-7)
    np.testing.assert_array_equal(got_y['K'].numpy(), yh['K'])
    np.testing.assert_allclose(got_x['imgs'].numpy(), xh['imgs'], **TOL)
    with pytest.raises(ValueError):
        SlowTvDataset(transfer_uint8=True, **kw)  # requires device_transform


def test_loop_derives_before_ar_aug(slowtv_root):
    """`MonoDepthLoop._place` recreates x on the device for a shipped batch."""
    from slowtv_monodepth_tpu_torch.core.loop import MonoDepthLoop
    loop = MonoDepthLoop.__new__(MonoDepthLoop)
    loop.device = torch.device('cpu')
    ds = SlowTvDataset(split='all', mode='train', datum='image support K', supp_idxs=[-1, 1],
                       shape=(48, 64), use_aug=True, randomize=False, device_transform=True)
    x, y, m = ds.collate_fn([ds[0], ds[1]])
    xb, yb = loop._place(x, y)
    assert 'imgs' in xb and xb['imgs'].shape == yb['imgs'].shape
    assert 'photo_order' not in xb and 'supp_idxs' not in xb
    assert xb['supp_imgs'].shape == yb['supp_imgs'].shape == (2, 2, 48, 64, 3)
    # Standardized: far outside the raw [0, 1] band.
    assert float(xb['imgs'].min()) < -0.5 and float(xb['imgs'].max()) > 1.5
    assert 0.0 <= float(yb['imgs'].min()) and float(yb['imgs'].max()) <= 1.0
