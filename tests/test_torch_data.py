"""Port differential: the host data pipeline (`data/`, `parsers.get_dl`).

The port keeps its own copies of the JAX package's framework-free loader,
dataset bases, augmentations and SlowTV dataset. The same PNG tree goes
through both packages' `parsers.get_dl`, with Python's and numpy's global
generators seeded alike before each epoch: the batches must be IDENTICAL,
bit for bit (same files, same order, same flips, same colour jiggle, same
standardization), in the host mode and in the `device_transform` mode.
The utility copies (`config`, `tools.viz`) are held to their originals on
the same inputs as well.
"""
import random

import numpy as np
import pytest

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu import paths as jpaths
from slowtv_monodepth_tpu_torch import parsers, paths


@pytest.fixture
def slowtv_root(tmp_path):
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
        '\n'.join(f'{seq} {i}' for i in range(2, 10)))
    (root / 'splits' / 'all' / 'val_files.txt').write_text(
        '\n'.join(f'{seq} {i}' for i in range(6, 8)))
    (root / 'splits' / 'categories.txt').write_text('natural-hiking\n')
    for p in (paths, jpaths):
        p.DATA_PATHS['slow_tv'] = root
    yield root
    for p in (paths, jpaths):
        p.DATA_PATHS.pop('slow_tv', None)


def _cfg(**ds_kw):
    ds = {'slow_tv': {'split': 'all', 'datum': 'image support K', 'supp_idxs': [-1, 1],
                      'randomize_supp': True, **ds_kw,
                      'train': {'mode': 'train', 'use_aug': True, 'shape': [32, 64]},
                      'val': {'mode': 'val', 'use_aug': False}}}
    dl = {'batch_size': 2, 'drop_last': True, 'num_workers': 0, 'seed': 7,
          'train': {'shuffle': True}, 'val': {'shuffle': False}}
    return ds, dl


def _epoch(get_dl, mode, epoch, ds_kw):
    dl = get_dl(mode, *_cfg(**ds_kw))
    dl.set_epoch(epoch)
    random.seed(100 + epoch)
    np.random.seed(100 + epoch)
    return list(dl)


def _assert_identical(a, b):
    assert len(a) == len(b) > 0
    for (xa, ya, ma), (xb, yb, mb) in zip(a, b):
        for da, db in ((xa, xb), (ya, yb)):
            assert set(da) == set(db)
            for k in da:
                va, vb = np.asarray(da[k]), np.asarray(db[k])
                assert va.dtype == vb.dtype and va.shape == vb.shape, k
                np.testing.assert_array_equal(va, vb, err_msg=k)
        for k in ('items', 'augs', 'supp', 'errors'):
            assert ma.get(k) == mb.get(k), k


@pytest.mark.parametrize('mode,epoch', [('train', 0), ('train', 3), ('val', 0)])
@pytest.mark.parametrize('ds_kw', [{}, {'device_transform': True},
                                   {'device_transform': True, 'transfer_uint8': True}],
                         ids=['host', 'device_transform', 'uint8'])
def test_batches_are_bitwise_identical(slowtv_root, mode, epoch, ds_kw):
    _assert_identical(_epoch(parsers.get_dl, mode, epoch, ds_kw),
                      _epoch(jparsers.get_dl, mode, epoch, ds_kw))


def test_comparison_has_teeth(slowtv_root):
    """Another epoch (another shuffle and other augmentations) is not identical."""
    with pytest.raises(AssertionError):
        _assert_identical(_epoch(parsers.get_dl, 'train', 0, {}),
                          _epoch(jparsers.get_dl, 'train', 1, {}))


def test_threaded_loader_yields_the_same_items(slowtv_root):
    """Prefetching workers keep the batch order (the workers' random draws
    race, so the mode without augmentation or random support offsets is compared)."""
    ds, dl = _cfg(randomize_supp=False)
    want = list(parsers.get_dl('val', ds, dl))
    got = list(parsers.get_dl('val', ds, dict(dl, num_workers=2)))
    _assert_identical(got, want)


def test_unported_dataset_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        parsers.get_ds({'kitti_lmdb': {'split': 'eigen'}}, 'train')


def test_config_copy_merges_like_the_original(tmp_path):
    from slowtv_monodepth_tpu import config as jcfg
    from slowtv_monodepth_tpu_torch import config as tcfg
    a, b = tmp_path / 'a.yaml', tmp_path / 'b.yaml'
    a.write_text('net:\n  depth: {enc_name: x, out_scales: [0, 1]}\n  pose: {learn_K: true}\n'
                 'trainer: {max_epochs: 3}\n')
    b.write_text('net:\n  depth: {out_scales: [0]}\n  pose: ~\ntrainer: {matmul: high}\n')
    want = jcfg.load_merge_yaml(a, b)
    assert tcfg.load_merge_yaml(a, b) == want
    assert want['net'] == {'depth': {'enc_name': 'x', 'out_scales': [0]}, 'pose': None}
    tcfg.save_yaml(tmp_path / 'c.yaml', want)
    assert jcfg.load_yaml(tmp_path / 'c.yaml') == want


def test_viz_copy_colours_like_the_original():
    from slowtv_monodepth_tpu.tools import viz as jviz
    from slowtv_monodepth_tpu_torch.tools import viz as tviz
    disp = np.random.RandomState(0).rand(2, 12, 16, 1).astype(np.float32)
    np.testing.assert_array_equal(tviz.rgb_from_disp(disp), jviz.rgb_from_disp(disp))
    np.testing.assert_array_equal(tviz.rgb_from_disp(disp[0, ..., 0], invert=True),
                                  jviz.rgb_from_disp(disp[0, ..., 0], invert=True))
