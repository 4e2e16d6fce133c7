"""Port differential: the host data pipeline (`data/`, `parsers.get_dl`).

The port keeps its own copies of the JAX package's framework-free loader,
dataset bases, augmentations and SlowTV dataset. The same PNG tree goes
through both packages' `parsers.get_dl`, with Python's and numpy's global
generators seeded alike before each epoch: the batches must be IDENTICAL,
bit for bit (same files, same order, same flips, same colour jiggle, same
standardization), in the host mode and in the `device_transform` mode.
The utility copies (`config`, `tools.viz`) are held to their originals on
the same inputs as well. The KBR recipe's pack datasets (`kitti_lmdb`,
`mannequin_lmdb`, `slow_tv_lmdb`) are held the same way on synthetic packs
laid out as `tests/test_kbr_wiring.py`'s fixtures lay them out (KITTI 48x160
with uint16 benchmark depth, SlowTV and MannequinChallenge 64x112), built
once per module by the JAX package's writer and `api/data/pack/build.py`.
"""
import io
import random
import sys
from pathlib import Path

import numpy as np
import pytest

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu import paths as jpaths
from slowtv_monodepth_tpu.databases import packdb as jpackdb
from slowtv_monodepth_tpu_torch import parsers, paths
from test_kbr_wiring import N_FRAMES, _depth_png_bytes, _png_bytes, make_kbr_cfg
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

PACK_DATASETS = ('kitti_lmdb', 'mannequin_lmdb', 'slow_tv_lmdb')
PACK_KEYS = ('kitti_raw_lmdb', 'mannequin_lmdb', 'slow_tv_lmdb')


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


def _write_kitti(root: Path) -> None:
    """`tests/test_kbr_wiring.py:kitti_pack_root`: per-drive image packs (both
    cams) and benchmark-depth packs, written directly."""
    from slowtv_monodepth_tpu.databases import write_image_database
    seq, drive = '2011_09_26', '2011_09_26_drive_0001_sync'
    for cam in ('image_02', 'image_03'):
        write_image_database(
            {f'{i:010d}': _png_bytes((48, 160), i) for i in range(N_FRAMES)},
            root / seq / drive / cam / 'data')
        write_image_database(
            {f'{i:010d}': _depth_png_bytes((48, 160), i) for i in range(N_FRAMES)},
            root / 'depth_benchmark' / seq / drive / 'proj_depth' / 'groundtruth' / cam)
    split = root / 'splits' / 'tiny'
    split.mkdir(parents=True)
    (split / 'train_files.txt').write_text('\n'.join(f'{seq}/{drive} {i} l' for i in range(1, 19)))
    (split / 'val_files.txt').write_text('\n'.join(f'{seq}/{drive} {i} l' for i in range(1, 9)))


def _write_slow_tv(raw: Path, out: Path, build) -> None:
    """`tests/test_kbr_wiring.py:slowtv_pack_root`: a raw SlowTV tree, then `api/data/pack/build.py`."""
    from PIL import Image
    seq = '00001'
    for stem in range(N_FRAMES):
        p = raw / seq / f'{stem:010}.png'
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.open(io.BytesIO(_png_bytes((64, 112), stem))).save(p)
    np.savetxt(raw / seq / 'intrinsics.txt',
               np.array([[600, 0, 640, 0], [0, 600, 360, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]]))
    (raw / 'splits' / 'all').mkdir(parents=True)
    (raw / 'splits' / 'all' / 'train_files.txt').write_text(
        '\n'.join(f'{seq} {i}' for i in range(6, 24)))
    (raw / 'splits' / 'all' / 'val_files.txt').write_text('\n'.join(f'{seq} {i}' for i in range(6, 14)))
    (raw / 'splits' / 'categories.txt').write_text('natural-hiking\n')
    jpaths.DATA_PATHS['slow_tv'] = raw
    build.build_slow_tv(out)


def _write_mannequin(raw: Path, out: Path, build) -> None:
    """`tests/test_kbr_wiring.py:mannequin_pack_root`: raw train and val trees, then `build.py`."""
    from PIL import Image
    for mode, seq in (('train', 'seqA'), ('val', 'seqB')):
        for stem in range(N_FRAMES):
            p = raw / mode / seq / f'{stem:05}.jpg'
            p.parent.mkdir(parents=True, exist_ok=True)
            Image.open(io.BytesIO(_png_bytes((64, 112), stem))).convert('RGB').save(p)
        lines = [f'{N_FRAMES} 0']
        for _ in range(N_FRAMES):
            lines += ['0 64 0 112', '0.9 1.6 0.5 0.5', '1 0 0', '0 1 0', '0 0 1', '0 0 0']
        (raw / mode / seq / 'calibration.txt').write_text('\n'.join(lines) + '\n')
    (raw / 'splits').mkdir(parents=True)
    (raw / 'splits' / 'train_files.txt').write_text(
        '\n'.join(f'seqA {i:05}' for i in range(6, 24)) + '\n')
    (raw / 'splits' / 'val_files.txt').write_text(
        '\n'.join(f'seqB {i:05}' for i in range(6, 14)) + '\n')
    jpaths.DATA_PATHS['mannequin'] = raw
    build.build_mannequin(out, 'train')
    build.build_mannequin(out, 'val')


@pytest.fixture(scope='module')
def recipe_packs(tmp_path_factory):
    """The three pack stores of `cfg/kbr/default.yaml`'s dataset section, known to
    both packages' `DATA_PATHS` under their keys; the JAX package reads them
    through its Python reader, as the port does."""
    root = tmp_path_factory.mktemp('recipe_packs')
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / 'api' / 'data' / 'pack'))
    import build
    packs = dict(zip(PACK_KEYS, (root / 'kitti_raw_sync_lmdb', root / 'MannequinChallenge_lmdb',
                                 root / 'slow_tv_lmdb')))
    _write_kitti(packs['kitti_raw_lmdb'])
    _write_mannequin(root / 'MannequinChallenge', packs['mannequin_lmdb'], build)
    _write_slow_tv(root / 'slow_tv', packs['slow_tv_lmdb'], build)
    for key in ('slow_tv', 'mannequin'):  # the raw trees were for `build.py` only
        jpaths.DATA_PATHS.pop(key, None)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpackdb, '_lib', False)
    for p in (paths, jpaths):
        for key, path in packs.items():
            mp.setitem(p.DATA_PATHS, key, path)
    yield packs
    mp.undo()


def _cfg(dataset='slow_tv', **ds_kw):
    if dataset == 'slow_tv':
        ds = {'slow_tv': {'split': 'all', 'datum': 'image support K', 'supp_idxs': [-1, 1],
                          'randomize_supp': True, **ds_kw,
                          'train': {'mode': 'train', 'use_aug': True, 'shape': [32, 64]},
                          'val': {'mode': 'val', 'use_aug': False}}}
    else:  # the recipe's section, cut as tests/test_kbr_wiring.py cuts it
        ds = {dataset: {**make_kbr_cfg()['dataset'][dataset], **ds_kw}}
    dl = {'batch_size': 2, 'drop_last': True, 'num_workers': 0, 'seed': 7,
          'train': {'shuffle': True}, 'val': {'shuffle': False}}
    return ds, dl


def _epoch(get_dl, mode, epoch, ds_kw, dataset='slow_tv'):
    dl = get_dl(mode, *_cfg(dataset, **ds_kw))
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


@pytest.mark.parametrize('mode,epoch', [('train', 0), ('train', 3), ('val', 0), ('val', 1)])
@pytest.mark.parametrize('ds_kw', [{}, {'device_transform': True},
                                   {'device_transform': True, 'transfer_uint8': True},
                                   *({'dataset': d} for d in PACK_DATASETS)],
                         ids=['host', 'device_transform', 'uint8', *PACK_DATASETS])
def test_batches_are_bitwise_identical(request, mode, epoch, ds_kw):
    ds_kw = dict(ds_kw)
    dataset = ds_kw.pop('dataset', 'slow_tv')
    request.getfixturevalue('slowtv_root' if dataset == 'slow_tv' else 'recipe_packs')
    got = _epoch(parsers.get_dl, mode, epoch, ds_kw, dataset)
    _assert_identical(got, _epoch(jparsers.get_dl, mode, epoch, ds_kw, dataset))
    if dataset == 'kitti_lmdb':  # the benchmark depth, at KITTI's full shape
        assert all(y['depth'].shape == (2, 376, 1242, 1) and y['depth'].dtype == np.float32
                   and (y['depth'] > 0).any() for _, y, _ in got)


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


def test_dataset_registry_matches_the_jax_package():
    """Every dataset key of the JAX package's registry is registered in the port,
    and no other."""
    import slowtv_monodepth_tpu as jpkg
    from slowtv_monodepth_tpu_torch.registry import DATA_REG, trigger_datasets
    trigger_datasets()
    jpkg.trigger_datasets()
    assert sorted(DATA_REG) == sorted(jpkg.DATA_REG)
    assert {'ddad', 'diode', 'nyud', 'sintel', 'tum', 'mapfree'} <= set(DATA_REG)


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
