"""The KBR recipe's three datasets at once through the port's training run (CPU).

`cfg/kbr/default.yaml` read as it stands, its dataset section over the
synthetic packs of `tests/test_torch_data.py` (laid out as
`tests/test_kbr_wiring.py`'s fixtures lay them out) and cut as
`tests/test_kbr_wiring.make_kbr_cfg` cuts it: the tiny KITTI split, sources
48x160 and 64x112, 8 items a dataset. Two cuts differ, because the nets
here are `convnext_atto` (stride 32, reflect padding in the decoder) where
the wiring test runs a toy encoder: the augmentation aims at 128x192 and the
validation shapes are 64x192 and 64x128, so that no image is under 64 px in
a dimension. `pretrained: True` stays on, with no weights file under the
model root. `MonoDepthLoop` runs one epoch (six micro-steps, aspect-ratio
augmentation on, kernel 5's plain version resampling KITTI's depth too) and
one validation pass over a batch of each dataset. `chip_smoke.py`'s in-memory
stand-ins for these readers (the card's machine cannot decode a pack) are held
to the readers' batch layouts.
"""
import logging
from pathlib import Path

import numpy as np
import pytest

from slowtv_monodepth_tpu_torch import parsers, paths
from slowtv_monodepth_tpu_torch.config import load_merge_yaml
from slowtv_monodepth_tpu_torch.core import MonoDepthLoop
from slowtv_monodepth_tpu_torch.core.aspect_ratio import all_output_shapes
from slowtv_monodepth_tpu_torch.core.train_metrics import METRIC_NAMES
from test_kbr_wiring import make_kbr_cfg
from test_torch_data import PACK_DATASETS, recipe_packs  # noqa: F401
from test_torch_loop import _Writer
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

RECIPE = Path(__file__).resolve().parents[1] / 'cfg' / 'kbr' / 'default.yaml'
REF_SHAPE = [128, 192]
VAL_SHAPES = {'kitti_lmdb': [64, 192], 'mannequin_lmdb': [64, 128], 'slow_tv_lmdb': [64, 128]}


def recipe_cfg() -> dict:
    cfg = load_merge_yaml(RECIPE)
    cut = make_kbr_cfg()['dataset']
    for name, ds in cfg['dataset'].items():
        ds.update({k: cut[name][k] for k in ('split',) if k in cut[name]}, max_len=8)
        ds['train']['shape'] = cut[name]['train']['shape']
        ds['val']['shape'] = VAL_SHAPES[name]
    for net in cfg['net'].values():
        net['enc_name'] = 'convnext_atto'
    cfg['loader'].update(train={'num_workers': 0, 'shuffle': True},
                         val={'num_workers': 0, 'shuffle': False})
    cfg['trainer'].update(max_epochs=1, log_every_n_steps=1, limit_val_batches=3,
                          aspect_ratio_ref_shape=REF_SHAPE, matmul='highest')
    return cfg


def test_the_cut_keeps_every_bucket_at_64_px_or_more():
    srcs = [d['train']['shape'] for d in recipe_cfg()['dataset'].values()]
    assert min(min(s) for s in all_output_shapes(srcs, REF_SHAPE)) >= 64


def test_one_epoch_and_a_validation_over_the_three_pack_datasets(recipe_packs, tmp_path,
                                                                 monkeypatch, caplog):
    import random
    random.seed(0)  # the datasets' host augmentations
    np.random.seed(0)
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path / 'models'])
    cfg = recipe_cfg()
    assert list(cfg['dataset']) == list(PACK_DATASETS)
    writer = _Writer()
    with caplog.at_level(logging.WARNING):
        loop = MonoDepthLoop(cfg, tmp_path / 'run', device='cpu', writer=writer)
    assert caplog.text.count('No pretrained weights for "convnext_atto" under <model_root>/timm/') == 2
    assert [type(dl.dataset).__name__ for dl in loop.train_dl.loaders] == [
        'KittiRawPackDataset', 'MannequinPackDataset', 'SlowTvPackDataset']

    seen = []
    aug = loop.ar_aug

    def recording_aug(batch, **kw):
        out = aug(batch, **kw)
        seen.append((tuple(out[0]['imgs'].shape[1:3]), 'depth' in out[1]))
        return out

    loop.ar_aug = recording_aug
    loop.fit()

    # Round robin in the cfg's key order, depth on the KITTI batches only.
    assert [d for _, d in seen] == [True, False, False, True, False, False]
    assert loop.global_step == 6 and loop.opt.updates == 3
    assert all(h % 32 == 0 and w % 32 == 0 and min(h, w) >= 64 for (h, w), _ in seen)
    logged = {}
    for tag, val, step in writer.logged:
        logged.setdefault(tag, []).append((step, val))
    assert all(np.isfinite(v) for _, v, _ in writer.logged)
    for name in METRIC_NAMES:  # the train metrics on the two KITTI micro-steps, and at validation
        assert [s for s, _ in logged[f'train_monitor/{name}']] == [1, 4], name
        assert f'val_metrics/{name}' in logged, name
    assert len(logged['train_monitor/fx']) == 6 and 'val_metrics/loss' in logged
    assert (tmp_path / 'run' / 'finished').is_file()


def _layout(batch) -> list:
    x, y, m = batch
    arrays = [(k, v.dtype, v.shape) for d in (x, y) for k, v in d.items()]
    return arrays + [(k, type(v), len(v), type(v[0])) for k, v in m.items()]


@pytest.mark.parametrize('mode', ['train', 'val'])
def test_chip_smoke_stand_ins_yield_the_readers_layouts(recipe_packs, mode):
    """`chip_smoke.PackLoader` yields the keys (in order), dtypes and shapes that each
    pack dataset's loader yields with the recipe's settings."""
    import chip_smoke
    cfg = recipe_cfg()
    b = cfg['loader']['batch_size']
    assert b == chip_smoke.TRAIN_B
    real = list(parsers.get_dl(mode, cfg['dataset'], cfg['loader']))[:len(PACK_DATASETS)]
    scenes = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    for name, batch in zip(PACK_DATASETS, real):
        stand_in = chip_smoke.PackLoader(scenes, name, 1, cfg['dataset'][name][mode]['shape'],
                                         mode == 'train')
        assert _layout(next(iter(stand_in))) == _layout(batch), name
    assert 'depth' in real[0][1] and real[0][1]['depth'].shape == (b, *chip_smoke.RECIPE_DEPTH_SHAPE, 1)
