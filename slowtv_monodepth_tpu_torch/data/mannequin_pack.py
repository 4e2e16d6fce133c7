"""MannequinChallenge dataset over pack stores
(ref `src/datasets/mannequin_lmdb.py:16-70` + devkit `:14-124`).
Registry key: `mannequin_lmdb`. Copy of
`slowtv_monodepth_tpu/data/mannequin_pack.py`; cv2 and PIL are imported where
they are used, so the module imports without them.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..registry import register
from ..databases import ImageDatabase, LabelDatabase
from ..paths import DATA_PATHS as PATHS
from .base_mde import SuppImageNotFoundError
from .devkits.mannequin import Item
from .mannequin import MannequinDataset

__all__ = ['MannequinPackDataset']


def _root() -> Path:
    return PATHS['mannequin_lmdb']


@register('mannequin_lmdb')
class MannequinPackDataset(MannequinDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.img_db = ImageDatabase(_root() / self.mode / 'images')
        self.depth_db = LabelDatabase(_root() / self.mode / 'depths') if self.has('depth') else None
        self.K_db = LabelDatabase(_root() / self.mode / 'intrinsics')
        self.shape_db = LabelDatabase(_root() / self.mode / 'shapes')

    def parse_items(self):
        file = _root() / 'splits' / f'{self.mode}_files.txt'
        with open(file) as f:
            items = [Item(*line.split()) for line in f.read().splitlines()]
        return file, items

    def _load_image(self, data: Item, offset: int = 0) -> np.ndarray:
        k = f'{data.seq}/{int(data.stem) + offset:05}'
        if k not in self.img_db:
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find specified file "{k}" with "{offset=}"')
        img = self.img_db.pil(k)
        if self.should_resize:
            from PIL import Image
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img.convert('RGB'))

    def _load_depth(self, data: Item) -> np.ndarray:
        k = f'{data.seq}/{data.stem}'
        if k not in self.img_db:
            raise FileNotFoundError(f'Could not find specified file "{k}"')
        depth = np.asarray(self.depth_db[k], np.float32)
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, dsize=self.size, interpolation=cv2.INTER_NEAREST)
        return depth[..., None] if depth.ndim == 2 else depth

    def _load_K(self, data: Item) -> np.ndarray:
        K = np.asarray(self.K_db[data.seq], np.float32).copy()
        if self.should_resize:
            sh = [i + 1 for i in self.shape_db[data.seq]]  # Reference quirk.
            K[0] *= self.shape[1] / sh[1]
            K[1] *= self.shape[0] / sh[0]
        return K
