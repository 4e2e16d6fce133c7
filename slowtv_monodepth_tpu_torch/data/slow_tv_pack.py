"""SlowTV dataset over pack stores (ref `src/datasets/slow_tv_lmdb.py:16-64` +
`src/devkits/slow_tv_lmdb.py:1-73`). Registry key: `slow_tv_lmdb`. Copy of
`slowtv_monodepth_tpu/data/slow_tv_pack.py`; PIL is imported where an image is
resized, so the module imports without it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..registry import register
from ..paths import DATA_PATHS as PATHS
from ..databases import ImageDatabase, LabelDatabase
from .base_mde import SuppImageNotFoundError
from .devkits.slow_tv import Item
from .slow_tv import SlowTvDataset

__all__ = ['SlowTvPackDataset']


def _root() -> Path:
    return PATHS['slow_tv_lmdb']


def get_split_file(mode: str, split: str) -> Path:
    return _root() / 'splits' / f'{split}' / f'{mode}_files.txt'


def get_seqs() -> tuple:
    return tuple(sorted(d.stem for d in _root().iterdir()
                        if d.is_dir() and d.stem not in {'splits', 'videos', 'colmap'}))


def load_categories(subcats: bool = True) -> list:
    with open(_root() / 'splits' / 'categories.txt') as f:
        lines = [line.lower() for line in f.read().splitlines()]
    return lines if subcats else [line.split('-')[0] for line in lines]


@register('slow_tv_lmdb')
class SlowTvPackDataset(SlowTvDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.image_dbs: dict = {}
        self.calib_db = LabelDatabase(_root() / 'calibs')
        for s in set(i.seq for i in self.items_data):
            self.image_dbs[s] = ImageDatabase(_root() / s)

    def parse_items(self):
        file = get_split_file(self.mode, self.split)
        with open(file) as f:
            items = [Item(*line.split()) for line in f.read().splitlines()]
        return file, items

    def parse_cats(self) -> dict:
        return dict(zip(get_seqs(), load_categories(subcats=False)))

    def _load_image(self, data: Item, offset: int = 0) -> np.ndarray:
        k = f'{int(data.stem) + offset:010}'
        db = self.image_dbs[data.seq]
        if k not in db:
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find specified file "{data.seq}/{k}" with "{offset=}"')
        img = db.pil(k)
        if self.should_resize:
            from PIL import Image
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img.convert('RGB'))

    def _load_K(self, data: Item) -> np.ndarray:
        K = np.asarray(self.calib_db[data.seq], np.float32).copy()
        if self.should_resize:
            K[0] *= self.shape[1] / self.SHAPE[1]
            K[1] *= self.shape[0] / self.SHAPE[0]
        return K
