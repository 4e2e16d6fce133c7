"""SlowTV dataset (ref `src/datasets/slow_tv.py:16-129`).

Datum: image, support (monocular only), K (COLMAP txt intrinsics). Randomized
support offsets use the per-category max {natural 5, driving 1, underwater 5}
(ref `slow_tv.py:63-67,98-104`). Copy of `slowtv_monodepth_tpu/data/slow_tv.py`;
PIL is imported where an image is read, so the module imports without it.
"""
from __future__ import annotations

import random
from typing import Any

import numpy as np

from ..registry import register
from .base_mde import MdeBaseDataset, SuppImageNotFoundError
from .devkits import slow_tv as stv

__all__ = ['SlowTvDataset']


@register('slow_tv')
class SlowTvDataset(MdeBaseDataset):
    """:param split: {all, natural, driving, underwater, <seq>}.
    :param mode: {train, val}.
    """
    VALID_DATUM = 'image support K'
    SHAPE = 720, 1280

    def __init__(self, split: str, mode: str, **kwargs):
        super().__init__(**kwargs)
        self.split = split
        self.mode = mode

        self.split_file, self.items_data = self.parse_items()
        self.cats = self.parse_cats()
        self._max_offset_per_cat = {'natural': 5, 'driving': 1, 'underwater': 5}

    def log_args(self):
        self.logger.info(f"Split: '{self.split}' - Mode: '{self.mode}'")
        super().log_args()

    def validate_args(self) -> None:
        super().validate_args()
        if 0 in self.supp_idxs:
            raise ValueError('SlowTV does not provide stereo pairs.')

    def parse_items(self):
        return stv.load_split(self.mode, self.split)

    def parse_cats(self) -> dict:
        return dict(zip(stv.get_seqs(), stv.load_categories(subcats=False)))

    def _load_image(self, data: stv.Item, offset: int = 0) -> np.ndarray:
        file = stv.get_img_file(seq=data.seq, stem=int(data.stem) + offset)
        if not file.is_file():
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find specified file "{file}" with "{offset=}"')
        from PIL import Image
        img = Image.open(file)
        if self.should_resize:
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img)

    def get_supp_scale(self, data: stv.Item) -> int:
        if not self.randomize_supp:
            return 1
        cat = self.cats[data.seq]
        return random.randint(1, self._max_offset_per_cat[cat])

    def _load_K(self, data: stv.Item) -> np.ndarray:
        K = stv.load_intrinsics(data.seq)
        if self.should_resize:
            K = K.copy()
            K[0] *= self.shape[1] / self.SHAPE[1]
            K[1] *= self.shape[0] / self.SHAPE[0]
        return K

    def _load_depth(self, data: Any) -> np.ndarray:
        raise NotImplementedError('SlowTV does not contain ground-truth depth.')
