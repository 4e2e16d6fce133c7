"""MapFreeReloc dataset (ref `src/datasets/mapfreereloc.py:55-134`).

Datum: image, support (monocular), depth (from a DPT baseline `depth_src`),
pose, K. Used by the MapFree prediction entry point (`mapfree_preds`). Copy
of `slowtv_monodepth_tpu/data/mapfreereloc.py`: PIL is imported inside the
loaders, and the depth's `cv2.resize(INTER_NEAREST)` to `SHAPE` is the same
gather in numpy (`utils.resize.nearest_index`, bitwise OpenCV's).
"""
from __future__ import annotations

import random
from typing import Any

import numpy as np

from ..registry import register
from ..utils.resize import nearest_index
from .base_mde import MdeBaseDataset, SuppImageNotFoundError
from .devkits import mapfreereloc as mfr

__all__ = ['MapFreeRelocDataset']


@register('mapfree')
class MapFreeRelocDataset(MdeBaseDataset):
    """:param mode: {train, val, test}.
    :param depth_src: Depth-map source suffix (e.g. 'dptkitti')."""
    VALID_DATUM = 'image support depth pose K'
    SHAPE = 720, 540

    def __init__(self, mode: str, depth_src: str = 'dptkitti', **kwargs):
        super().__init__(**kwargs)
        self.mode = mode
        self.depth_src = depth_src
        self.split_file = mfr.Item.get_split_file(mode)
        self.items_data = mfr.Item.load_split(mode)

    def log_args(self):
        self.logger.info(f"Mode: '{self.mode}'")
        super().log_args()

    def validate_args(self) -> None:
        super().validate_args()
        if 'depth' in self.datum and self.mode == 'train':
            raise ValueError('Depth maps are not available for the MapFreeReloc training split.')
        if self.supp_idxs and 0 in self.supp_idxs:
            raise ValueError('Stereo support frames are not provided by MapFreeReloc.')

    def get_supp_scale(self, data: mfr.Item) -> int:
        if not self.randomize_supp:
            return 1
        return random.randint(1, 5)

    def add_metadata(self, data: mfr.Item, batch: tuple) -> tuple:
        m = batch[2]
        m['mode'], m['scene'], m['seq'], m['stem'] = (
            self.mode, data.scene, data.seq, data.stem)
        return batch

    def load_pose(self, data: mfr.Item, batch: tuple) -> tuple:
        batch[1]['T'] = data.load_pose()
        return batch

    def _load_image(self, data: mfr.Item, offset: int = 0) -> np.ndarray:
        from PIL import Image
        if offset:
            stem = int(data.stem.split('_')[1]) + offset
            data = mfr.Item(self.mode, data.scene, data.seq, f'frame_{stem:05d}')
        if not data.get_img_file().is_file():
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find "{data.scene}/{data.seq}/{data.stem}" with {offset=}')
        img = data.load_img()
        if self.should_resize:
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img)

    def _load_depth(self, data: mfr.Item) -> np.ndarray:
        depth = data.load_depth(self.depth_src)
        if self.should_resize and depth.shape[:2] != tuple(self.SHAPE):
            (h, w), (H, W) = depth.shape[:2], self.SHAPE
            depth = depth[nearest_index(h, H)[:, None], nearest_index(w, W)[None, :]]
        return depth

    def _load_K(self, data: mfr.Item) -> np.ndarray:
        K = data.load_intrinsics()
        if self.should_resize:
            K[0] *= self.shape[1] / self.SHAPE[1]
            K[1] *= self.shape[0] / self.SHAPE[0]
        return K

    def _load_stereo_image(self, data: Any):
        raise NotImplementedError('MapFreeReloc does not provide stereo images.')

    def _load_stereo_T(self, data: Any):
        raise NotImplementedError('MapFreeReloc does not provide stereo images.')
