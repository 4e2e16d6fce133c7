"""MannequinChallenge dataset (ref `src/datasets/mannequin.py:18-127`).

Datum: image, support (monocular), depth (COLMAP npy), K (per-frame from
calibration info files; note the reference's `shape+1` normalization quirk,
`mannequin.py:105-111`, reproduced for parity). Random support offsets 1-5
(ref `:90-94`).
Copy of `slowtv_monodepth_tpu/data/mannequin.py`; cv2 and PIL are imported
where an image or a depth map is read, so the module imports without them.
"""
from __future__ import annotations

import random
from typing import Any

import numpy as np

from ..registry import register
from .base_mde import MdeBaseDataset, SuppImageNotFoundError
from .devkits import mannequin as mc

__all__ = ['MannequinDataset']


@register('mannequin')
class MannequinDataset(MdeBaseDataset):
    """:param mode: {train, val, test}."""
    VALID_DATUM = 'image support depth K'
    SHAPE = 1080, 1920

    def __init__(self, mode: str, **kwargs):
        super().__init__(**kwargs)
        self.mode = mode
        self.split_file, self.items_data = self.parse_items()

    def log_args(self):
        self.logger.info(f"Mode: '{self.mode}'")
        super().log_args()

    def validate_args(self) -> None:
        super().validate_args()
        if 0 in self.supp_idxs:
            raise ValueError('MannequinChallenge does not provide stereo pairs.')

    def parse_items(self):
        return mc.load_split(self.mode)

    def add_metadata(self, data: mc.Item, batch: tuple) -> tuple:
        batch[2]['seq'] = data.seq
        return batch

    def _load_image(self, data: mc.Item, offset: int = 0) -> np.ndarray:
        file = mc.get_img_file(mode=self.mode, seq=data.seq, stem=int(data.stem) + offset)
        if not file.is_file():
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find specified file "{file}" with "{offset=}"')
        from PIL import Image
        img = Image.open(file)
        if self.should_resize:
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img)

    def get_supp_scale(self, data: mc.Item) -> int:
        if not self.randomize_supp:
            return 1
        return random.randint(1, 5)

    def _load_depth(self, data: mc.Item) -> np.ndarray:
        file = mc.get_depth_file(self.mode, data.seq, data.stem)
        if not file.is_file():
            raise FileNotFoundError(f'Could not find specified depth file "{file}".')
        depth = np.load(file)
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, dsize=self.size, interpolation=cv2.INTER_NEAREST)
        return depth[..., None] if depth.ndim == 2 else depth

    def _load_K(self, data: mc.Item) -> np.ndarray:
        info = mc.load_info(self.mode, data.seq)[data.stem]
        sh = [i + 1 for i in info['shape']]  # Reference quirk (`:105-111`).
        K = info['K'].copy()
        if self.should_resize:
            K[0] *= self.shape[1] / sh[1]
            K[1] *= self.shape[0] / sh[0]
        return K

    def _load_stereo_image(self, data: Any):
        raise NotImplementedError('MannequinChallenge does not contain stereo pairs.')

    def _load_stereo_T(self, data: Any):
        raise NotImplementedError('MannequinChallenge does not contain stereo pairs.')
