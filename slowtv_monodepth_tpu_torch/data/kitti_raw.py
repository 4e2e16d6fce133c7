"""KITTI Raw dataset (ref `src/datasets/kitti_raw.py:19-207`).

Datum: image, support (monocular +/- stereo), depth (benchmark corrected
LiDAR), depth_velo (raw LiDAR projection), depth_hint (fused SGBM), K
(hardcoded normalized average intrinsics, ref `kitti_raw.py:76-85`).
Stereo baseline is the arbitrary +/-0.1 pixel-motion sign convention
(ref `:131-135`). Images are float32 NHWC [0, 1].
Copy of `slowtv_monodepth_tpu/data/kitti_raw.py`; cv2 and PIL are imported
where they are used, so the module imports without them.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..registry import register
from .base_mde import MdeBaseDataset, SuppImageNotFoundError
from .devkits import kitti_raw as kr

__all__ = ['KittiRawDataset']


@register('kitti')
class KittiRawDataset(MdeBaseDataset):
    """:param split: {eigen, eigen_zhou, eigen_benchmark, benchmark, ...}.
    :param mode: {train, val, test}.
    """
    VALID_DATUM = 'image support depth depth_velo depth_hint K'
    SHAPE = 376, 1242

    def __init__(self, split: str, mode: str, **kwargs):
        super().__init__(**kwargs)
        self.split = split
        self.mode = mode

        # Sign = direction PIXELS move in, not the camera (ref `:72-76`).
        self._cam2sign = {'image_02': -1, 'image_03': 1}
        self._side2cam = {'l': 'image_02', 'r': 'image_03'}
        self._cam2stereo = {'image_02': 'image_03', 'image_03': 'image_02'}

        K = np.array([
            [0.58, 0, 0.5, 0],
            [0, 1.92, 0.5, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ], dtype=np.float32)
        K[0] *= self.shape[1]
        K[1] *= self.shape[0]
        self.K = K

        self.split_file, self.items_data = self.parse_items()
        self.should_resize = True  # KITTI image sizes vary by drive.

    def log_args(self):
        self.logger.info(f"Split: '{self.split}' - Mode: '{self.mode}'")
        super().log_args()

    def validate_args(self) -> None:
        super().validate_args()
        if self.has('depth') and self.has('depth_velo'):
            raise ValueError('Must provide only one source of depth. '
                             '(`depth`: Corrected LiDAR, `depth_velo`: LiDAR)')

    def parse_items(self):
        file = kr.get_split_file(self.split, self.mode)
        lines = [line.split() for line in kr.load_split(file)]
        items = [kr.Item(line[0], int(line[1]), self._side2cam[line[2]]) for line in lines]
        return file, items

    def add_metadata(self, data: kr.Item, batch: tuple) -> tuple:
        batch[2]['stem'] = f'{data.seq}/{data.cam}/{data.stem:010}'
        return batch

    # ---------------------------------------------------------------- loaders
    def _load_image(self, data: kr.Item, offset: int = 0) -> np.ndarray:
        file = kr.get_image_file(data.seq, data.cam, data.stem + offset)
        if not file.is_file():
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find specified file "{file}" with "{offset=}"')
        from PIL import Image
        img = Image.open(file)
        if self.should_resize:
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img)

    def _load_stereo_image(self, data: kr.Item) -> np.ndarray:
        return self._load_image(kr.Item(data.seq, data.stem, self._cam2stereo[data.cam]))

    def _load_stereo_T(self, data: kr.Item) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = self._cam2sign[data.cam] * 0.1  # Arbitrary baseline.
        return T

    def _load_depth(self, data: kr.Item) -> np.ndarray:
        """Corrected-LiDAR benchmark depth, nearest-resized to SHAPE."""
        file = kr.get_depth_file(data.seq, data.cam, data.stem)
        if not file.is_file():
            raise FileNotFoundError(f'Could not find specified depth benchmark file "{file}".')
        depth = kr.load_depth(file)
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, (self.SHAPE[1], self.SHAPE[0]),
                               interpolation=cv2.INTER_NEAREST)
        return depth[..., None]

    def load_depth_velo(self, data: kr.Item, batch: tuple) -> tuple:
        batch[1]['depth'] = self._load_depth_velo(data)
        return batch

    def _load_depth_velo(self, data: kr.Item) -> np.ndarray:
        file = kr.get_velodyne_file(data.seq, data.stem)
        if not file.is_file():
            raise FileNotFoundError(f'Could not find specified depth LiDAR file "{file}".')
        seq = data.seq.split('/')[0]
        cam2cam, _, velo2cam = kr.load_calib(seq)
        depth = kr.load_depth_velodyne(file, velo2cam, cam2cam, cam=int(data.cam[-2:]))
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, (self.SHAPE[1], self.SHAPE[0]),
                               interpolation=cv2.INTER_NEAREST)
        return depth[..., None]

    def load_depth_hint(self, data: kr.Item, batch: tuple) -> tuple:
        batch[1]['depth_hints'] = self._load_depth_hint(data)
        return batch

    def _load_depth_hint(self, data: kr.Item) -> np.ndarray:
        file = kr.get_hint_file(data.seq, data.cam, data.stem)
        if not file.is_file():
            raise FileNotFoundError(f'Could not find specified depth hint file "{file}".')
        depth = np.load(file)
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, dsize=self.size, interpolation=cv2.INTER_NEAREST)
        return depth[..., None]

    def _load_K(self, data: Any) -> np.ndarray:
        return self.K.copy()

    # ----------------------------------------------------------- augmentation
    def apply_flip_aug(self, batch: tuple) -> tuple:
        batch = super().apply_flip_aug(batch)
        y = batch[1]
        if 'depth_hints' in y:
            y['depth_hints'] = np.ascontiguousarray(np.flip(y['depth_hints'], axis=1))
        return batch
