"""SYNS-Patches dataset — evaluation only (ref `src/datasets/syns_patches.py:17-154`).

Datum: image, depth, edge, K. Rejects augmentation/support configuration
(ref `:69-77`). Copy of `slowtv_monodepth_tpu/data/syns_patches.py`: PIL is
imported inside the loaders, and the depth's `cv2.resize(INTER_NEAREST)` is
the same gather in numpy (`utils.resize.nearest_index`, bitwise OpenCV's).
"""
from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np

from ..registry import register
from ..utils.resize import nearest_index
from .base import img_to_f32
from .base_mde import MdeBaseDataset
from .devkits import syns_patches as syp

__all__ = ['SynsPatchesDataset']


@register('syns_patches')
class SynsPatchesDataset(MdeBaseDataset):
    """:param mode: {val, test}."""
    VALID_DATUM = 'image depth edge K'
    SHAPE = 376, 1242

    def __init__(self, mode: str,
                 datum: Union[str, Sequence[str]] = 'image depth edge K',
                 **kwargs):
        super().__init__(datum=datum, **kwargs)
        self.mode = mode
        self.split_file, self.items_data = self.parse_items()

    def log_args(self):
        self.logger.info(f"Mode: '{self.mode}'")
        super().log_args()

    def validate_args(self) -> None:
        self.VALID_DATUM.add('support')  # Fake support during base checks.
        super().validate_args()
        self.VALID_DATUM.remove('support')

        if self.use_aug:
            raise ValueError('SYNS-Patches is a testing dataset, no augmentations should be applied.')
        if self.supp_idxs:
            raise ValueError('SYNS-Patches does not provide support frames.')
        if self.randomize_supp:
            raise ValueError('SYNS-Patches does not provide support frames.')

    def parse_items(self):
        return syp.load_split(self.mode)

    def add_metadata(self, data: syp.Item, batch: tuple) -> tuple:
        m = batch[2]
        m['cat'], m['subcat'] = syp.load_category(data.seq)
        return batch

    def _load_image(self, data: syp.Item, offset: int = 0) -> np.ndarray:
        from PIL import Image
        img = Image.open(syp.get_image_file(data.seq, data.stem))
        if self.should_resize:
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img)

    def _load_depth(self, data: syp.Item) -> np.ndarray:
        depth = np.load(syp.get_depth_file(data.seq, data.stem)).astype(np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        if self.should_resize:
            h, w = depth.shape
            depth = depth[nearest_index(h, self.shape[0])[:, None],
                          nearest_index(w, self.shape[1])[None, :]]
        return depth[..., None]

    def load_edge(self, data: syp.Item, batch: tuple) -> tuple:
        batch[1]['edges'] = self._load_edge(data)
        return batch

    def _load_edge(self, data: syp.Item) -> np.ndarray:
        from PIL import Image
        edge = Image.open(syp.get_edges_file(data.seq, 'edges', data.stem))
        if self.should_resize:
            edge = edge.resize(self.size, resample=Image.Resampling.NEAREST)
        return img_to_f32(edge)[..., None].astype(bool)

    def _load_K(self, data: Any) -> np.ndarray:
        K = syp.load_intrinsics()
        if self.should_resize:
            K[0] *= self.shape[1] / self.SHAPE[1]
            K[1] *= self.shape[0] / self.SHAPE[0]
        return K

    def load_support(self, data: Any, batch: tuple) -> tuple:
        raise NotImplementedError('SYNS-Patches does not contain support frames.')

    def _load_stereo_image(self, data: Any):
        raise NotImplementedError('SYNS-Patches does not contain stereo pairs.')

    def _load_stereo_T(self, data: Any):
        raise NotImplementedError('SYNS-Patches does not contain stereo pairs.')

    def show(self, batch: tuple, axs) -> None:
        super().show(batch, axs)
        y = batch[1]
        if 'edges' in y:
            axs[-1].imshow(y['edges'][..., 0])
