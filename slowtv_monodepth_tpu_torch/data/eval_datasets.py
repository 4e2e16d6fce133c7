"""Evaluation-only datasets: DIODE, NYUD-v2, Sintel, TUM-RGBD, DDAD.

Copy of `slowtv_monodepth_tpu/data/eval_datasets.py` (capability parity with
the reference's `src/datasets/{diode,nyud,sintel,tum,ddad}.py`), PIL imported
where an image is resized. Each rejects augmentation and support
configuration and loads image [+depth, K, mask] for zero-shot evaluation;
the shared guards live in `EvalOnlyDataset`.
"""
from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np

from ..registry import register
from .base_mde import MdeBaseDataset
from .devkits import ddad as dd
from .devkits import diode as di
from .devkits import nyud as ny
from .devkits import sintel as si
from .devkits import tum as tu

__all__ = ['EvalOnlyDataset', 'DiodeDataset', 'NyudDataset', 'SintelDataset', 'TumDataset',
           'DdadDataset']


class EvalOnlyDataset(MdeBaseDataset):
    """Shared guards for test-only datasets (ref per-dataset `validate_args`)."""

    def validate_args(self) -> None:
        self.VALID_DATUM.add('support')  # Fake support for base checks.
        super().validate_args()
        self.VALID_DATUM.remove('support')

        name = self.__class__.__name__
        if self.use_aug:
            raise ValueError(f'{name} is a testing dataset, no augmentations should be applied.')
        if self.supp_idxs:
            raise ValueError(f'{name} does not provide support frames.')
        if self.randomize_supp:
            raise ValueError(f'{name} does not provide support frames.')

    def _img_from_pil(self, img) -> np.ndarray:
        from PIL import Image
        if self.should_resize:
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img.convert('RGB'))

    def _load_stereo_image(self, data: Any):
        raise NotImplementedError(f'{self.__class__.__name__} has no stereo pairs.')

    def _load_stereo_T(self, data: Any):
        raise NotImplementedError(f'{self.__class__.__name__} has no stereo pairs.')

    def _load_K(self, data: Any) -> np.ndarray:
        raise NotImplementedError(f'{self.__class__.__name__} has no intrinsics.')


@register('diode')
class DiodeDataset(EvalOnlyDataset):
    """DIODE (ref `src/datasets/diode.py:13-76`): npy depth + valid mask.

    :param scene: {indoors, outdoor}; :param mode: {val}.
    """
    VALID_DATUM = 'image depth mask'
    SHAPE = 768, 1024

    def __init__(self, scene: str, mode: str,
                 datum: Union[str, Sequence[str]] = 'image depth mask', **kwargs):
        super().__init__(datum=datum, **kwargs)
        self.scene = scene
        self.mode = mode
        self.split_file = di.Item.get_split_file(mode, scene)
        self.items_data = di.Item.load_split(mode, scene)

    def _load_image(self, data: di.Item, offset: int = 0) -> np.ndarray:
        return self._img_from_pil(data.load_img())

    def _load_depth(self, data: di.Item) -> np.ndarray:
        d = data.load_depth()
        return d if d.ndim == 3 else d[..., None]

    def load_mask(self, data: di.Item, batch: tuple) -> tuple:
        batch[1]['mask'] = data.load_mask()[..., None]
        return batch


@register('nyud')
class NyudDataset(EvalOnlyDataset):
    """NYUD-v2 (ref `src/datasets/nyud.py:14-67`): Kinect npy depth."""
    VALID_DATUM = 'image depth'
    SHAPE = 480, 640

    def __init__(self, mode: str, datum: Union[str, Sequence[str]] = 'image depth',
                 **kwargs):
        super().__init__(datum=datum, **kwargs)
        self.mode = mode
        self.split_file = ny.Item.get_split_file(mode)
        self.items_data = ny.Item.load_split(mode)

    def _load_image(self, data: ny.Item, offset: int = 0) -> np.ndarray:
        return self._img_from_pil(data.load_img())

    def _load_depth(self, data: ny.Item) -> np.ndarray:
        d = data.load_depth().astype(np.float32)
        return d if d.ndim == 3 else d[..., None]


@register('sintel')
class SintelDataset(EvalOnlyDataset):
    """MPI Sintel (ref `src/datasets/sintel.py:15-70`): synthetic .dpt depth."""
    VALID_DATUM = 'image depth K'
    SHAPE = 436, 1024

    def __init__(self, mode: str, datum: Union[str, Sequence[str]] = 'image depth K',
                 **kwargs):
        super().__init__(datum=datum, **kwargs)
        self.mode = mode
        self.split_file = si.Item.get_split_file(mode)
        self.items_data = si.Item.load_split(mode)

    def _load_image(self, data: si.Item, offset: int = 0) -> np.ndarray:
        return self._img_from_pil(data.load_img())

    def _load_depth(self, data: si.Item) -> np.ndarray:
        return data.load_depth()

    def _load_K(self, data: si.Item) -> np.ndarray:
        K = data.load_intrinsics()
        if self.should_resize:
            K[0] *= self.shape[1] / self.SHAPE[1]
            K[1] *= self.shape[0] / self.SHAPE[0]
        return K


@register('tum')
class TumDataset(EvalOnlyDataset):
    """TUM-RGBD (ref `src/datasets/tum.py:14-67`): Kinect png depth / 5000."""
    VALID_DATUM = 'image depth'
    SHAPE = 480, 640

    def __init__(self, mode: str, datum: Union[str, Sequence[str]] = 'image depth',
                 **kwargs):
        super().__init__(datum=datum, **kwargs)
        self.mode = mode
        self.split_file = tu.Item.get_split_file(mode)
        self.items_data = tu.Item.load_split(mode)

    def _load_image(self, data: tu.Item, offset: int = 0) -> np.ndarray:
        return self._img_from_pil(data.load_img())

    def _load_depth(self, data: tu.Item) -> np.ndarray:
        return data.load_depth()


@register('ddad')
class DdadDataset(EvalOnlyDataset):
    """DDAD val split via the lightweight DGP-JSON reader
    (ref `src/datasets/ddad.py:17-101`; first 1000 items)."""
    VALID_DATUM = 'image depth K'
    SHAPE = 1216, 1936

    def __init__(self, mode: str, datum: Union[str, Sequence[str]] = 'image depth K',
                 **kwargs):
        super().__init__(datum=datum, **kwargs)
        if mode != 'val':
            raise ValueError('DDAD is a testing dataset. Only a `val` split is provided.')
        self.mode = mode
        self.max_len = 1000
        self.split_file = dd.get_json_file()
        self.items_data = dd.load_scenes(mode)

    def _load_image(self, data: dd.Frame, offset: int = 0) -> np.ndarray:
        return self._img_from_pil(data.load_img())

    def _load_depth(self, data: dd.Frame) -> np.ndarray:
        return data.load_depth()

    def _load_K(self, data: dd.Frame) -> np.ndarray:
        K = data.load_K()
        if self.should_resize:
            K[0] *= self.shape[1] / self.SHAPE[1]
            K[1] *= self.shape[0] / self.SHAPE[0]
        return K
