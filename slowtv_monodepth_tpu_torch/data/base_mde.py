"""Monocular-depth dataset base (image/support/depth/K datum family).

Parity with `src/datasets/base_mde.py:17-301`: support-frame loading including
the stereo frame (idx 0) with `T_stereo`, randomized support offsets via
`get_supp_scale`, horizontal-flip + photometric-jiggle augmentation, ImageNet
standardization transform, an MDE-specific collate that transposes
`supp_imgs` to (n, b, ...), and the `SuppImageNotFoundError` retry hook.

All images are float32 NHWC in [0, 1] (standardized in `transform`).
Copy of `slowtv_monodepth_tpu/data/base_mde.py`.
"""
from __future__ import annotations

import random
from abc import abstractmethod
from typing import Any, Optional, Sequence, Union

import numpy as np

from .augment import ColorJiggle
from .base import BaseDataset

__all__ = ['MdeBaseDataset', 'SuppImageNotFoundError', 'IMAGENET_MEAN', 'IMAGENET_STD']

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class SuppImageNotFoundError(FileNotFoundError):
    """Support frame (e.g. video edge) missing -> retry another item
    (ref `src/typing.py:35-37`)."""


class MdeBaseDataset(BaseDataset, retry_exc=SuppImageNotFoundError):
    """:param shape: Target (h, w) to resize to (None keeps `SHAPE`).
    :param datum: Datatypes to load.
    :param supp_idxs: Support frame offsets (0 = stereo pair).
    :param randomize_supp: If True, scale the support offset randomly per item.
    :param augmentations: {photo, flip, ...} per-augmentation probabilities.
    """
    VALID_DATUM = 'image support depth K'

    def __init__(self,
                 shape: Optional[tuple] = None,
                 datum: Union[str, Sequence[str]] = 'image K',
                 supp_idxs: Optional[Union[int, Sequence[int]]] = None,
                 randomize_supp: bool = False,
                 augmentations: Optional[dict] = None,
                 device_transform: bool = False,
                 transfer_uint8: bool = False,
                 **kwargs):
        super().__init__(datum=datum, **kwargs)
        self.shape = tuple(shape) if shape else tuple(self.SHAPE)
        self.supp_idxs = supp_idxs if supp_idxs is not None else []
        self.randomize_supp = randomize_supp
        self.should_resize = shape is not None
        self.augmentations = augmentations or {}
        # Input-pipeline option: ship ONLY the raw `y` images and the
        # sampled photo-jiggle parameters; the standardized `x` images are
        # recreated on device (`core/device_transform.derive_x`), halving
        # host->device image traffic. `play()` is unavailable in this mode.
        self.device_transform = device_transform
        # Further opt-in 4x cut: ship the y images as uint8 (round(v*255));
        # the device widens back to f32/255. Exact when the dataset reads
        # 8-bit sources at native resolution; after a resize it quantizes
        # interpolated values at 1/255, finer than the source content, in the
        # same spirit as the bf16 warp-source option (`trainer.warp_bf16`).
        self.transfer_uint8 = transfer_uint8
        if transfer_uint8 and not device_transform:
            raise ValueError('transfer_uint8 requires device_transform.')

        if isinstance(self.supp_idxs, int):
            self.supp_idxs = [self.supp_idxs]
        self.supp_idxs = list(self.supp_idxs)

        self.prob_flip = self.augmentations.get('flip', 0 if self.augmentations else 0.5)
        self.prob_photo = self.augmentations.get('photo', 0 if self.augmentations else 0.5)
        self.photo = ColorJiggle()

    def _to_img(self, img) -> np.ndarray:
        """Finalize a loaded PIL image (after any PIL-side resize).

        f32 [0, 1] normally; raw uint8 under `transfer_uint8` — PIL resizes
        interpolate in uint8 BEFORE this conversion, so keeping uint8 end to
        end is bit-identical to converting to f32 and re-rounding, at ~1/4
        of the host-side cost (the f32 conversion dominates item loading).
        """
        if self.transfer_uint8:
            return np.ascontiguousarray(np.asarray(img))
        from .base import img_to_f32
        return img_to_f32(img)

    # ------------------------------------------------------------- properties
    @property
    def h(self) -> int:
        return self.shape[0]

    @property
    def w(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> tuple:
        """(w, h) for PIL/cv2 resize calls."""
        return self.w, self.h

    @property
    @abstractmethod
    def SHAPE(self):
        """Original image shape (H, W) (class attribute)."""

    @property
    def H(self) -> int:
        return self.SHAPE[0]

    @property
    def W(self) -> int:
        return self.SHAPE[1]

    @property
    def SIZE(self) -> tuple:
        return self.W, self.H

    # ------------------------------------------------------------- validation
    def validate_args(self) -> None:
        super().validate_args()
        if self.h > self.w:
            self.logger.warning(f'Image height={self.h} > width={self.w}. '
                                f'Expected (height, width) order.')
        for i in self.supp_idxs:
            if self.randomize_supp and abs(i) not in {0, 1}:
                raise ValueError(f'Invalid supplementary index when randomizing. '
                                 f'({i} vs. {{+1, 0, -1}})')
        if self.supp_idxs and not self.has('support'):
            raise ValueError('Support indexes were provided, but `support` not in `datum`.')
        if self.has('support') and not self.supp_idxs:
            raise ValueError('Support images were requested, but no indexes were provided.')

    # -------------------------------------------------------------- collating
    @classmethod
    def collate_fn(cls, items: Sequence[tuple]) -> tuple:
        """Stack + transpose support frames to (n, b, h, w, c)
        (ref `base_mde.py:158-176`)."""
        x, y, m = super().collate_fn(items)
        if 'supp_idxs' in x:
            x['supp_idxs'] = x['supp_idxs'][0]  # Identical across the batch.
            if 'supp_imgs' in x:  # Absent under `device_transform`.
                x['supp_imgs'] = np.swapaxes(x['supp_imgs'], 0, 1).copy()
            y['supp_imgs'] = np.swapaxes(y['supp_imgs'], 0, 1).copy()
        return x, y, m

    # ---------------------------------------------------------------- loading
    def load_image(self, data: Any, batch: tuple) -> tuple:
        x, y, m = batch
        x['imgs'] = self._load_image(data)
        y['imgs'] = x['imgs'].copy()
        return batch

    @abstractmethod
    def _load_image(self, data: Any, offset: int = 0) -> np.ndarray:
        """Load target image as (h, w, 3) float32 [0, 1]."""

    def load_support(self, data: Any, batch: tuple) -> tuple:
        """Load all support frames incl. stereo (ref `base_mde.py:190-208`)."""
        x, y, m = batch
        x['supp_idxs'] = np.array(self.supp_idxs)

        supp, k = [], self.get_supp_scale(data)
        m['supp'] = str(k)
        for i in self.supp_idxs:
            i *= k
            if i == 0:
                supp.append(self._load_stereo_image(data))
                y['T_stereo'] = self._load_stereo_T(data)
            else:
                supp.append(self._load_image(data, offset=i))

        x['supp_imgs'] = np.stack(supp)
        y['supp_imgs'] = x['supp_imgs'].copy()
        return batch

    def get_supp_scale(self, data: Any) -> int:
        """Offset multiplier for support frames (randomized in subclasses)."""
        return 1

    def _load_stereo_image(self, data: Any) -> np.ndarray:
        raise NotImplementedError(f'{self.__class__.__name__} has no stereo pair.')

    def _load_stereo_T(self, data: Any) -> np.ndarray:
        raise NotImplementedError(f'{self.__class__.__name__} has no stereo pair.')

    def load_depth(self, data: Any, batch: tuple) -> tuple:
        batch[1]['depth'] = self._load_depth(data)
        return batch

    @abstractmethod
    def _load_depth(self, data: Any) -> np.ndarray:
        """Load GT depth as (h, w, 1) float32."""

    def load_K(self, data: Any, batch: tuple) -> tuple:
        batch[1]['K'] = self._load_K(data)
        return batch

    @abstractmethod
    def _load_K(self, data: Any) -> np.ndarray:
        """Load (4, 4) camera intrinsics."""

    # ----------------------------------------------------------- augmentation
    def augment(self, batch: tuple) -> tuple:
        if random.random() <= self.prob_flip:
            batch = self.apply_flip_aug(batch)
        if random.random() <= self.prob_photo:
            batch = self.apply_photo_aug(batch)
        return batch

    def apply_flip_aug(self, batch: tuple) -> tuple:
        """Horizontal flip of ALL images (incl. non-augmented `y` copies) and
        the stereo baseline sign (ref `base_mde.py:246-260`)."""
        x, y, m = batch
        m['augs'] += '[FlipLR]'
        flip = lambda a, ax=1: np.ascontiguousarray(np.flip(a, axis=ax))  # noqa: E731

        x['imgs'], y['imgs'] = flip(x['imgs']), flip(y['imgs'])
        if self.supp_idxs:
            x['supp_imgs'] = flip(x['supp_imgs'], ax=-2)
            y['supp_imgs'] = flip(y['supp_imgs'], ax=-2)
            if 'T_stereo' in y:
                y['T_stereo'][0, 3] *= -1
        if 'depth' in y:
            y['depth'] = flip(y['depth'])
        return batch

    def apply_photo_aug(self, batch: tuple) -> tuple:
        """Colour jiggle on `x` only, same factors across target + support.

        Under `device_transform` the sampled (op order, factor) sequence is
        recorded instead of applied; `core/device_transform.derive_x` replays
        it on device with the identical math.
        """
        x, y, m = batch
        m['augs'] += '[Photo]'
        ops = self.photo.sample()
        if self.device_transform:
            from .augment import PHOTO_OP_IDS
            x['photo_order'] = np.array([PHOTO_OP_IDS[fn] for fn, _ in ops],
                                        np.int32)
            x['photo_factors'] = np.array([f for _, f in ops], np.float32)
            x['photo_on'] = True  # Plain bool: collates to a (b,) array.
            return batch
        imgs = x['imgs'][None]
        if self.supp_idxs:
            imgs = np.concatenate((imgs, x['supp_imgs']))
        imgs = ColorJiggle.apply(imgs, ops)
        x['imgs'] = imgs[0]
        if self.supp_idxs:
            x['supp_imgs'] = imgs[1:]
        return batch

    def transform(self, batch: tuple) -> tuple:
        """ImageNet standardization of `x` (ref `base_mde.py:276-281`).

        Under `device_transform` the `x` images are dropped instead (the
        device recreates them from `y`); only the jiggle parameters ride.
        """
        x = batch[0]
        if self.device_transform:
            x.pop('imgs', None)
            x.pop('supp_imgs', None)
            x.setdefault('photo_order', np.arange(4, dtype=np.int32))
            x.setdefault('photo_factors', np.ones(4, np.float32))
            x.setdefault('photo_on', False)
            if self.transfer_uint8:
                # `_to_img` keeps images uint8 end to end; quantize here only
                # if a subclass loader produced f32 anyway.
                y = batch[1]
                for k in ('imgs', 'supp_imgs'):
                    if k in y and y[k].dtype != np.uint8:
                        y[k] = np.round(y[k] * 255).astype(np.uint8)
            return batch
        x['imgs'] = (x['imgs'] - IMAGENET_MEAN) / IMAGENET_STD
        if self.supp_idxs:
            x['supp_imgs'] = (x['supp_imgs'] - IMAGENET_MEAN) / IMAGENET_STD
        return batch

    # ------------------------------------------------------------- displaying
    def create_axs(self):
        import matplotlib.pyplot as plt
        _, axs = plt.subplots(1 + len(self.supp_idxs) + ('depth' in self.datum))
        if isinstance(axs, plt.Axes):
            axs = np.array([axs])
        plt.tight_layout()
        return axs

    def show(self, batch: tuple, axs) -> None:
        from ..tools import rgb_from_disp
        x, y, m = batch
        if 'imgs' not in x:
            raise RuntimeError(
                'show()/play() need host-side x images; construct the dataset '
                'with device_transform=False for visual debugging.')
        i = 0
        axs[i].imshow(np.clip(x['imgs'] * IMAGENET_STD + IMAGENET_MEAN, 0, 1))
        if self.supp_idxs:
            for ax, im in zip(axs[1:], x['supp_imgs']):
                i += 1
                ax.imshow(np.clip(im * IMAGENET_STD + IMAGENET_MEAN, 0, 1))
        if 'depth' in y:
            i += 1
            axs[i].imshow(rgb_from_disp(y['depth'][..., 0], invert=True))
