"""Host-side photometric augmentation (numpy ColorJiggle equivalent).

Reproduces the distribution of the reference's kornia `ColorJiggle` with
brightness/contrast/saturation (0.8, 1.2) and hue (-0.1, 0.1), applied in a
random order with the same factors across target + support frames
(`same_on_batch=True`; ref `src/datasets/base_mde.py:87-91,262-274`).

Images are float32 NHWC in [0, 1]. Copy of `slowtv_monodepth_tpu/data/augment.py`.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np

__all__ = ['ColorJiggle', 'PHOTO_OP_IDS', 'adjust_brightness',
           'adjust_contrast', 'adjust_saturation', 'adjust_hue']

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0, 1)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = (img[..., :3] @ _GRAY).mean()
    return np.clip((img - mean) * factor + mean, 0, 1)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img[..., :3] @ _GRAY)[..., None]
    return np.clip(gray + (img - gray) * factor, 0, 1)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """Rotate hue by `shift` (fraction of a full turn), via HSV round trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img[..., :3].max(-1)
    minc = img[..., :3].min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-8), 0)

    dc = np.where(deltac == 0, 1, deltac)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = np.select(
        [maxc == r, maxc == g], [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc)
    h = (h / 6.0) % 1.0
    h = np.where(deltac == 0, 0.0, h)

    h = (h + shift) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6

    conds = [i == k for k in range(6)]
    r2 = np.select(conds, [v, q, p, p, t, v])
    g2 = np.select(conds, [t, v, v, q, p, p])
    b2 = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-1).astype(img.dtype)


# Op ids shared with the device replay (`core/device_transform._OPS` uses the
# same index order).
PHOTO_OP_IDS = {adjust_brightness: 0, adjust_contrast: 1,
                adjust_saturation: 2, adjust_hue: 3}


class ColorJiggle:
    """:param brightness/contrast/saturation: (lo, hi) multiplicative ranges.
    :param hue: (lo, hi) additive hue rotation range.
    Same sampled factors for every image in one call (same_on_batch).
    """

    def __init__(self, brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1),
                 rng: Optional[random.Random] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or random

    def sample(self) -> list:
        """Sample (fn, factor) pairs in a random application order."""
        ops = [
            (adjust_brightness, self.rng.uniform(*self.brightness)),
            (adjust_contrast, self.rng.uniform(*self.contrast)),
            (adjust_saturation, self.rng.uniform(*self.saturation)),
            (adjust_hue, self.rng.uniform(*self.hue)),
        ]
        self.rng.shuffle(ops)
        return ops

    @staticmethod
    def apply(imgs: np.ndarray, ops: list) -> np.ndarray:
        """Apply previously-sampled (fn, factor) pairs in order."""
        for fn, factor in ops:
            imgs = fn(imgs, factor)
        return imgs

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """:param imgs: (..., h, w, 3) float images in [0, 1]."""
        return self.apply(imgs, self.sample())
