"""Batch-level aspect-ratio augmentation, the KBR contribution (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/core/aspect_ratio.py`: sample one of 16
aspect ratios, take a random-size centre crop, then resize so the output has
at most `eps x ref_shape` pixels and dims that are multiples of 32; adjust K
accordingly.

- The shapes are sampled on the host with Python's `random.Random`, by the
  same calls in the same order as the JAX module, so a seed gives the same
  crop, ratio and bucket sequence in both packages.
- Crop + resize are ONE bilinear resample per tensor (`crop_resize`): output
  pixel centres map linearly into the centred crop window, and the samples
  come from `ops.grid_sample` in border mode, which is the warp kernel on the
  card.
- The set of output shapes is finite (`all_output_shapes`).
"""
from __future__ import annotations

import random as _random
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import grid_sample

__all__ = ['RATIOS', 'LABELS', 'sample_crop', 'sample_resize', 'crop_grid', 'crop_resize',
           'aspect_ratio_aug', 'all_output_shapes']

LABELS = [
    '6/13', '9/16', '3/5', '2/3', '4/5', '1/1',  # Portrait
    '5/4', '4/3', '3/2', '14/9', '5/3', '16/9', '2/1', '24/10', '33/10', '18/5',  # Landscape
]
RATIOS = [int(n) / int(d) for n, d in (i.split('/') for i in LABELS)]
RATIO2LABEL = dict(zip(RATIOS, LABELS))


def _find_closest_multiple(i: float, n: int = 32) -> int:
    return round(i / n) * n


def sample_crop(shape: Sequence[int], min: float = 0.5, max: float = 1.0,  # noqa: A002
                rng: Optional[_random.Random] = None) -> tuple[tuple[int, int], float]:
    """Sample a centre-crop shape with a random aspect ratio: 10 heights, 10
    widths, one ratio, then one of the candidates that fit."""
    assert max >= min
    rng = rng or _random
    n = 10
    hs = np.array([rng.randrange(int(shape[0] * min), int(shape[0] * max)) for _ in range(n)])
    ws = np.array([rng.randrange(int(shape[1] * min), int(shape[1] * max)) for _ in range(n)])

    r = rng.choice(RATIOS)
    hs, ws = (np.concatenate([hs, (ws / r).astype(int)]),
              np.concatenate([(r * hs).astype(int), ws]))

    valid = (hs >= 0) & (hs <= shape[0]) & (ws >= 0) & (ws <= shape[1])
    i = rng.choice(list(np.nonzero(valid)[0]))
    return (int(hs[i]), int(ws[i])), r


def sample_resize(shape: Sequence[int], ref_shape: Sequence[int],
                  eps: float = 0.8) -> tuple[int, int]:
    """Resize shape with about `eps` of the reference's pixels and dims that
    are multiples of 32 (at least 32)."""
    mul = 32
    n, n_ref = shape[0] * shape[1], ref_shape[0] * ref_shape[1]
    r = (n_ref / n) ** 0.5
    res = [_find_closest_multiple(r * i, n=mul) for i in shape]
    while res[0] * res[1] > n_ref * eps:
        res = [i - mul for i in res]
    return tuple(max(i, mul) for i in res)


def crop_grid(img: torch.Tensor, crop_hw, out_shape: tuple[int, int]) -> torch.Tensor:
    """The normalized sampling grid (b, out_h, out_w, 2) of `crop_resize` on `img`."""
    b, h, w, _ = img.shape
    oh, ow = out_shape
    ch, cw = (torch.as_tensor(v, dtype=img.dtype, device=img.device) for v in crop_hw)

    # Output pixel centres -> crop coords -> source coords (half-pixel centres).
    ys = (torch.arange(oh, dtype=img.dtype, device=img.device) + 0.5) * (ch / oh) - 0.5 + (h - ch) / 2
    xs = (torch.arange(ow, dtype=img.dtype, device=img.device) + 0.5) * (cw / ow) - 0.5 + (w - cw) / 2

    # Normalize to [-1, 1] for grid_sample (align_corners=False inverse map).
    gy = (2 * ys + 1) / h - 1
    gx = (2 * xs + 1) / w - 1
    grid = torch.stack([gx[None, :].expand(oh, ow), gy[:, None].expand(oh, ow)], -1)
    return grid.expand(b, oh, ow, 2)


def crop_resize(img: torch.Tensor, crop_hw, out_shape: tuple[int, int]) -> torch.Tensor:
    """Fused centre-crop + bilinear resize (align_corners=False semantics).

    :param img: (b, h, w, c).
    :param crop_hw: crop size (h_c, w_c), centre-anchored.
    :param out_shape: output (h, w).
    :return: (b, out_h, out_w, c).
    """
    return grid_sample(img, crop_grid(img, crop_hw, out_shape), padding_mode='border')


def _adjust_K(K: torch.Tensor, crop_hw, shape, out_shape) -> torch.Tensor:
    """`centre_crop_K` then `resize_K` for a crop of (h_c, w_c)."""
    ch, cw = crop_hw
    K = K.clone()
    # Centre crop: the principal point shifts by the crop ratio.
    K[..., 0, 2] *= cw / shape[1]
    K[..., 1, 2] *= ch / shape[0]
    # Resize: the rows scale to the new shape.
    K[..., 0, :] *= out_shape[1] / cw
    K[..., 1, :] *= out_shape[0] / ch
    return K


def aspect_ratio_aug(batch: tuple, p: float = 1.0, crop_min: float = 0.5,
                     crop_max: float = 1.0, ref_shape: Optional[Sequence[int]] = None,
                     rng: Optional[_random.Random] = None) -> tuple:
    """Apply the augmentation to a batch on the device.

    :param batch: (x, y, m) with NHWC images; `x/y['supp_imgs']` are (n, b, ...).
    :return: augmented (x, y, m); images at a bucketed shape.
    """
    rng = rng or _random
    x, y, m = batch
    sh = tuple(x['imgs'].shape[1:3])

    if rng.random() > p:
        if ref_shape and tuple(ref_shape) != sh:
            return _apply(batch, crop_hw=sh, out_shape=sample_resize(sh, ref_shape, eps=1.0))
        return batch

    ref_shape = tuple(ref_shape or sh)
    crop_shape, ratio = sample_crop(sh, crop_min, crop_max, rng=rng)
    out_shape = sample_resize(crop_shape, ref_shape, eps=0.8)
    m.setdefault('augs', []).append(
        f'{list(sh)} -> {list(crop_shape)} -> {RATIO2LABEL[ratio]} -> {list(out_shape)}')
    return _apply(batch, crop_hw=crop_shape, out_shape=out_shape)


def _apply(batch: tuple, crop_hw, out_shape: tuple[int, int]) -> tuple:
    """Resample every spatial tensor in the batch to `out_shape`."""
    x, y, m = batch
    x, y = dict(x), dict(y)
    sh = tuple(x['imgs'].shape[1:3])

    def fn(img):
        return crop_resize(img, crop_hw, out_shape)

    def fn5(img):
        return fn(img.reshape((-1,) + img.shape[2:])).reshape(
            img.shape[:2] + tuple(out_shape) + img.shape[-1:])

    for d in (x, y):
        if 'imgs' in d:
            d['imgs'] = fn(d['imgs'])
        if 'supp_imgs' in d:
            d['supp_imgs'] = fn5(d['supp_imgs'])
    if 'depth' in y:
        y['depth'] = fn(y['depth'])
    if 'depth_hints' in y:
        raise RuntimeError('Geometric augmentation should not be combined with '
                           'depth hints (interpolating depth is ill-defined).')
    if 'K' in y:
        y['K'] = _adjust_K(y['K'], crop_hw, sh, out_shape)
    return x, y, m


def all_output_shapes(src_shapes: Sequence[Sequence[int]], ref_shape: Sequence[int],
                      crop_min: float = 0.5, crop_max: float = 1.0) -> set:
    """The bucketed output shapes the augmentation can emit. Conservative:
    scans crop sizes at 8px granularity."""
    shapes = set()
    for sh in src_shapes:
        shapes.add(sample_resize(sh, ref_shape, eps=1.0))  # the p-miss path
        for r in RATIOS:
            for hh in range(int(sh[0] * crop_min), int(sh[0] * crop_max) + 1, 8):
                ww = int(r * hh)
                if 0 < ww <= sh[1]:
                    shapes.add(sample_resize((hh, ww), ref_shape, eps=0.8))
            for ww in range(int(sh[1] * crop_min), int(sh[1] * crop_max) + 1, 8):
                hh = int(ww / r)
                if 0 < hh <= sh[0]:
                    shapes.add(sample_resize((hh, ww), ref_shape, eps=0.8))
    return shapes
