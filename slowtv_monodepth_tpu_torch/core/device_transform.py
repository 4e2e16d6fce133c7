"""Device-side derivation of the standardized net inputs `x` from the raw
loss targets `y` (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/core/device_transform.py`. A dataset
with `device_transform: true` ships ONLY the raw `y` images plus, per item,
a (4,) op order, (4,) factors and a gate; this module replays the sampled
colour jiggle on the device and standardizes, term for term as
`data/augment.py` does on the host, which halves the host-to-device bytes.

Derivation runs right after the batch reaches the device and BEFORE the
aspect-ratio augmentation, so the chain is jiggle -> standardize ->
crop/resize as in the host pipeline (clipping does not commute with
resizing).

Items whose photo augmentation did not fire pass through by a select on the
gate: the hue HSV round trip is not an exact identity at shift 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.base_mde import IMAGENET_MEAN, IMAGENET_STD

__all__ = ['derive_batch', 'derive_x', 'needs_derive']

_GRAY = (0.299, 0.587, 0.114)


def _gray(img: torch.Tensor) -> torch.Tensor:
    return img[..., :3] @ img.new_tensor(_GRAY)


def _brightness(img, factor):
    return torch.clamp(img * factor, 0, 1)


def _contrast(img, factor):
    # Joint mean over the item's whole (target + support) stack, as the host
    # `adjust_contrast` on the stacked array.
    mean = _gray(img).mean()
    return torch.clamp((img - mean) * factor + mean, 0, 1)


def _saturation(img, factor):
    gray = _gray(img)[..., None]
    return torch.clamp(gray + (img - gray) * factor, 0, 1)


def _hue(img, shift):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img[..., :3].amax(-1)
    minc = img[..., :3].amin(-1)
    v = maxc
    deltac = maxc - minc
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    s = torch.where(maxc > 0, deltac / torch.clamp(maxc, min=1e-8), zero)

    dc = torch.where(deltac == 0, one, deltac)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = torch.where(deltac == 0, zero, h)

    h = (h + shift) % 1.0

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int64) % 6

    def pick(vals):  # vals[i] per pixel
        return torch.gather(torch.stack(vals, -1), -1, i[..., None])[..., 0]

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], -1).to(img.dtype)


_OPS = (_brightness, _contrast, _saturation, _hue)


def _jiggle(stack: torch.Tensor, order, factors) -> torch.Tensor:
    """One item's (1+n, h, w, 3) stack through its sampled op sequence."""
    for op, factor in zip(order, factors):
        stack = _OPS[op](stack, factor)
    return stack


def _host(v) -> list:
    """A per-item parameter array (numpy, or a tensor on any device) as a list."""
    return (v.cpu() if isinstance(v, torch.Tensor) else np.asarray(v)).tolist()


def needs_derive(x: dict) -> bool:
    """True when the loader shipped a derive-on-device batch (no x images)."""
    return 'imgs' not in x and 'photo_order' in x


def derive_batch(x: dict, y: dict):
    """Widen uint8-shipped `y` images (`transfer_uint8` datasets) to float32
    [0, 1], then recreate `x`. Other y keys (depth, K, ...) pass through."""
    y = dict(y)
    for k in ('imgs', 'supp_imgs'):
        if k in y and y[k].dtype == torch.uint8:
            y[k] = y[k].to(torch.float32) / 255.0
    return derive_x(x, y), y


def derive_x(x: dict, y: dict) -> dict:
    """Recreate the standardized net-input dict from the raw `y` images.

    :param x: collated x WITHOUT images: photo_order (b, 4) int, photo_factors
        (b, 4) float32, photo_on (b,) bool, as numpy arrays or tensors (+ any
        passthrough keys).
    :param y: raw loss-target dict: imgs (b, h, w, 3) [+ supp_imgs (n, b, ...)].
    :return: x with imgs/supp_imgs jiggled + ImageNet-standardized.
    """
    imgs = y['imgs']
    supp = y.get('supp_imgs')
    stack = imgs[None] if supp is None else torch.cat([imgs[None], supp], 0)

    # The op order is a handful of integers per item that the host sampled:
    # `_place` leaves them on the host (numpy), so reading them costs no
    # device sync. Loop over the items that fired; the rest pass through.
    on = _host(x['photo_on'])
    if any(on):
        order = _host(x['photo_order'])
        factors = _host(x['photo_factors'])
        items = [(_jiggle(stack[:, i], order[i], factors[i]) if on[i] else stack[:, i])
                 for i in range(len(on))]
        stack = torch.stack(items, 1)
    stack = (stack - stack.new_tensor(IMAGENET_MEAN)) / stack.new_tensor(IMAGENET_STD)

    out = {k: v for k, v in x.items()
           if k not in ('photo_order', 'photo_factors', 'photo_on')}
    out['imgs'] = stack[0]
    if supp is not None:
        out['supp_imgs'] = stack[1:]
    return out
