"""Tensor utilities of the serving path (PyTorch, NCHW).

Counterpart of `slowtv_monodepth_tpu/ops/ops.py`: `resize` (torch's own
bilinear `align_corners=False` without antialias, which the JAX `resize`
reproduces), `upsample2x_nearest` and ImageNet `standardize`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'standardize', 'resize',
           'upsample2x_nearest']

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def standardize(x: torch.Tensor, mean=IMAGENET_MEAN,
                std=IMAGENET_STD) -> torch.Tensor:
    """ImageNet-standardize an NCHW image batch in [0, 1]."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    return (x - mean) / std


def resize(x: torch.Tensor, shape: tuple[int, int],
           method: str = 'bilinear') -> torch.Tensor:
    """Resize NCHW images to `shape=(h, w)`.

    `bilinear` is `F.interpolate(align_corners=False, antialias=False)`:
    2-tap at half-pixel centres, up and down, as the reference does.
    """
    if tuple(x.shape[-2:]) == tuple(shape):
        return x
    if method == 'bilinear':
        return F.interpolate(x, size=tuple(shape), mode='bilinear',
                             align_corners=False, antialias=False)
    if method == 'nearest':
        return F.interpolate(x, size=tuple(shape), mode='nearest')
    raise ValueError(f"Invalid resize method '{method}' (bilinear|nearest)")


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
