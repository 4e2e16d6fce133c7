"""Tensor utilities (PyTorch).

Counterpart of `slowtv_monodepth_tpu/ops/ops.py`: `resize` (torch's own
bilinear `align_corners=False` without antialias, which the JAX `resize`
reproduces), `upsample2x_nearest` and ImageNet `standardize` on NCHW
tensors (the networks' layout); `resize_like` and `mean_normalize` on NHWC
tensors (the losses' layout, as in the JAX package); `eps`; and `clip`,
whose gradient follows `jnp.clip`'s, not `torch.clamp`'s.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'standardize', 'resize',
           'resize_like', 'upsample2x_nearest', 'eps', 'clip', 'mean_normalize']


def eps(x: Optional[torch.Tensor] = None) -> float:
    """Machine epsilon of the tensor's dtype (default float32, ~1.19e-7)."""
    return torch.finfo(torch.float32 if x is None else x.dtype).eps


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """`jnp.clip`: max with `lo`, then min with `hi`.

    The gradient is `jnp.clip`'s: 1 strictly inside, 0 outside, and 0.5 at a
    value exactly on a bound (the VJP of max/min splits a tie). `torch.clamp`
    passes the full gradient at the bound instead. Ties are real on the
    training path: an identity warp puts coords exactly on the image border.
    """
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def mean_normalize(x: torch.Tensor, dims: Sequence[int] = (1, 2)) -> torch.Tensor:
    """Divide by the spatial mean (NHWC dims (1, 2))."""
    m = x.mean(dim=tuple(dims), keepdim=True)
    return x / clip(m, lo=eps(x))


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


def resize_like(x: torch.Tensor, other: torch.Tensor,
                method: str = 'bilinear') -> torch.Tensor:
    """Resize NHWC `x` to the spatial size of NHWC `other` (no antialias)."""
    out = resize(x.permute(0, 3, 1, 2), tuple(other.shape[1:3]), method)
    return out.permute(0, 2, 3, 1)
