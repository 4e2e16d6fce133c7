"""Tensor utilities (PyTorch).

Counterpart of `slowtv_monodepth_tpu/ops/ops.py`: `resize` (torch's own
bilinear `align_corners=False` without antialias, which the JAX `resize`
reproduces; its bicubic is `jax.image.resize`'s), `image_resize`
(`jax.image.resize`'s linear and cubic: antialiased when shrinking),
`upsample2x_nearest`, ImageNet `standardize` and `unstandardize` on NCHW
tensors (the networks' layout); `resize_like` and `mean_normalize` on NHWC
tensors (the losses' layout, as in the JAX package); `eps`; and `clip`,
whose gradient follows `jnp.clip`'s, not `torch.clamp`'s.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'standardize', 'unstandardize', 'resize',
           'image_resize', 'resize_like', 'upsample2x_nearest', 'eps', 'clip', 'mean_normalize']


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


def unstandardize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Undo `standardize` on an NCHW image batch: x std + mean."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    return x * std + mean


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5 (`jax.image.resize`'s 'cubic')."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {'linear': lambda x: np.maximum(0.0, 1.0 - np.abs(x)), 'cubic': _keys_cubic}


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, method: str, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize` along one axis, as its
    `compute_weight_mat` draws them (in float64, then cast): half-pixel centres, the
    kernel stretched by 1 / scale when shrinking (the antialiasing), each column
    normalised to sum 1, and nothing sampled past the border (no clamped taps)."""
    inv = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    w = _KERNELS[method](np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
                         / max(inv, 1.0))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def image_resize(x: torch.Tensor, shape: Sequence[int], method: str = 'linear') -> torch.Tensor:
    """`jax.image.resize(x, shape, method)` on an NCHW tensor, for 'linear' and 'cubic'
    (Keys, a = -0.5): a separable product with `_resize_weights` along each axis whose size
    changes. Shrinking, it low-passes (antialias): neither `F.interpolate` without
    `antialias=True` nor cv2's a = -0.75 bicubic is this function."""
    h, w = x.shape[-2:]
    nh, nw = shape
    if nh != h:
        x = torch.einsum('...hw,hH->...Hw', x, _resize_weights(h, nh, method, x.dtype, x.device))
    if nw != w:
        x = torch.einsum('...hw,wW->...hW', x, _resize_weights(w, nw, method, x.dtype, x.device))
    return x


def resize(x: torch.Tensor, shape: tuple[int, int],
           method: str = 'bilinear') -> torch.Tensor:
    """Resize NCHW images to `shape=(h, w)`.

    `bilinear` is `F.interpolate(align_corners=False, antialias=False)`:
    2-tap at half-pixel centres, up and down, as the reference does. `bicubic` is
    the JAX `resize`'s, `jax.image.resize(..., 'cubic')` (`image_resize`).
    """
    if tuple(x.shape[-2:]) == tuple(shape):
        return x
    if method == 'bilinear':
        return F.interpolate(x, size=tuple(shape), mode='bilinear',
                             align_corners=False, antialias=False)
    if method == 'nearest':
        return F.interpolate(x, size=tuple(shape), mode='nearest')
    if method == 'bicubic':
        return image_resize(x, shape, 'cubic')
    raise ValueError(f"Invalid resize method '{method}' (bilinear|nearest|bicubic)")


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def resize_like(x: torch.Tensor, other: torch.Tensor,
                method: str = 'bilinear') -> torch.Tensor:
    """Resize NHWC `x` to the spatial size of NHWC `other` (no antialias)."""
    out = resize(x.permute(0, 3, 1, 2), tuple(other.shape[1:3]), method)
    return out.permute(0, 2, 3, 1)
