"""Regularizers: disparity smoothness, occlusion and predicted masks (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/regularizers.py`:
- `SmoothReg` mean-normalizes the disparity first; its gradients are
  absolute forward differences zero-padded at the end (or, with
  `use_laplacian`, the second-order ones), optionally of a 3x3 Gaussian blur
  (`use_blur`) and weighted by e^{-|grad I|} (`use_edges`);
- `OccReg` is a signed disparity mean;
- `MaskReg` is BCE(mask, 1).
The feature regularizers (`FeatPeakReg`, `FeatSmoothReg`) belong to the
FeatDepth recipe (ROADMAP queue A item 9b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import clip, eps, mean_normalize

__all__ = ['compute_grad', 'compute_laplacian', 'SmoothReg', 'OccReg', 'MaskReg']


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient: 1 at 0 (`torch.abs` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _reflect_pad1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pad one row or column on each side of `dim`, reflected (no edge repeat)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)], dim)


def _gaussian_blur3x3(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable 3x3 Gaussian blur of (b, h, w, c) with reflect padding
    (kornia's), rows first, then columns."""
    r = torch.arange(-1, 2, dtype=x.dtype, device=x.device)
    k = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    xp = _reflect_pad1(x, 1)
    x = k[0] * xp[:, :-2] + k[1] * xp[:, 1:-1] + k[2] * xp[:, 2:]
    xp = _reflect_pad1(x, 2)
    return k[0] * xp[:, :, :-2] + k[1] * xp[:, :, 1:-1] + k[2] * xp[:, :, 2:]


def compute_grad(x: torch.Tensor, use_blur: bool = False, ch_mean: bool = False):
    """Absolute forward-difference gradients of (b, h, w, c), zero-padded
    to the input shape -> (dx, dy), each (b, h, w, c|1)."""
    if use_blur:
        x = _gaussian_blur3x3(x)
    dx = F.pad(_abs(x[:, :, :-1] - x[:, :, 1:]), (0, 0, 0, 1))
    dy = F.pad(_abs(x[:, :-1] - x[:, 1:]), (0, 0, 0, 0, 0, 1))
    if ch_mean:
        dx, dy = dx.mean(-1, keepdim=True), dy.mean(-1, keepdim=True)
    return dx, dy


def compute_laplacian(x: torch.Tensor, use_blur: bool = False, ch_mean: bool = False):
    """Absolute second-order gradients -> (dxx, dyy, dxy, dyx)."""
    dx, dy = compute_grad(x, use_blur=use_blur)
    dxx, dxy = compute_grad(dx, use_blur=use_blur)
    dyx, dyy = compute_grad(dy, use_blur=use_blur)
    if ch_mean:
        dxx, dxy, dyx, dyy = (d.mean(-1, keepdim=True) for d in (dxx, dxy, dyx, dyy))
    return dxx, dyy, dxy, dyx


class SmoothReg:
    """Edge-aware disparity smoothness, first or (`use_laplacian`) second order."""

    def __init__(self, use_edges: bool = False, use_laplacian: bool = False,
                 use_blur: bool = False):
        self.use_edges = use_edges
        self.use_laplacian = use_laplacian
        self.use_blur = use_blur
        self._fn = compute_laplacian if use_laplacian else compute_grad

    def __call__(self, disp: torch.Tensor, img: torch.Tensor):
        """:param disp: (b, h, w, 1) sigmoid disparity; img (b, h, w, 3)."""
        disp = mean_normalize(disp)  # Important! Otherwise degenerates to zero.
        disp_dx, disp_dy = self._fn(disp, use_blur=self.use_blur)[:2]
        img_dx, img_dy = self._fn(img, use_blur=self.use_blur, ch_mean=True)[:2]
        with torch.no_grad():  # summaries, as the JAX package returns them
            disp_grad = torch.sqrt(clip(disp_dx ** 2 + disp_dy ** 2, lo=eps(disp)))
            img_grad = torch.sqrt(clip(img_dx ** 2 + img_dy ** 2, lo=eps(disp)))
        if self.use_edges:
            disp_dx = disp_dx * torch.exp(-img_dx)
            disp_dy = disp_dy * torch.exp(-img_dy)
        loss = disp_dx.mean() + disp_dy.mean()
        return loss, {'disp_grad': disp_grad, 'image_grad': img_grad}


class OccReg:
    """Disparity occlusion regularizer: the mean disparity, negated with `invert`."""

    def __init__(self, invert: bool = False):
        self.invert = invert
        self._sign = -1.0 if invert else 1.0

    def __call__(self, x: torch.Tensor):
        return self._sign * x.mean(), {}


class MaskReg:
    """BCE(mask, 1) explainability regularizer."""

    def __call__(self, x: torch.Tensor):
        return -torch.log(clip(x, lo=eps(x), hi=1.0)).mean(), {}
