"""Regularizers: disparity smoothness, feature peakiness and smoothness, occlusion and
predicted masks (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/regularizers.py`:
- `SmoothReg` mean-normalizes the disparity first; its gradients are
  absolute forward differences zero-padded at the end (or, with
  `use_laplacian`, the second-order ones), optionally of a 3x3 Gaussian blur
  (`use_blur`) and weighted by e^{-|grad I|} (`use_edges`);
- `FeatPeakReg` (the negated first-order feature gradients) and
  `FeatSmoothReg` (the second-order ones), FeatDepth's, on raw features,
  each optionally weighted by e^{-|grad I|} (`use_edges`);
- `OccReg` is a signed disparity mean;
- `MaskReg` is BCE(mask, 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import clip, eps, mean_normalize

__all__ = ['compute_grad', 'compute_laplacian', 'SmoothReg', 'FeatPeakReg', 'FeatSmoothReg',
           'OccReg', 'MaskReg']


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


class FeatPeakReg:
    """First-order feature peakiness: the NEGATED mean absolute feature gradients
    (a loss that rewards sharp features)."""

    def __init__(self, use_edges: bool = False):
        self.use_edges = use_edges

    def __call__(self, feat: torch.Tensor, img: torch.Tensor):
        """:param feat: (b, h, w, c) features; img (b, h, w, 3) at their size."""
        feat_dx, feat_dy = compute_grad(feat)
        with torch.no_grad():
            feat_grad = torch.sqrt(clip(feat_dx ** 2 + feat_dy ** 2, lo=eps(feat)))
        if self.use_edges:
            dx, dy = compute_grad(img, ch_mean=True)
            feat_dx = feat_dx * torch.exp(-dx)
            feat_dy = feat_dy * torch.exp(-dy)
        loss = -(feat_dx.mean() + feat_dy.mean())
        return loss, {'feat_grad': feat_grad}


class FeatSmoothReg:
    """Second-order feature smoothness: the mean absolute second-order feature
    gradients."""

    def __init__(self, use_edges: bool = False):
        self.use_edges = use_edges

    def __call__(self, feat: torch.Tensor, img: torch.Tensor):
        """:param feat: (b, h, w, c) features; img (b, h, w, 3) at their size."""
        feat_dxx, feat_dyy, feat_dxy, feat_dyx = compute_laplacian(feat)
        with torch.no_grad():
            feat_grad = torch.sqrt(clip(feat_dxx ** 2 + feat_dyy ** 2, lo=eps(feat)))
        if self.use_edges:
            dxx, dyy, dxy, dyx = compute_laplacian(img, ch_mean=True)
            feat_dxx = feat_dxx * torch.exp(-dxx)
            feat_dyy = feat_dyy * torch.exp(-dyy)
            feat_dxy = feat_dxy * torch.exp(-dxy)
            feat_dyx = feat_dyx * torch.exp(-dyx)
        loss = feat_dxx.mean() + feat_dyy.mean() + feat_dxy.mean() + feat_dyx.mean()
        return loss, {'feat_grad': feat_grad}


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
