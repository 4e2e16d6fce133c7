"""Edge-aware disparity smoothness (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/regularizers.py:SmoothReg` and
`compute_grad`: the disparity is mean-normalized first, gradients are
absolute forward differences zero-padded at the end, optionally weighted
by e^{-|grad I|}. The Laplacian and blur options are not ported (ROADMAP
queue A item 9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import clip, eps, mean_normalize

__all__ = ['compute_grad', 'SmoothReg']


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient: 1 at 0 (`torch.abs` gives 0)."""
    return torch.where(x >= 0, x, -x)


def compute_grad(x: torch.Tensor, ch_mean: bool = False):
    """Absolute forward-difference gradients of (b, h, w, c), zero-padded
    to the input shape -> (dx, dy), each (b, h, w, c|1)."""
    dx = F.pad(_abs(x[:, :, :-1] - x[:, :, 1:]), (0, 0, 0, 1))
    dy = F.pad(_abs(x[:, :-1] - x[:, 1:]), (0, 0, 0, 0, 0, 1))
    if ch_mean:
        dx, dy = dx.mean(-1, keepdim=True), dy.mean(-1, keepdim=True)
    return dx, dy


class SmoothReg:
    """Edge-aware disparity smoothness."""

    def __init__(self, use_edges: bool = False, use_laplacian: bool = False,
                 use_blur: bool = False):
        if use_laplacian or use_blur:
            raise NotImplementedError('SmoothReg use_laplacian / use_blur are not '
                                      'ported yet (ROADMAP queue A item 9).')
        self.use_edges = use_edges

    def __call__(self, disp: torch.Tensor, img: torch.Tensor):
        """:param disp: (b, h, w, 1) sigmoid disparity; img (b, h, w, 3)."""
        disp = mean_normalize(disp)  # Important! Otherwise degenerates to zero.
        disp_dx, disp_dy = compute_grad(disp)
        img_dx, img_dy = compute_grad(img, ch_mean=True)
        with torch.no_grad():  # summaries, as the JAX package returns them
            disp_grad = torch.sqrt(clip(disp_dx ** 2 + disp_dy ** 2, lo=eps(disp)))
            img_grad = torch.sqrt(clip(img_dx ** 2 + img_dy ** 2, lo=eps(disp)))
        if self.use_edges:
            disp_dx = disp_dx * torch.exp(-img_dx)
            disp_dy = disp_dy * torch.exp(-img_dy)
        loss = disp_dx.mean() + disp_dy.mean()
        return loss, {'disp_grad': disp_grad, 'image_grad': img_grad}
