"""Depth conversions of the serving path (PyTorch).

Counterpart of `slowtv_monodepth_tpu/ops/geometry.py:43-83` (`to_scaled`,
`to_inv`, `blend_stereo`); the pose and view-synthesis math of that module
belongs to the training path and is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ['to_scaled', 'to_inv', 'blend_stereo']


def to_scaled(disp: torch.Tensor, min: float = 0.01,  # noqa: A002
              max: Optional[float] = 100):  # noqa: A002
    """Sigmoid disparity [0, 1] -> (scaled disparity, scaled depth).

    disp' = (1/min - 1/max) * disp + 1/max.
    """
    if min <= 0:
        raise ValueError(f'Min depth must be greater than 0. ({min})')
    if max and (max < min):
        raise ValueError(f'Max depth must be greater than min. ({max} vs. {min})')
    i_max, i_min = 1.0 / min, (1.0 / max) if max else 0.0
    disp = (i_max - i_min) * disp + i_min
    return disp, to_inv(disp)


def to_inv(depth: torch.Tensor) -> torch.Tensor:
    """Linear depth -> disparity, zeroed where depth <= 0."""
    eps = torch.finfo(depth.dtype).eps
    return (depth > 0) / depth.clamp(min=eps)


def blend_stereo(disp_l: torch.Tensor, disp_r: torch.Tensor) -> torch.Tensor:
    """Monodepth stereo blending of (*, h, w) maps (width last, NCHW).

    The 5% leftmost columns come from the right disparity, the 5% rightmost
    from the left one, with a linear ramp and the mean in between.
    """
    if disp_l.shape != disp_r.shape:
        raise ValueError(f'Non-matching shapes. ({disp_l.shape} vs. {disp_r.shape})')
    w = disp_l.shape[-1]
    x = torch.linspace(0.0, 1.0, w, dtype=disp_l.dtype, device=disp_l.device)
    mask_l = (20 * (x - 0.05)).clamp(0.0, 1.0)
    mask_r = mask_l.flip(0)
    mask_mu = 1.0 - mask_l - mask_r
    disp_mu = (disp_l + disp_r) / 2
    return mask_r * disp_l + mask_l * disp_r + mask_mu * disp_mu
