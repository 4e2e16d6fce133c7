"""Dense photometric errors (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/photometric.py`: the L1 and L2
errors, and the Monodepth photometric error 0.85 SSIM + 0.15 L1. `PhotoError` sends
every stack with an SSIM term through `ops.photo_err_ssim` (kernels 7 and 8
on the card; a dtype they do not take raises), flattening an (n, b) stack
into ONE call, as the JAX package's does. The per-channel SSIM map itself is
`ops.photo.ssim_error`.
"""
from __future__ import annotations

import torch

from ..ops import clip, eps
from ..ops.photo import avg_pool3x3_reflect, photo_err_ssim

__all__ = ['DenseL1Error', 'DenseL2Error', 'PhotoError', 'avg_pool3x3_reflect']


class DenseL1Error:
    """Dense L1 averaged over channels -> (b, h, w, 1)."""

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return (pred - target).abs().mean(-1, keepdim=True)


class DenseL2Error:
    """Dense L2 distance over channels -> (b, h, w, 1), its square floored at eps."""

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        sq = ((pred - target) ** 2).sum(-1, keepdim=True)
        return torch.sqrt(clip(sq, lo=eps(pred)))


class PhotoError:
    """Weighted SSIM + L1 photometric error -> (b, h, w, 1) or (n, b, h, w, 1).

    :param weight_ssim: SSIM weight in [0, 1]; L1 takes the rest. At 0 the
        error is `DenseL1Error` alone.
    :param kernels: passed to `ops.photo_err_ssim` (False: the plain versions,
        only for timing the plain path on the card).
    """

    def __init__(self, weight_ssim: float = 0.85, kernels: bool = True):
        if not (0 <= weight_ssim <= 1):
            raise ValueError(f'Invalid SSIM weight. ({weight_ssim} vs. [0, 1])')
        self.weight_ssim = weight_ssim
        self.kernels = kernels

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """:param pred: (b, h, w, c) or (n, b, h, w, c); target (b, h, w, c)."""
        if self.weight_ssim == 0:
            return DenseL1Error()(pred, target)
        if pred.dim() == 4:
            return photo_err_ssim(pred, target, self.weight_ssim, kernels=self.kernels)
        n = pred.shape[0]
        flat = pred.reshape((-1,) + pred.shape[2:])
        tgt = target.expand((n,) + target.shape).reshape(flat.shape)
        out = photo_err_ssim(flat, tgt, self.weight_ssim, kernels=self.kernels)
        return out.reshape(pred.shape[:-1] + (1,))
