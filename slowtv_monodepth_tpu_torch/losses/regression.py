"""Supervised regression losses: proxy depth hints and virtual-stereo consistency
(PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/regression.py`: the l1, log-l1
and berHu (dynamic delta = 0.2 x the largest error) criteria, an optional
inversion of both inputs into disparity, and a valid-pixel mask that
normalizes the summed error.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import clip, eps, to_inv
from .regularizers import _abs

__all__ = ['l1_loss', 'log_l1_loss', 'berhu_loss', 'RegressionLoss']


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _abs(pred - target)


def log_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.log1p(l1_loss(pred, target))


def berhu_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.2,
               dynamic: bool = True) -> torch.Tensor:
    """berHu: L1 up to delta, scaled L2 above. The dynamic delta is taken over
    every pixel, masked ones included, as in the JAX package."""
    diff = l1_loss(pred, target)
    d = delta * diff.amax() if dynamic else torch.tensor(delta, dtype=pred.dtype,
                                                          device=pred.device)
    diff_delta = (diff ** 2 + d ** 2) / (2 * d + eps(pred))
    return torch.where(diff <= d, diff, diff_delta)


class RegressionLoss:
    """Masked dense regression loss (`depth_regr`, `stereo_const`).

    :param loss_name: Criterion {l1, log_l1, berhu}.
    :param invert: Convert both (depth) inputs into disparity first.
    :param use_automask: The handler gates the hints by the Depth-Hints
        automask (`core.handlers.depth_regr`); the loss itself only reads it.
    """

    def __init__(self, loss_name: str = 'berhu', invert: bool = False,
                 use_automask: bool = False):
        self.loss_name = loss_name
        self.invert = invert
        self.use_automask = use_automask
        self.criterion = {'l1': l1_loss, 'log_l1': log_l1_loss, 'berhu': berhu_loss}[loss_name]

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
        """-> (sum of the masked error / max(1, mask sum), {err_regr, mask_regr})."""
        if self.invert:
            pred, target = to_inv(pred), to_inv(target)
        mask = torch.ones_like(target) if mask is None else mask.to(pred.dtype)
        err = mask * self.criterion(pred, target)
        loss = err.sum() / clip(mask.sum(), lo=1.0)
        return loss, {'err_regr': err, 'mask_regr': mask}
