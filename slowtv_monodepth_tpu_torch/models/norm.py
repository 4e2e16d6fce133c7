"""BatchNorm with the JAX package's running statistics.

The JAX package's BatchNorm is flax's `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)` (`slowtv_monodepth_tpu/models/encoders/resnet.py`). In train
mode it normalises with the batch's mean and biased variance, as
`nn.BatchNorm2d` does, but it updates its running statistics otherwise:

    mean <- 0.9 * mean + 0.1 * batch mean
    var  <- 0.9 * var  + 0.1 * batch variance (biased, divided by n)

flax's momentum weights the old value (torch's `momentum=0.1` is the same
weight read the other way round), and torch folds in the unbiased variance,
n / (n - 1) times larger. `BatchNorm2d` here keeps torch's module, names and
buffers (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`, so timm and reference checkpoints load as they are),
normalises through `F.batch_norm` (cuDNN on the card) and updates the buffers
under `no_grad` as flax does. `num_batches_tracked` counts the train-mode
calls, as torch's does; nothing reads it.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ['BatchNorm2d', 'FLAX_MOMENTUM']

FLAX_MOMENTUM = 0.9   # flax's: the weight of the old running value


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-5, affine, running statistics) whose train-mode
    update is flax's: biased batch variance, old value weighted by `FLAX_MOMENTUM`
    (torch's `momentum` is not read)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(FLAX_MOMENTUM).add_(mean, alpha=1 - FLAX_MOMENTUM)
            self.running_var.mul_(FLAX_MOMENTUM).add_(var, alpha=1 - FLAX_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
