"""LR schedule factors of the epoch (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/core/schedules.py`: each factory gives
a multiplicative factor of the epoch; `parsers.get_sched` multiplies the
configured ones, as the reference's `ChainedScheduler` does.
"""
from __future__ import annotations

import math

__all__ = ['SCHEDULES', 'steplr', 'linear', 'cosine']


def steplr(step_size: int, gamma: float = 0.1):
    """Decay by `gamma` every `step_size` epochs (torch StepLR)."""
    return lambda epoch: gamma ** (epoch // step_size)


def linear(start_factor: float = 1. / 3, total_iters: int = 5, end_factor: float = 1.0):
    """Linear warmup from `start_factor` over `total_iters` epochs (torch LinearLR)."""
    return lambda epoch: start_factor + (end_factor - start_factor) * min(epoch / total_iters, 1.0)


def cosine(total_iters: int, min_factor: float = 0.0):
    """Cosine decay to `min_factor` over `total_iters` epochs."""
    def factor(epoch):
        t = min(epoch / total_iters, 1.0)
        return min_factor + (1 - min_factor) * 0.5 * (1 + math.cos(math.pi * t))
    return factor


SCHEDULES = {'steplr': steplr, 'linear': linear, 'cosine': cosine}
