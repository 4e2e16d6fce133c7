"""Shared decoder building blocks (PyTorch, NCHW).

Counterpart of `slowtv_monodepth_tpu/models/decoders/utils.py`, with the
reference's module layout: `conv3x3` is a bare `nn.Conv2d` (key `weight`),
`ConvBlock` nests it as `conv` (key `conv.weight`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize, upsample2x_nearest

__all__ = ['ACT', 'conv3x3', 'ConvBlock', 'upsample2x']

ACT = {
    'sigmoid': torch.sigmoid,
    'relu': F.relu,
    'none': lambda x: x,
    None: lambda x: x,
}


def conv3x3(in_ch: int, out_ch: int, pad_mode: str = 'reflect') -> nn.Conv2d:
    """3x3 conv with reflect (reference) or zeros padding."""
    if pad_mode not in ('reflect', 'zeros'):
        raise KeyError(f"Invalid pad_mode '{pad_mode}' (reflect|zeros)")
    return nn.Conv2d(in_ch, out_ch, 3, padding=1, padding_mode=pad_mode)


class ConvBlock(nn.Module):
    """conv3x3 + ELU."""

    def __init__(self, in_ch: int, out_ch: int, pad_mode: str = 'reflect'):
        super().__init__()
        self.conv = conv3x3(in_ch, out_ch, pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


def upsample2x(x: torch.Tensor, mode: str = 'nearest') -> torch.Tensor:
    if mode == 'nearest':
        return upsample2x_nearest(x)
    return resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), method=mode)
