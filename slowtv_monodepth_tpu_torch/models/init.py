"""Initial weights as the JAX package draws them.

Every conv and dense layer of the JAX package's ConvNeXt encoders, monodepth
decoders and pose heads takes flax's defaults: a `lecun_normal` kernel
(`nn.initializers.variance_scaling(1.0, 'fan_in', 'truncated_normal')`) and a
zero bias (`slowtv_monodepth_tpu/models/encoders/convnext.py:43-45` for the
depthwise conv; `nn.Conv` / `nn.Dense` elsewhere); the ResNet encoders' convs
have no bias. LayerNorm starts at 1 / 0 and the ConvNeXt layer scale at 1e-6,
which the modules set themselves. BatchNorm starts as flax's `nn.BatchNorm`:
scale 1, bias 0, running mean 0 and variance 1 (and a counter of 0).

fan_in is the receptive field times the input channels of one group:
`prod(weight.shape[1:])` in PyTorch's (out, in / groups, kh, kw) and
(out, in) layouts, so 49 for a 7x7 depthwise conv, as flax counts its
(7, 7, 1, C) kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ['init_like_flax', 'TRUNC_STD']

# Standard deviation of a unit normal truncated to [-2, 2]: flax divides the
# target deviation by it so that the truncated draw keeps variance 1 / fan_in.
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(net: nn.Module) -> nn.Module:
    """Redraw every `nn.Conv2d` / `nn.Linear` weight of `net` as flax's
    `lecun_normal` and zero its bias; reset every `nn.LayerNorm` to 1 / 0 and
    every BatchNorm to 1 / 0 with running statistics 0 / 1.
    Draws from torch's global generator (the loop seeds it). Returns `net`."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = math.prod(m.weight.shape[1:])
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return net
