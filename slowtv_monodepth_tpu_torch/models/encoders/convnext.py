"""ConvNeXt feature encoders (PyTorch, NCHW channels-last).

Counterpart of `slowtv_monodepth_tpu/models/encoders/convnext.py`, with
timm's module names, so `state_dict()` keys are the ones a timm ConvNeXt
(and the reference checkpoints) carry: `stem.{0,1}`,
`stages.{s}.downsample.{0,1}` (s > 0), and
`stages.{s}.blocks.{i}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}`.

Block: x + gamma * fc2(gelu(fc1(LN(dwconv7x7(x))))). The depthwise conv goes
through `ops.depthwise_conv` (the Hopper kernel on the card); LN and the MLP
run on the NHWC view of the channels-last activation, which is contiguous.
With `fused_blocks` the whole block is one call of `ops.fused_convnext_block`
(one kernel launch on the card) on the same parameters, so `state_dict()` keys
do not change and checkpoints interchange, as in the JAX package.

Stem and downsample convs use padding 0. Flax's 'SAME' padding equals that
when the input height and width are multiples of 32, as the serving path's
inputs are.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import (depthwise_conv, depthwise_conv_plain, fused_convnext_block,
                    fused_convnext_block_plain)

__all__ = ['ConvNeXtEncoder', 'CONVNEXT_SPECS']

_R = (4, 8, 16, 32)
CONVNEXT_SPECS = {
    'convnext_atto': dict(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320)),
    'convnext_femto': dict(depths=(2, 2, 6, 2), dims=(48, 96, 192, 384)),
    'convnext_pico': dict(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512)),
    'convnext_nano': dict(depths=(2, 2, 8, 2), dims=(80, 160, 320, 640)),
    'convnext_tiny': dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    'convnext_small': dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    'convnext_base': dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    'convnext_large': dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}
for _spec in CONVNEXT_SPECS.values():
    _spec.update(channels=_spec['dims'], reductions=_R)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (timm `LayerNorm2d`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu: str):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.gelu = gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.gelu))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, gelu: str, kernels: bool, fused: bool = False,
                 ls_init: float = 1e-6):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, gelu)
        self.gamma = nn.Parameter(torch.full((dim,), ls_init))
        self.dwconv = depthwise_conv if kernels else depthwise_conv_plain
        self.fused = fused
        self.block = fused_convnext_block if kernels else fused_convnext_block_plain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = self.block(x.permute(0, 2, 3, 1), self.conv_dw.weight, self.conv_dw.bias,
                           self.norm.weight, self.norm.bias, self.mlp.fc1.weight,
                           self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                           self.gamma, approximate=self.mlp.gelu == 'tanh')
            return y.permute(0, 3, 1, 2)
        y = self.dwconv(x.permute(0, 2, 3, 1), self.conv_dw.weight,
                        self.conv_dw.bias)
        y = self.gamma * self.mlp(self.norm(y))
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, gelu: str,
                 kernels: bool, first: bool, fused: bool = False):
        super().__init__()
        self.downsample = nn.Identity() if first else nn.Sequential(
            LayerNorm2d(in_dim, eps=1e-6), nn.Conv2d(in_dim, dim, 2, stride=2))
        self.blocks = nn.Sequential(
            *[ConvNeXtBlock(dim, gelu, kernels, fused) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class ConvNeXtEncoder(nn.Module):
    """ConvNeXt backbone: 4 feature maps at strides [4, 8, 16, 32].

    :param gelu: 'exact' (erf, the default and the reference's) or 'tanh'.
    :param kernels: route the depthwise convs through the hand-written kernel
        (`ops.depthwise_conv`); False runs the plain PyTorch version, which is
        what a timing of the plain path on the card needs.
    :param fused_blocks: run every block as one fused call
        (`ops.fused_convnext_block`: one kernel launch per block on the card,
        forward only there until its backward kernel is ported); off by
        default: the unfused block's matrix products are cuBLAS's.
    """

    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 in_chans: int = 3, gelu: str = 'exact', kernels: bool = True,
                 fused_blocks: bool = False):
        super().__init__()
        if gelu not in ('exact', 'tanh'):
            raise KeyError(f'Invalid gelu flavor. ({gelu} vs. ("exact", "tanh"))')
        approx = 'none' if gelu == 'exact' else 'tanh'
        self.stem = nn.Sequential(nn.Conv2d(in_chans, dims[0], 4, stride=4),
                                  LayerNorm2d(dims[0], eps=1e-6))
        self.stages = nn.Sequential(*[
            ConvNeXtStage(dims[max(s - 1, 0)], dims[s], depths[s], approx,
                          kernels, first=s == 0, fused=fused_blocks) for s in range(4)])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        x = self.stem(x)
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats
