"""ResNet and ResNeXt feature encoders (PyTorch, NCHW channels-last).

Counterpart of `slowtv_monodepth_tpu/models/encoders/resnet.py`: timm's
`features_only` ResNets, 5 feature maps at strides [2, 4, 8, 16, 32] (the
stem's ReLU, then layer1..layer4). Module names are timm's, so `state_dict()`
keys are the ones a timm ResNet (and the reference checkpoints) carry:
`conv1`, `bn1`, `layer{s}.{i}.conv{k}` / `bn{k}` and
`layer{s}.{i}.downsample.{0,1}` (the JAX package's `downsample_conv` /
`downsample_bn`).

Convs, BatchNorm and the max-pool are cuDNN's on the card; in the JAX package
they are XLA ops, and none reaches a Pallas kernel. BatchNorm is
`models.norm.BatchNorm2d`: flax's running statistics. The max-pool pads with
-inf, as flax's `nn.max_pool(padding=((1, 1), (1, 1)))` does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..norm import BatchNorm2d

__all__ = ['ResNetEncoder', 'RESNET_SPECS']

_CH_BASIC, _CH_BOTTLENECK = (64, 64, 128, 256, 512), (64, 256, 512, 1024, 2048)
_R = (2, 4, 8, 16, 32)
RESNET_SPECS = {
    'resnet18': dict(block='basic', layers=(2, 2, 2, 2), channels=_CH_BASIC, reductions=_R),
    'resnet34': dict(block='basic', layers=(3, 4, 6, 3), channels=_CH_BASIC, reductions=_R),
    'resnet50': dict(block='bottleneck', layers=(3, 4, 6, 3), channels=_CH_BOTTLENECK,
                     reductions=_R),
    'resnet101': dict(block='bottleneck', layers=(3, 4, 23, 3), channels=_CH_BOTTLENECK,
                      reductions=_R),
    # ResNeXt: grouped bottleneck convs. The ssl / swsl variants are the same
    # architecture with other pretrained weights (`cfg/abl_pretrained/resnext101_pt_*`).
    'resnext101_32x8d': dict(block='bottleneck', layers=(3, 4, 23, 3), groups=32,
                             width_per_group=8, channels=_CH_BOTTLENECK, reductions=_R),
}
RESNET_SPECS['ssl_resnext101_32x8d'] = RESNET_SPECS['resnext101_32x8d']
RESNET_SPECS['swsl_resnext101_32x8d'] = RESNET_SPECS['resnext101_32x8d']


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), BatchNorm2d(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        del groups, base_width  # a bottleneck's; timm's basic block takes them too
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(in_ch, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, grouped 3x3 (ResNeXt: `groups` of `base_width * planes / 64` channels), 1x1."""
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * base_width / 64) * groups
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, groups=groups, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """ResNet backbone: 5 feature maps at strides [2, 4, 8, 16, 32].

    :param block: {'basic', 'bottleneck'}.
    :param layers: blocks per stage, e.g. (2, 2, 2, 2) for resnet18.
    :param in_chans: input channels (6 for the pose net's image pairs).
    :param groups, width_per_group: ResNeXt's grouped 3x3 convs.
    """

    def __init__(self, block: str = 'basic', layers=(2, 2, 2, 2), in_chans: int = 3,
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        if block not in ('basic', 'bottleneck'):
            raise KeyError(f'Invalid ResNet block. ({block} vs. ("basic", "bottleneck"))')
        cls = BasicBlock if block == 'basic' else Bottleneck
        self.conv1 = nn.Conv2d(in_chans, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        in_ch, planes = 64, 64
        for stage, n_blocks in enumerate(layers):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                down = i == 0 and (stride != 1 or in_ch != planes * cls.expansion)
                blocks.append(cls(in_ch, planes, stride, down, groups, width_per_group))
                in_ch = planes * cls.expansion
            setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))
            planes *= 2
        self.n_stages = len(layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in range(self.n_stages):
            x = getattr(self, f'layer{stage + 1}')(x)
            feats.append(x)
        return feats
