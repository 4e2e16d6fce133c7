"""DPT decoder (PyTorch, NCHW): residual conv units and feature fusion over a ViT
pyramid.

Counterpart of `slowtv_monodepth_tpu/models/decoders/dpt.py`: 3x3 convs to a
`num_ch_dec` working width, top-down fusion blocks (a residual unit on the skip,
one on the sum, a x2 bilinear `align_corners=True` upsample, a 1x1 out conv) and a
head per out scale (conv, x2 upsample, conv, ReLU, 1x1 conv, activation). Where odd
pyramid sizes drift by one pixel between levels, the coarser map is resized to the
skip's size first (the snap). Convs pad with zeros: `pad_mode` and `use_skip` are
accepted for the shared decoder contract and ignored, as in the JAX package (an
autoencoder's DPT decoder, built with `use_skip=False`, still fuses its skips).

`state_dict()` keys follow the MiDaS file's `scratch.*`, which `models/import_midas.py`
maps with prefixes: `layer{k}_rn` (the 3x3 convs, no bias), `refinenet{k}`
(`resConfUnit1` on the skip, absent at the coarsest level, which has none;
`resConfUnit2`; `out_conv`), k = level + 1; and `out{s}.{0,2,4}` per out scale (MiDaS's
single head `output_conv` is `out0`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .utils import ACT

__all__ = ['DptDecoder']


def _resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Bilinear, `align_corners=True` (endpoints map to endpoints)."""
    if tuple(x.shape[-2:]) == tuple(shape):
        return x
    return F.interpolate(x, size=tuple(shape), mode='bilinear', align_corners=True)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return _resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))


class ResidualConvUnit(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, ch: int, skip: bool):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(ch) if skip else None
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = nn.Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = _resize(x, skip.shape[-2:])   # the snap: odd sizes drift by a pixel
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_up2(self.resConfUnit2(x)))


class _Up2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _up2(x)


class Head(nn.Sequential):
    """conv3x3 (ch -> ch / 2), x2 upsample, conv3x3 (-> hidden), ReLU, conv1x1 (-> out_ch),
    then the activation (MiDaS's `output_conv` layout)."""

    def __init__(self, ch: int, out_ch: int, act: str, hidden: int = 32):
        super().__init__(nn.Conv2d(ch, ch // 2, 3, padding=1), _Up2(),
                         nn.Conv2d(ch // 2, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, out_ch, 1))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACT[self.act](super().forward(x))


class DptDecoder(nn.Module):
    """Arguments as `MonodepthDecoder`'s, with `num_ch_dec` the working width (256,
    published); no kernel switches (no stage of this decoder is a fused stage)."""

    def __init__(self, num_ch_enc: Sequence[int], enc_sc: Sequence[int],
                 upsample_mode: str = 'nearest', use_skip: bool = True,
                 out_sc: Sequence[int] = (0, 1, 2, 3), out_ch: int = 1,
                 out_act: Optional[str] = 'sigmoid', pad_mode: str = 'reflect',
                 num_ch_dec: int = 256):
        super().__init__()
        del enc_sc, upsample_mode, use_skip, pad_mode   # the shared contract's; unused here
        if out_act not in ACT:
            raise KeyError(f'Invalid activation key. ({out_act} vs. {tuple(ACT)})')
        self.n = len(num_ch_enc) - 1
        self.out_sc, self.out_ch = list(out_sc), out_ch
        for i, ch in enumerate(num_ch_enc):
            self.add_module(f'layer{i + 1}_rn', nn.Conv2d(ch, num_ch_dec, 3, padding=1,
                                                          bias=False))
            self.add_module(f'refinenet{i + 1}', FusionBlock(num_ch_dec, skip=i < self.n))
        for i in range(self.n, -1, -1):
            if i in self.out_sc:
                self.add_module(f'out{i}', Head(num_ch_dec, out_ch, out_act))

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        feat = [getattr(self, f'layer{i + 1}_rn')(f) for i, f in enumerate(feat)]
        out, x = {}, feat[-1]
        for i in range(self.n, -1, -1):
            x = getattr(self, f'refinenet{i + 1}')(x, None if i == self.n else feat[i])
            if i in self.out_sc:
                out[i] = getattr(self, f'out{i}')(x)
        return out
