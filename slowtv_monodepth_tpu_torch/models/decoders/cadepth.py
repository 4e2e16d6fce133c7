"""CADepth decoder (PyTorch, NCHW): structure-perception self-attention on
the bottleneck, detail-emphasis channel attention in every stage.

Counterpart of `slowtv_monodepth_tpu/models/decoders/cadepth.py`. A stage is
ConvBlock, upsample, skip concat, `DetailEmphasis`, ConvBlock. The
`DetailEmphasis` BatchNorm is `models.norm.BatchNorm2d`: in train mode it
normalises with the batch's statistics and updates its running statistics
as flax does (the JAX package's `batch_stats`); in eval mode it reads them.

`state_dict()` keys are the reference's plain list `decoder.{idx}`: per
stage, from 4 down to 0, `decoder.{k}` (upconv_i_0), `decoder.{k + 1}`
(upconv_i_1) and `decoder.{k + 2}` (the detail emphasis: `conv.0` its
conv3x3, `conv.1` its BatchNorm with running statistics, `att.1` and `att.3`
its 1x1 convs), then one out conv per `out_sc`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..norm import BatchNorm2d
from .utils import ACT, ConvBlock, conv1x1, conv3x3, upsample2x

__all__ = ['CaDepthDecoder']


class StructurePerception(nn.Module):
    """Channel self-attention: x + softmax(max(A) - A) v, A = v v^T over pixels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.flatten(2)  # (b, c, hw)
        att = torch.einsum('bcn,bdn->bcd', v, v)
        att = att.amax(dim=-1, keepdim=True) - att
        return x + torch.einsum('bcd,bdn->bcn', att.softmax(dim=-1), v).reshape(x.shape)


class DetailEmphasis(nn.Module):
    """conv3x3 + BatchNorm + ReLU, then x + x * (squeeze & excitation of x)."""

    def __init__(self, ch: int, pad_mode: str = 'reflect'):
        super().__init__()
        self.conv = nn.Sequential(conv3x3(ch, ch, pad_mode), BatchNorm2d(ch), nn.ReLU())
        self.att = nn.Sequential(nn.AdaptiveAvgPool2d(1), conv1x1(ch, ch), nn.ReLU(),
                                 conv1x1(ch, ch), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x + x * self.att(x)


class CaDepthDecoder(nn.Module):
    """Arguments as `MonodepthDecoder`'s (no kernel switches: no stage of this
    decoder is a fused stage)."""
    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, num_ch_enc: Sequence[int], enc_sc: Sequence[int],
                 upsample_mode: str = 'nearest', use_skip: bool = True,
                 out_sc: Sequence[int] = (0, 1, 2, 3), out_ch: int = 1,
                 out_act: Optional[str] = 'sigmoid', pad_mode: str = 'reflect'):
        super().__init__()
        if out_act not in ACT:
            raise KeyError(f'Invalid activation key. ({out_act} vs. {tuple(ACT)})')
        self.enc_sc, self.use_skip = list(enc_sc), use_skip
        self.upsample_mode = upsample_mode
        self.out_sc, self.out_act = list(out_sc), out_act
        self.sp = StructurePerception()
        convs, self.idx = [], {}
        ch = num_ch_enc[-1]
        for i in range(4, -1, -1):
            self.idx[f'upconv_{i}_0'] = len(convs)
            convs.append(ConvBlock(ch, self.num_ch_dec[i], pad_mode))
            ch = self.num_ch_dec[i]
            if self._has_skip(i):
                ch += num_ch_enc[self.enc_sc.index(2 ** i)]
            self.idx[f'upconv_{i}_1'] = len(convs)
            convs.append(ConvBlock(ch, self.num_ch_dec[i], pad_mode))
            self.idx[f'detail_emphasis_{i}'] = len(convs)
            convs.append(DetailEmphasis(ch, pad_mode))
            ch = self.num_ch_dec[i]
        for i in self.out_sc:
            self.idx[f'outconv_{i}'] = len(convs)
            convs.append(conv3x3(self.num_ch_dec[i], out_ch, pad_mode))
        self.decoder = nn.ModuleList(convs)

    def _has_skip(self, i: int) -> bool:
        return self.use_skip and 2 ** i in self.enc_sc

    def _conv(self, name: str) -> nn.Module:
        return self.decoder[self.idx[name]]

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        act = ACT[self.out_act]
        out = {}
        x = self.sp(feat[-1])
        for i in range(4, -1, -1):
            x = [upsample2x(self._conv(f'upconv_{i}_0')(x), self.upsample_mode)]
            if self._has_skip(i):
                x.append(feat[self.enc_sc.index(2 ** i)])
            x = self._conv(f'detail_emphasis_{i}')(torch.cat(x, dim=1))
            x = self._conv(f'upconv_{i}_1')(x)
            if i in self.out_sc:
                out[i] = act(self._conv(f'outconv_{i}')(x))
        return out
