"""SuperDepth decoder (PyTorch, NCHW): sub-pixel (pixel shuffle) upsampling.

Counterpart of `slowtv_monodepth_tpu/models/decoders/superdepth.py`. A stage
is ConvBlock, `SubPixelConv(2)` + ReLU, skip concat, ConvBlock. The output at
scale 0 is a conv3x3; at scale i > 0 a ConvBlock to `out_ch` channels and a
`SubPixelConv(2**i)`, so EVERY output is at full resolution, not h / 2**i.

`SubPixelConv` is a 3x3 conv grouped by its input channels (`groups=ch_in`,
r * r outputs a group) with ZERO padding, as the reference's plain
`nn.Conv2d(..., padding=1)`, then `F.pixel_shuffle`, whose channel order
(input channel c r^2 + di r + dj -> offset (di, dj) of channel c) is the JAX
package's `pixel_shuffle`.

`state_dict()` keys are the reference's plain list `decoder.{idx}`: per
stage `decoder.{k}.0.conv.*` (ConvBlock), `decoder.{k}.1.conv.*`
(SubPixelConv) and `decoder.{k + 1}.conv.*`; then per `out_sc` the out conv
`decoder.{k}.0.*` (scale 0) or the pair `decoder.{k}.0.conv.*`,
`decoder.{k}.1.conv.*`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .utils import ACT, ConvBlock, conv3x3

__all__ = ['SubPixelConv', 'SuperdepthDecoder']


class SubPixelConv(nn.Module):
    """Grouped zero-padded 3x3 conv to r^2 channels an input channel, then a
    pixel shuffle: (b, c, h, w) -> (b, c, h r, w r)."""

    def __init__(self, ch_in: int, up_factor: int):
        super().__init__()
        self.up_factor = up_factor
        self.conv = nn.Conv2d(ch_in, ch_in * up_factor ** 2, 3, padding=1, groups=ch_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), self.up_factor)


class SuperdepthDecoder(nn.Module):
    """Arguments as `MonodepthDecoder`'s (no kernel switches: no stage of this
    decoder is a fused stage). `upsample_mode` is not read: every upsample is
    a sub-pixel conv."""
    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, num_ch_enc: Sequence[int], enc_sc: Sequence[int],
                 upsample_mode: str = 'nearest', use_skip: bool = True,
                 out_sc: Sequence[int] = (0, 1, 2, 3), out_ch: int = 1,
                 out_act: Optional[str] = 'sigmoid', pad_mode: str = 'reflect'):
        super().__init__()
        del upsample_mode
        if out_act not in ACT:
            raise KeyError(f'Invalid activation key. ({out_act} vs. {tuple(ACT)})')
        self.enc_sc, self.use_skip = list(enc_sc), use_skip
        self.out_sc, self.out_act = list(out_sc), out_act
        convs, self.idx = [], {}
        ch = num_ch_enc[-1]
        for i in range(4, -1, -1):
            dec = self.num_ch_dec[i]
            self.idx[f'upconv_{i}_0'] = len(convs)
            convs.append(nn.Sequential(ConvBlock(ch, dec, pad_mode), SubPixelConv(dec, 2),
                                       nn.ReLU()))
            ch = dec + (num_ch_enc[self.enc_sc.index(2 ** i)] if self._has_skip(i) else 0)
            self.idx[f'upconv_{i}_1'] = len(convs)
            convs.append(ConvBlock(ch, dec, pad_mode))
            ch = dec
        for i in self.out_sc:
            self.idx[f'outconv_{i}'] = len(convs)
            dec = self.num_ch_dec[i]
            convs.append(nn.Sequential(conv3x3(dec, out_ch, pad_mode)) if i == 0 else
                         nn.Sequential(ConvBlock(dec, out_ch, pad_mode),
                                       SubPixelConv(out_ch, 2 ** i)))
        self.decoder = nn.ModuleList(convs)

    def _has_skip(self, i: int) -> bool:
        return self.use_skip and 2 ** i in self.enc_sc

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        act = ACT[self.out_act]
        out = {}
        x = feat[-1]
        for i in range(4, -1, -1):
            x = [self.decoder[self.idx[f'upconv_{i}_0']](x)]
            if self._has_skip(i):
                x.append(feat[self.enc_sc.index(2 ** i)])
            x = self.decoder[self.idx[f'upconv_{i}_1']](torch.cat(x, dim=1))
            if i in self.out_sc:
                out[i] = act(self.decoder[self.idx[f'outconv_{i}']](x))
        return out
