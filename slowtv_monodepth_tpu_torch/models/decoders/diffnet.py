"""DiffNet decoder (PyTorch, NCHW): channel-attention skip connections.

Counterpart of `slowtv_monodepth_tpu/models/decoders/diffnet.py`. A stage
with an encoder skip is an `AttentionBlock` (upsample, concat, squeeze &
excitation, conv3x3 + ReLU), a stage without one an `UpsampleBlock`
(ConvBlock, upsample, ConvBlock).

`state_dict()` keys are the reference's `convs.<name>` ModuleDict:
`convs.upconv_{i}.layers.0.fc.{0,2}.weight` and `convs.upconv_{i}.layers.1.*`
(attention stages), `convs.upconv_{i}.{0,2}.conv.*` (upsample stages) and
`convs.outconv_{i}.*`. The reference makes an out conv for each of the
scales 0-3 whatever `out_sc` is; the ones outside `out_sc` are never used and
are not made here (`unused_reference_keys` names them).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .utils import ACT, ConvBlock, Upsample2x, conv3x3, upsample2x

__all__ = ['DiffNetDecoder']


class ChannelAttention(nn.Module):
    """Squeeze & excitation: x * sigmoid(fc2(relu(fc1(mean over pixels))))."""

    def __init__(self, ch: int, ratio: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(ch, ch // ratio, bias=False), nn.ReLU(),
                                nn.Linear(ch // ratio, ch, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class AttentionBlock(nn.Module):
    """Upsample + skip concat + channel attention + conv3x3 + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, upsample_mode: str = 'nearest',
                 pad_mode: str = 'reflect'):
        super().__init__()
        self.upsample_mode = upsample_mode
        self.layers = nn.Sequential(ChannelAttention(in_ch), conv3x3(in_ch, out_ch, pad_mode),
                                    nn.ReLU())

    def forward(self, x: torch.Tensor, x_skip: torch.Tensor) -> torch.Tensor:
        return self.layers(torch.cat([upsample2x(x, self.upsample_mode), x_skip], dim=1))


class UpsampleBlock(nn.Sequential):
    """ConvBlock + x2 upsample + ConvBlock, for a stage without a skip."""

    def __init__(self, in_ch: int, out_ch: int, upsample_mode: str = 'nearest',
                 pad_mode: str = 'reflect'):
        super().__init__(ConvBlock(in_ch, out_ch, pad_mode), Upsample2x(upsample_mode),
                         ConvBlock(out_ch, out_ch, pad_mode))


class DiffNetDecoder(nn.Module):
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
        self.out_sc, self.out_ch, self.out_act = list(out_sc), out_ch, out_act
        self.convs = nn.ModuleDict()
        ch = num_ch_enc[-1]
        for i in range(4, -1, -1):
            if self._has_skip(i):
                ch_in = ch + num_ch_enc[self.enc_sc.index(2 ** i)]
                self.convs[f'upconv_{i}'] = AttentionBlock(ch_in, self.num_ch_dec[i],
                                                           upsample_mode, pad_mode)
            else:
                self.convs[f'upconv_{i}'] = UpsampleBlock(ch, self.num_ch_dec[i],
                                                          upsample_mode, pad_mode)
            ch = self.num_ch_dec[i]
            if i in self.out_sc:
                self.convs[f'outconv_{i}'] = conv3x3(ch, out_ch, pad_mode)

    def _has_skip(self, i: int) -> bool:
        return self.use_skip and 2 ** i in self.enc_sc

    def unused_reference_keys(self) -> list[str]:
        """The reference's out convs at scales outside `out_sc` (never used)."""
        return [f'convs.outconv_{i}.{p}' for i in range(4) if i not in self.out_sc
                for p in ('weight', 'bias')]

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        act = ACT[self.out_act]
        out = {}
        x = feat[-1]
        for i in range(4, -1, -1):
            if self._has_skip(i):
                x = self.convs[f'upconv_{i}'](x, feat[self.enc_sc.index(2 ** i)])
            else:
                x = self.convs[f'upconv_{i}'](x)
            if i in self.out_sc:
                out[i] = act(self.convs[f'outconv_{i}'](x))
        return out

