"""HR-Depth decoder (PyTorch, NCHW): a dense nested skip grid with feature
squeeze & excitation on its highest-resolution column.

Counterpart of `slowtv_monodepth_tpu/models/decoders/hrdepth.py`. The grid's
cell `{row}{col}` is made from cell `{row + 1}{col - 1}` (its `conv_0`,
upsampled) and the cells `{row}0` .. `{row}{col - 1}`; column 0 holds the
encoder's features. A 4-scale encoder (ConvNeXt) gets its first stage
duplicated and upsampled, with a warning, as the JAX package does.

`state_dict()` keys are the reference's `convs.<name>` ModuleDict:
`convs.{rc}_conv_{0,1}.conv.*`, `convs.{idx}_att.se.{0,2}.weight`,
`convs.{idx}_att.conv.0.*`, `convs.{idx}_down.weight` and
`convs.outconv_{i}.0.*`. The reference also makes a `conv_0` for the row-0
cells 00-03, which its forward never uses; they are not made here
(`unused_reference_keys` names them).

In-channels are those of the tensors each conv meets, as flax infers them;
for the published encoders (channels doubling stage by stage) they are the
reference's.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch
import torch.nn as nn

from .utils import ACT, ConvBlock, conv1x1, conv3x3, upsample2x

__all__ = ['HRDepthDecoder']

ALL_IDX = ('01', '11', '21', '31', '02', '12', '22', '03', '13', '04')
ATT_IDX = ('31', '22', '13', '04')


class FSEBlock(nn.Module):
    """Upsample, concat the skips, squeeze & excitation, conv1x1 + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, upsample_mode: str = 'nearest',
                 reduction: int = 16):
        super().__init__()
        self.upsample_mode = upsample_mode
        self.se = nn.Sequential(nn.Linear(in_ch, in_ch // reduction, bias=False), nn.ReLU(),
                                nn.Linear(in_ch // reduction, in_ch, bias=False), nn.Sigmoid())
        self.conv = nn.Sequential(conv1x1(in_ch, out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor, xs_skip: list[torch.Tensor]) -> torch.Tensor:
        x = torch.cat([upsample2x(x, self.upsample_mode), *xs_skip], dim=1)
        y = self.se(x.mean(dim=(2, 3)))[:, :, None, None]
        return self.conv(x * y)


class HRDepthDecoder(nn.Module):
    """Arguments as `MonodepthDecoder`'s (no kernel switches: no stage of this
    decoder is a fused stage); `use_skip` must be True."""

    def __init__(self, num_ch_enc: Sequence[int], enc_sc: Sequence[int],
                 upsample_mode: str = 'nearest', use_skip: bool = True,
                 out_sc: Sequence[int] = (0, 1, 2, 3), out_ch: int = 1,
                 out_act: Optional[str] = 'sigmoid', pad_mode: str = 'reflect'):
        super().__init__()
        if not use_skip:
            raise ValueError('HRDepth decoder must use skip connections.')
        if out_act not in ACT:
            raise KeyError(f'Invalid activation key. ({out_act} vs. {tuple(ACT)})')
        self.upsample_mode = upsample_mode
        self.out_sc, self.out_act = list(out_sc), out_act
        self.duplicate_first = len(enc_sc) == 4
        num_ch_enc = list(num_ch_enc)
        if self.duplicate_first:
            warnings.warn('HRDepth requires 5 scales; duplicating+upsampling the first.')
            num_ch_enc = [num_ch_enc[0]] + num_ch_enc
        num_ch_dec = [ch // 2 for ch in num_ch_enc[1:]]
        num_ch_dec = [num_ch_dec[0] // 2] + num_ch_dec

        def conv0_out(row: int, col: int) -> int:
            ch = num_ch_enc[row]
            if row == 0 and col != 0:
                ch //= 2
            if row == 0 and col == 4:
                ch = num_ch_enc[1] // 2
            return ch // 2

        convs = {}
        ch = {f'{i}0': c for i, c in enumerate(num_ch_enc)}
        for idx in ALL_IDX:
            row, col = int(idx[0]), int(idx[1])
            src = f'{row + 1}{col - 1}'
            c0 = conv0_out(row + 1, col - 1)
            convs[f'{src}_conv_0'] = ConvBlock(ch[src], c0, pad_mode)
            c_cat = c0 + sum(ch[f'{row}{i}'] for i in range(col))
            if idx in ATT_IDX:
                ch[idx] = num_ch_enc[row + 1] // 2
                convs[f'{idx}_att'] = FSEBlock(c_cat, ch[idx], upsample_mode)
                continue
            if col != 1:
                convs[f'{idx}_down'] = conv1x1(c_cat, 2 * num_ch_dec[row + 1], bias=False)
                c_cat = 2 * num_ch_dec[row + 1]
            ch[idx] = num_ch_dec[row + 1]
            convs[f'{src}_conv_1'] = ConvBlock(c_cat, ch[idx], pad_mode)
        c0 = conv0_out(0, 4)
        convs['04_conv_0'] = ConvBlock(ch['04'], c0, pad_mode)
        convs['04_conv_1'] = ConvBlock(c0, num_ch_dec[0], pad_mode)
        out_ch_in = (num_ch_dec[0], ch['04'], ch['13'], ch['22'])
        for i in self.out_sc:
            convs[f'outconv_{i}'] = nn.Sequential(conv3x3(out_ch_in[i], out_ch, pad_mode))
        self.convs = nn.ModuleDict(convs)

    def unused_reference_keys(self) -> list[str]:
        """The reference's `conv_0` of the row-0 cells 00-03 (never used)."""
        return [f'convs.0{c}_conv_0.conv.{p}' for c in range(4) for p in ('weight', 'bias')]

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        act = ACT[self.out_act]
        if self.duplicate_first:
            feat = [upsample2x(feat[0], self.upsample_mode)] + list(feat)
        fmap = {f'{i}0': f for i, f in enumerate(feat)}
        for idx in ALL_IDX:
            row, col = int(idx[0]), int(idx[1])
            xs_skip = [fmap[f'{row}{i}'] for i in range(col)]
            src = f'{row + 1}{col - 1}'
            x = self.convs[f'{src}_conv_0'](fmap[src])
            if idx in ATT_IDX:
                fmap[idx] = self.convs[f'{idx}_att'](x, xs_skip)
                continue
            x = torch.cat([upsample2x(x, self.upsample_mode), *xs_skip], dim=1)
            if col != 1:
                x = self.convs[f'{idx}_down'](x)
            fmap[idx] = self.convs[f'{src}_conv_1'](x)

        x = self.convs['04_conv_0'](fmap['04'])
        x = self.convs['04_conv_1'](upsample2x(x, self.upsample_mode))
        out_feat = (x, fmap['04'], fmap['13'], fmap['22'])
        return {i: act(self.convs[f'outconv_{i}'](out_feat[i])) for i in self.out_sc}

