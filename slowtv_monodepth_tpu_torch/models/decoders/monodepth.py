"""Monodepth(2) decoder (PyTorch, NCHW).

Counterpart of `slowtv_monodepth_tpu/models/decoders/monodepth.py`. Five
stages of [conv3x3+ELU, x2 upsample, optional encoder skip concat,
conv3x3+ELU], with a 3x3 output conv + activation per output scale.

Parameters sit in one `decoder` ModuleList in the reference's order
(upconv_4_0, upconv_4_1, ..., upconv_0_1, then one outconv per out_sc),
so `state_dict()` keys are `decoder.{idx}.conv.*` / `decoder.{idx}.*`.

A stage with reflect padding, no skip, an output at its scale, one output
channel, nearest upsampling and a sigmoid runs as ONE fused stage
(`ops.fused_upconv_stage`: the Hopper kernel on the card). In the KBR model
those are the two full-resolution stages, 1 and 0. The fused stage is
differentiable (its backward is a kernel too), so serving and training run
the same stages; `fused_stages=False` runs them as plain modules, as the
stages with a skip always do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...ops import fused_upconv_stage, fused_upconv_stage_plain
from .utils import ACT, ConvBlock, conv3x3, upsample2x

__all__ = ['MonodepthDecoder']


class MonodepthDecoder(nn.Module):
    """:param num_ch_enc: Channels per encoder stage.
    :param enc_sc: Downsampling factor per encoder stage.
    :param upsample_mode: {'nearest', 'bilinear'}.
    :param use_skip: If True, concat the matching encoder stage at each scale.
    :param out_sc: Output scales as 2**s.
    :param out_ch: Output channels per scale.
    :param out_act: Activation {'sigmoid', 'relu', 'none'}.
    :param pad_mode: {'reflect', 'zeros'}.
    :param kernels: route the fused stages through the hand-written kernel;
        False runs the plain PyTorch version of the same stage.
    :param fused_stages: run the skip-less stages as fused stages (the
        default, as the JAX package's switch). False runs them as plain modules.
    """
    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, num_ch_enc: Sequence[int], enc_sc: Sequence[int],
                 upsample_mode: str = 'nearest', use_skip: bool = True,
                 out_sc: Sequence[int] = (0, 1, 2, 3), out_ch: int = 1,
                 out_act: Optional[str] = 'sigmoid', pad_mode: str = 'reflect',
                 kernels: bool = True, fused_stages: bool = True):
        super().__init__()
        if out_act not in ACT:
            raise KeyError(f'Invalid activation key. ({out_act} vs. {tuple(ACT)})')
        self.enc_sc = list(enc_sc)
        self.upsample_mode = upsample_mode
        self.use_skip = use_skip
        self.out_sc = list(out_sc)
        self.out_ch = out_ch
        self.out_act = out_act
        self.pad_mode = pad_mode
        self.fused_stages = fused_stages
        self.stage = fused_upconv_stage if kernels else fused_upconv_stage_plain

        convs, self.idx = [], {}
        for i in range(4, -1, -1):
            ch_in = num_ch_enc[-1] if i == 4 else self.num_ch_dec[i + 1]
            self.idx[f'upconv_{i}_0'] = len(convs)
            convs.append(ConvBlock(ch_in, self.num_ch_dec[i], pad_mode))
            ch_in = self.num_ch_dec[i]
            if self._has_skip(i):
                ch_in += num_ch_enc[self.enc_sc.index(2 ** i)]
            self.idx[f'upconv_{i}_1'] = len(convs)
            convs.append(ConvBlock(ch_in, self.num_ch_dec[i], pad_mode))
        for i in self.out_sc:
            self.idx[f'outconv_{i}'] = len(convs)
            convs.append(conv3x3(self.num_ch_dec[i], out_ch, pad_mode))
        self.decoder = nn.ModuleList(convs)

    def _has_skip(self, i: int) -> bool:
        return self.use_skip and 2 ** i in self.enc_sc

    def _fused(self, i: int) -> bool:
        """The structural conditions of the fused stage."""
        return (self.fused_stages and self.pad_mode == 'reflect' and not self._has_skip(i)
                and i in self.out_sc and self.out_ch == 1
                and self.upsample_mode == 'nearest' and self.out_act == 'sigmoid')

    def _conv(self, name: str) -> nn.Module:
        return self.decoder[self.idx[name]]

    def forward(self, feat: list[torch.Tensor]) -> dict[int, torch.Tensor]:
        act = ACT[self.out_act]
        out = {}
        x = feat[-1]
        for i in range(4, -1, -1):
            if self._fused(i):
                a, b = self._conv(f'upconv_{i}_0').conv, self._conv(f'upconv_{i}_1').conv
                o = self._conv(f'outconv_{i}')
                # The stage takes NHWC; cuDNN's reflect-padded convs may hand
                # back NCHW-contiguous x (a copy then), a fused stage NHWC (free).
                x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
                x, disp = self.stage(x, a.weight, a.bias, b.weight, b.bias,
                                     o.weight, o.bias)
                x, out[i] = x.permute(0, 3, 1, 2), disp.permute(0, 3, 1, 2)
                continue

            x = [upsample2x(self._conv(f'upconv_{i}_0')(x), self.upsample_mode)]
            if self._has_skip(i):
                x.append(feat[self.enc_sc.index(2 ** i)])
            x = self._conv(f'upconv_{i}_1')(torch.cat(x, dim=1))
            if i in self.out_sc:
                out[i] = act(self._conv(f'outconv_{i}')(x))
        return out
