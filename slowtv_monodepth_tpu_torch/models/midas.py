"""MiDaS DPT baseline model (intel-isl `DPT_Large`), PyTorch.

Counterpart of `slowtv_monodepth_tpu/models/midas.py:MidasDPT`: the ViT-L/16 trunk
with the `project` readout (`encoders.vit.ViTEncoder`) and a DPT decoder
(`decoders.dpt.DptDecoder`) with one full-resolution ReLU head at scale 0. The
released checkpoint maps onto it with prefixes (`models/import_midas.py`).

Input: (b, 3, h, w) images normalised with mean = std = 0.5 (not ImageNet's), h and
w multiples of 32 (`core.predictors.MidasPredictor.preprocess`). Output: scaleless
inverse depth, (b, 1, h, w), non-negative.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .decoders.dpt import DptDecoder
from .encoders.vit import VIT_SPECS, ViTEncoder
from .init import init_like_flax

__all__ = ['MidasDPT']


class MidasDPT(nn.Module):
    """DPT_Large: `state_dict()` keys `encoder.*` (the file's `pretrained.*`) and
    `decoder.*` (its `scratch.*`; `scratch.output_conv` is `decoder.out0`)."""

    def __init__(self, backbone: str = 'vitl16_384'):
        super().__init__()
        spec = VIT_SPECS[backbone]
        self.encoder = ViTEncoder(dim=spec['dim'], depth=spec['depth'], heads=spec['heads'],
                                  hooks=spec['hooks'], channels=spec['channels'],
                                  readout='project')
        self.decoder = DptDecoder(num_ch_enc=spec['channels'], enc_sc=spec['reductions'],
                                  out_sc=(0,), out_ch=1, out_act='relu')
        init_like_flax(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x.contiguous(memory_format=torch.channels_last)))[0]
