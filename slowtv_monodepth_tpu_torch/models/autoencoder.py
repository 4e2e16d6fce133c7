"""Image autoencoder network (PyTorch, NCHW channels-last).

Counterpart of `slowtv_monodepth_tpu/models/autoencoder.py:AutoencoderNet`:
an encoder and a skip-less Monodepth decoder with 3 sigmoid output channels
(nearest upsampling). Its features feed FeatDepth's feature reconstruction,
peakiness and smoothness; its images its own reconstruction loss.

`state_dict()` keys, prefixed with `nets.autoencoder.`, are the reference
checkpoint's (`slowtv_monodepth_tpu/models/import_reference.py:_convert_autoencoder`
reads them): `encoder.*` (timm's names, BatchNorm buffers included) and
`decoder.decoder.{idx}.*` (ONE decoder, not `DepthNet`'s `decoders` dict).

The decoder has 3 output channels, so no stage runs as the fused stage
(kernels 3 and 4 take one), as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn

from .decoders import DECODERS, kernel_kw
from .encoders import create_encoder
from .init import init_like_flax

__all__ = ['AutoencoderNet']


class AutoencoderNet(nn.Module):
    """:param enc_name: Encoder key (`CONVNEXT_SPECS` or `RESNET_SPECS`; FeatDepth's
        is ResNet-18).
    :param pretrained: Look for pretrained encoder weights when training
        starts (see `DepthNet`).
    :param dec_name: Decoder type (`decoders.DECODERS`; FeatDepth's is 'monodepth'). The
        DPT decoder fuses its skips even here, where `use_skip=False`, as the JAX one does.
    :param out_scales: Multi-scale outputs as 2**s.
    :param gelu: {'exact', 'tanh'} GELU flavor of a ConvNeXt encoder's blocks.
    :param dec_pad_mode: {'reflect', 'zeros'} decoder conv padding.
    :param kernels: run a ConvNeXt encoder's depthwise-conv kernel (see `DepthNet`).

    Initial weights are flax's (`models.init.init_like_flax`).
    """

    def __init__(self, enc_name: str = 'resnet18', pretrained: bool = True,
                 dec_name: str = 'monodepth',
                 out_scales: Union[int, Sequence[int]] = (0, 1, 2, 3),
                 gelu: str = 'exact', dec_pad_mode: str = 'reflect', kernels: bool = True):
        super().__init__()
        self.enc_name, self.pretrained = enc_name, pretrained
        if dec_name not in DECODERS:
            raise KeyError(f'Invalid decoder. ({dec_name} vs. {sorted(DECODERS)})')
        self.out_sc = [out_scales] if isinstance(out_scales, int) else list(out_scales)
        self.encoder, num_ch_enc, enc_sc = create_encoder(enc_name, gelu=gelu, kernels=kernels)
        self.decoder = DECODERS[dec_name](
            num_ch_enc=num_ch_enc, enc_sc=enc_sc, upsample_mode='nearest', use_skip=False,
            out_sc=self.out_sc, out_ch=3, out_act='sigmoid', pad_mode=dec_pad_mode,
            **kernel_kw(dec_name, kernels=kernels))
        init_like_flax(self)

    def forward(self, x: torch.Tensor) -> dict:
        """:param x: (b, 3, h, w) standardized images, h and w multiples of 32.
        :return: {autoenc_feats: [(b, c, h/r, w/r)] per encoder stage,
                  autoenc_imgs: {s: (b, 3, h/2**s, w/2**s)}}.
        """
        feat = self.encoder(x.contiguous(memory_format=torch.channels_last))
        return {'autoenc_feats': feat, 'autoenc_imgs': dict(sorted(self.decoder(feat).items()))}
