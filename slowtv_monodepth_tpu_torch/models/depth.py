"""Monocular depth network (PyTorch, NCHW channels-last).

Counterpart of `slowtv_monodepth_tpu/models/depth.py:DepthNet`: the same
fields and the same output dict, with NCHW tensors. `state_dict()` keys,
prefixed with `nets.depth.`, are the reference Lightning checkpoint's
(`slowtv_monodepth_tpu/models/import_reference.py` reads them): `encoder.*`
(timm's ConvNeXt or ResNet names, BatchNorm buffers included) and
`decoders.disp.decoder.{idx}.*`.

A ResNet or ResNeXt encoder gives features at strides 2 to 32, so the
decoder's stage 1 takes a skip and only stage 0 runs fused; behind ConvNeXt
(strides 4 to 32) stages 1 and 0 do.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from ..ops import blend_stereo
from .decoders import DECODERS
from .encoders import create_encoder
from .init import init_like_flax

__all__ = ['DepthNet', 'seeded_state_dict']

MASKS = {None: None, 'explainability': 'sigmoid', 'uncertainty': 'relu'}


class DepthNet(nn.Module):
    """:param enc_name: Encoder key (`CONVNEXT_SPECS` or `RESNET_SPECS`).
    :param pretrained: Look for pretrained encoder weights when training
        starts (`MonoDepthTrainer`, as the JAX package's `init_state`); a
        served net takes its weights from a checkpoint.
    :param dec_name: Decoder type ('monodepth').
    :param out_scales: Multi-scale outputs as 2**s.
    :param mask_name: Optional mask decoder {None, 'explainability', 'uncertainty'}.
    :param num_ch_mask: Number of support frames to predict masks for.
    :param use_virtual_stereo: If True, also predict stereo-pair disparity.
    :param use_stereo_blend: If True, blend predictions with a flipped pass.
    :param gelu: {'exact', 'tanh'} GELU flavor of the ConvNeXt blocks.
    :param dec_pad_mode: {'reflect', 'zeros'} decoder conv padding.
    :param dec_phase_up, enc_remat: the JAX package's phase-decomposed
        decoder upsampling and per-block rematerialization: exact transforms
        with the same parameters, so a checkpoint trained with them loads and
        serves; the port accepts and ignores them.
    :param kernels: run the hand-written kernels (depthwise conv, fused
        decoder stage). False runs their plain PyTorch versions: only for
        timing the plain path on the card.
    :param fused_stages: run the decoders' skip-less stages as fused stages
        (the default, in serving and in training). False runs plain modules.
    :param fused_blocks: run every ConvNeXt block of the encoder as one fused
        call (`ops.fused_convnext_block`: kernel 9 forward, kernel 10 and the
        two dwconv kernels backward on the card); off by default.

    Initial weights are flax's (`models.init.init_like_flax`).
    """

    def __init__(self, enc_name: str = 'convnext_base', pretrained: bool = True,
                 dec_name: str = 'monodepth',
                 out_scales: Union[int, Sequence[int]] = (0, 1, 2, 3),
                 mask_name: Optional[str] = None, num_ch_mask: Optional[int] = None,
                 use_virtual_stereo: bool = False, use_stereo_blend: bool = False,
                 gelu: str = 'exact', dec_pad_mode: str = 'reflect',
                 dec_phase_up: bool = False, enc_remat: str = '',
                 kernels: bool = True, fused_stages: bool = True,
                 fused_blocks: bool = False):
        super().__init__()
        del dec_phase_up, enc_remat  # exact transforms: nothing to do here
        self.enc_name, self.pretrained = enc_name, pretrained
        if dec_name not in DECODERS:
            raise NotImplementedError(
                f'Decoder "{dec_name}" is not ported yet (have {sorted(DECODERS)}); '
                'the other decoders are ROADMAP queue A item 10.')
        if mask_name not in MASKS:
            raise KeyError(f'Invalid mask. ({mask_name} vs. {set(MASKS)})')
        if mask_name and (num_ch_mask or 0) <= 0:
            raise ValueError(f'Invalid number of mask channels. ({num_ch_mask} vs. >=1)')
        self.out_sc = [out_scales] if isinstance(out_scales, int) else list(out_scales)
        self.mask_name = mask_name
        self.use_virtual_stereo = use_virtual_stereo
        self.use_stereo_blend = use_stereo_blend

        self.encoder, num_ch_enc, enc_sc = create_encoder(
            enc_name, gelu=gelu, kernels=kernels, fused_blocks=fused_blocks)
        dec = DECODERS[dec_name]
        self.decoders = nn.ModuleDict({'disp': dec(
            num_ch_enc=num_ch_enc, enc_sc=enc_sc, upsample_mode='nearest',
            use_skip=True, out_sc=self.out_sc, out_ch=1 + 2 * use_virtual_stereo,
            out_act='sigmoid', pad_mode=dec_pad_mode, kernels=kernels,
            fused_stages=fused_stages)})
        if mask_name:
            self.decoders['mask'] = dec(
                num_ch_enc=num_ch_enc, enc_sc=enc_sc, upsample_mode='nearest',
                use_skip=True, out_sc=self.out_sc, out_ch=num_ch_mask,
                out_act=MASKS[mask_name], pad_mode=dec_pad_mode, kernels=kernels,
                fused_stages=fused_stages)
        init_like_flax(self)

    def _forward(self, x: torch.Tensor) -> dict:
        feat = self.encoder(x.contiguous(memory_format=torch.channels_last))
        out = {'depth_feats': feat,
               'disp': dict(sorted(self.decoders['disp'](feat).items()))}
        if self.mask_name:
            out['mask'] = dict(sorted(self.decoders['mask'](feat).items()))
        if self.use_virtual_stereo:  # Split [mono | left, right] channels.
            out['disp_stereo'] = {k: v[:, 1:] for k, v in out['disp'].items()}
            out['disp'] = {k: v[:, :1] for k, v in out['disp'].items()}
        return out

    def forward(self, x: torch.Tensor) -> dict:
        """:param x: (b, 3, h, w) standardized images, h and w multiples of 32.
        :return: {depth_feats: [(b, c, h/2**s, w/2**s)],
                  disp: {s: (b, 1, h/2**s, w/2**s)},
                  (opt) disp_stereo / mask}.
        """
        out = self._forward(x)
        if not self.use_stereo_blend:
            return out
        out_flip = self._forward(x.flip(-1))
        for k, v in out_flip.items():
            if k.startswith('disp'):
                out[k] = {s: blend_stereo(out[k][s], vv.flip(-1)) for s, vv in v.items()}
        return out


def seeded_state_dict(net: nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Random weights for `net` from a fixed numpy recipe (no torch RNG).

    `np.random.RandomState(seed)` walks the `state_dict()` keys in sorted
    order and draws, per key:
    - `*.gamma` (ConvNeXt layer scale): uniform in [0.05, 0.15], so the
      blocks' residual branches matter;
    - any other 1-D `*.weight` (LayerNorm scale): 1 + 0.1 * N(0, 1);
    - 1-D `*.bias`: 0.1 * N(0, 1);
    - BatchNorm's buffers: `*.running_var` uniform in [0.5, 1.5] (a variance),
      `*.running_mean` 0.1 * N(0, 1), `*.num_batches_tracked` 0 (int64, no draw);
    - conv / linear weights: N(0, 1) / sqrt(fan_in), fan_in = prod(shape[1:]).
    Works on a `torch.device('meta')` net (only shapes are read).
    """
    rs = np.random.RandomState(seed)
    out = {}
    for key, t in sorted(net.state_dict().items()):
        shape = tuple(t.shape)
        if key.endswith('.num_batches_tracked'):
            out[key] = np.zeros(shape, np.int64)
            continue
        if key.endswith('.running_var'):
            v = rs.uniform(0.5, 1.5, shape)
        elif key.endswith('.gamma'):
            v = rs.uniform(0.05, 0.15, shape)
        elif len(shape) == 1 and key.endswith('.weight'):
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        elif len(shape) == 1:
            v = 0.1 * rs.standard_normal(shape)
        else:
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        out[key] = v.astype(np.float32)
    return out
