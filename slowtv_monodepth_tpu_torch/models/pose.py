"""Relative pose network (PyTorch, NCHW channels-last).

Counterpart of `slowtv_monodepth_tpu/models/pose.py:PoseNet`: an encoder
over a channel-concatenated image pair (in_chans=6), a 1x1 squeeze + ReLU,
and a conv head (two 3x3 conv + ReLU, a 1x1 conv, a global mean) giving
axis-angle R and translation t scaled by `pose_eps`; with `learn_K`, two
more heads give a softplus focal length and a sigmoid principal point,
assembled by `build_K`.

`state_dict()` keys, prefixed with `nets.pose.`, are the reference
checkpoint's (`models/import_reference.py:_convert_pose` reads them):
`encoder.*` (timm's names, BatchNorm buffers included), `squeeze.0.*`,
`decoders.{pose,focal,offset}.{0,1}.0.*` and `decoders.{pose,focal,offset}.2.*`.

The trainer calls the net once on all n' * b image pairs of a batch, so a
BatchNorm encoder's batch statistics span every pair, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoders import create_encoder
from .init import init_like_flax

__all__ = ['PoseNet']


def _head(n_ch: int, out_ch: int) -> nn.Sequential:
    """Two conv3x3 (zero padding) + ReLU blocks and a 1x1 conv; the mean over
    (h, w) is taken by the caller."""
    def block():
        return nn.Sequential(nn.Conv2d(n_ch, n_ch, 3, padding=1), nn.ReLU())
    return nn.Sequential(block(), block(), nn.Conv2d(n_ch, out_ch, 1))


class PoseNet(nn.Module):
    """:param enc_name: Encoder key (ConvNeXt, ResNet or ResNeXt; the published
        pose net is ResNet-18).
    :param learn_K: Also predict the normalized focal length and principal point.
    :param pretrained: Look for pretrained encoder weights when training
        starts (see `DepthNet`).
    :param gelu: {'exact', 'tanh'} GELU flavor of the ConvNeXt blocks.
    :param input_scale: 1 only: the half-resolution pose input is a TPU recipe
        option of the JAX package.
    :param kernels: run the depthwise-conv kernel (see `DepthNet`).
    :param fused_blocks: run every ConvNeXt block of the encoder as one fused
        call (see `DepthNet`); off by default.

    Initial weights are flax's (`models.init.init_like_flax`).
    """
    n_imgs = 2
    n_ch_dec = 256
    pose_eps = 0.01

    def __init__(self, enc_name: str = 'resnet18', learn_K: bool = False,
                 pretrained: bool = False, gelu: str = 'exact', input_scale: int = 1,
                 kernels: bool = True, fused_blocks: bool = False):
        super().__init__()
        self.enc_name, self.pretrained = enc_name, pretrained
        if input_scale != 1:
            raise NotImplementedError(
                'input_scale is a TPU recipe option; the port runs the exact recipe '
                '(ROADMAP ground rule "Recipe").')
        self.learn_K = learn_K
        self.encoder, n_ch_enc, _ = create_encoder(
            enc_name, in_chans=3 * self.n_imgs, gelu=gelu, kernels=kernels,
            fused_blocks=fused_blocks)
        self.squeeze = nn.Sequential(nn.Conv2d(n_ch_enc[-1], self.n_ch_dec, 1), nn.ReLU())
        heads = {'pose': 6 * self.n_imgs}
        if learn_K:
            heads.update(focal=2, offset=2)
        self.decoders = nn.ModuleDict({k: _head(self.n_ch_dec, c) for k, c in heads.items()})
        init_like_flax(self)

    @staticmethod
    def build_K(fs: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
        """(b, 2) focal + (b, 2) principal point -> (b, 4, 4) intrinsics."""
        z, o = torch.zeros_like(fs[:, 0]), torch.ones_like(fs[:, 0])
        rows = [(fs[:, 0], z, cs[:, 0], z), (z, fs[:, 1], cs[:, 1], z),
                (z, z, o, z), (z, z, z, o)]
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    def _head(self, key: str, feat: torch.Tensor) -> torch.Tensor:
        return self.decoders[key](feat).mean((2, 3))

    def forward(self, x: torch.Tensor) -> dict:
        """:param x: (b, 6, h, w) channel-concatenated image pair.
        :return: {R: (b, 2, 3) axis-angle, t: (b, 2, 3), (opt) fs, cs: (b, 2)}.
        """
        feat = self.encoder(x.contiguous(memory_format=torch.channels_last))[-1]
        feat = self.squeeze(feat)
        out = (self.pose_eps * self._head('pose', feat)).reshape(-1, self.n_imgs, 6)
        res = {'R': out[..., :3], 't': out[..., 3:]}
        if self.learn_K:
            res['fs'] = F.softplus(self._head('focal', feat))
            res['cs'] = torch.sigmoid(self._head('offset', feat))
        return res
