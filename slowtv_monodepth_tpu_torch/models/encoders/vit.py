"""ViT feature-pyramid encoders for DPT depth nets (PyTorch, NCHW).

Counterpart of `slowtv_monodepth_tpu/models/encoders/vit.py`: a ViT trunk with
block-index hooks, a cls-token readout (ignore / add / project) and per-hook
reassemble stages that map the stride-16 tokens back to feature maps at strides
4, 8, 16 and 32; the hybrid R50+ViT-B takes strides 4 and 8 from its ResNetV2
stem instead.

Module names are timm's and the MiDaS file's, so a MiDaS `pretrained.*` state
dict loads with a prefix map (`models/import_midas.py`): `model.cls_token`,
`model.pos_embed`, `model.patch_embed.proj` (hybrid: `model.patch_embed.backbone`
with `stem.conv` / `stem.norm` and `stages.{s}.blocks.{i}.{conv,norm}{1,2,3}` /
`downsample.{conv,norm}`), `model.blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}`, and `act_postprocess{k}.{0.project.0,3,4}` (the readout's
projection, the 1x1 conv, the up- or down-sampling conv). q, k and v are one packed
`qkv` Linear in timm's order; the JAX package keeps flax's separate
query / key / value (`models/from_jax.py` packs them).

What the JAX package computes, and so the port (its oracle):
- GELU is flax's `nn.gelu`, the tanh approximation, in the MLP and in the
  `project` readout (timm and MiDaS use erf; `DepthNet(gelu=...)` does not reach
  the ViT, as the JAX `create_encoder` does not pass it);
- attention divides the query by sqrt(head dim) before q k^T, a softmax, then v;
- the position embeddings are stored for a 24x24 grid and resized to the input's
  token grid by `jax.image.resize(..., 'bilinear')`, which antialiases where it
  shrinks (`ops.image_resize`);
- the hybrid stem's convs standardise their weights (biased variance, eps 1e-6
  inside the rsqrt) and pad TF-SAME, asymmetrically; its max-pool pads the bottom
  and right with -inf and runs VALID 3x3 / 2.

Matmuls, attention, convs and GroupNorm are cuBLAS's and cuDNN's on the card: in
the JAX package they are XLA ops, and none reaches a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import image_resize

__all__ = ['ViTEncoder', 'VIT_SPECS']

VIT_SPECS = {
    # name: trunk dims + DPT hook / reassemble configuration.
    'vitb16_384': dict(dim=768, depth=12, heads=12, hooks=(2, 5, 8, 11),
                       channels=(96, 192, 384, 768), reductions=(4, 8, 16, 32)),
    'vitl16_384': dict(dim=1024, depth=24, heads=16, hooks=(5, 11, 17, 23),
                       channels=(256, 512, 1024, 1024), reductions=(4, 8, 16, 32)),
    # Hybrid R50+ViT-B: ResNetV2 stages give the stride-4 / 8 levels, hooks 8 / 11
    # the stride-16 / 32 ones.
    'vitb_rn50_384': dict(dim=768, depth=12, heads=12, hooks=(8, 11),
                          channels=(256, 512, 768, 768), reductions=(4, 8, 16, 32), hybrid=True),
}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate='tanh')


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """flax's `MultiHeadDotProductAttention` in timm's layout: one packed `qkv`."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        att = ((q / math.sqrt(hd)) @ k.transpose(-2, -1)).softmax(dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF-SAME padding of an NCHW input: out = ceil(in / s), the odd pixel of the
    total at the bottom / right."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class StdConv2dSame(nn.Conv2d):
    """Weight-standardised conv (timm `StdConv2dSame`): per output channel
    (w - mean) / sqrt(var + 1e-6), the biased variance; TF-SAME padding; no bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mu) * torch.rsqrt(var + 1e-6)
        return F.conv2d(_same_pad(x, self.kernel_size[0], self.stride[0]), w, None, self.stride)


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-5)


class Downsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv = StdConv2dSame(in_ch, out_ch, 1, stride)
        self.norm = _gn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class V2Bottleneck(nn.Module):
    """ResNetV2 (non-preact) bottleneck: StdConv + GroupNorm(32) + ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = StdConv2dSame(in_ch, planes, 1)
        self.norm1 = _gn(planes)
        self.conv2 = StdConv2dSame(planes, planes, 3, stride)
        self.norm2 = _gn(planes)
        self.conv3 = StdConv2dSame(planes, 4 * planes, 1)
        self.norm3 = _gn(4 * planes)
        self.downsample = Downsample(in_ch, 4 * planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class _Stage(nn.Module):
    def __init__(self, blocks: list):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """TF-SAME 3x3 / 2 max-pool on even sizes: -inf at the bottom and right, then VALID."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float('-inf')), 3, 2)


class _Stem(nn.Module):
    def __init__(self, in_chans: int):
        super().__init__()
        self.conv = StdConv2dSame(in_chans, 64, 7, 2)
        self.norm = _gn(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_same(F.relu(self.norm(self.conv(x))))


class ResNetV2Stem(nn.Module):
    """ResNetV2 stages (3, 4, 9) of the hybrid ViT -> [256 @ 4, 512 @ 8, 1024 @ 16]."""

    def __init__(self, in_chans: int = 3, layers: Sequence[int] = (3, 4, 9)):
        super().__init__()
        self.stem = _Stem(in_chans)
        stages, in_ch, planes = [], 64, 64
        for s, depth in enumerate(layers):
            blocks = []
            for i in range(depth):
                blocks.append(V2Bottleneck(in_ch, planes, 2 if (s > 0 and i == 0) else 1,
                                           downsample=i == 0))
                in_ch = 4 * planes
            stages.append(_Stage(blocks))
            planes *= 2
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats


class PatchEmbed(nn.Module):
    """A `patch` x `patch` stride-`patch` conv, or (hybrid) the ResNetV2 stem and a 1x1 conv."""

    def __init__(self, dim: int, patch: int, in_chans: int, hybrid: bool):
        super().__init__()
        self.backbone = ResNetV2Stem(in_chans) if hybrid else None
        self.proj = (nn.Conv2d(1024, dim, 1) if hybrid else
                     nn.Conv2d(in_chans, dim, patch, patch))


class Trunk(nn.Module):
    """The ViT proper (timm's `VisionTransformer` names): its parameters only; the
    encoder runs it."""

    def __init__(self, dim: int, depth: int, heads: int, patch: int, in_chans: int,
                 pos_grid: int, hybrid: bool):
        super().__init__()
        self.patch_embed = PatchEmbed(dim, patch, in_chans, hybrid)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))


class Readout(nn.Module):
    """cls-token readout: 'ignore' drops it, 'add' adds it to every patch token,
    'project' concatenates it to every patch token and projects back (`project.0`),
    then GELU."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        if mode not in ('ignore', 'add', 'project'):
            raise ValueError(f'Invalid readout "{mode}".')
        self.mode = mode
        if mode == 'project':
            self.project = nn.Sequential(nn.Linear(2 * dim, dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cls, patches = tokens[:, :1], tokens[:, 1:]
        if self.mode == 'ignore':
            return patches
        if self.mode == 'add':
            return patches + cls
        return gelu(self.project(torch.cat([patches, cls.expand_as(patches)], dim=-1)))


class Reassemble(nn.Sequential):
    """Tokens -> a feature map at stride 4, 8, 16 or 32 (`stage` 0-3; tokens are at 16):
    the readout (index 0), a 1x1 conv (3), then a x4 / x2 transposed conv or a stride-2
    3x3 conv (4). Indices 1 and 2 hold MiDaS's transpose and unflatten, which have no
    parameters."""

    def __init__(self, dim: int, out_ch: int, stage: int, readout: str):
        super().__init__(Readout(dim, readout), nn.Identity(), nn.Identity(),
                         nn.Conv2d(dim, out_ch, 1))
        if stage in (0, 1):
            k = 4 if stage == 0 else 2
            self.append(nn.ConvTranspose2d(out_ch, out_ch, k, k))
        elif stage == 3:
            self.append(nn.Conv2d(out_ch, out_ch, 3, 2, padding=1))

    def forward(self, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        x = self[0](tokens)
        b, _, c = x.shape
        x = x.reshape(b, gh, gw, c).permute(0, 3, 1, 2)   # NCHW view, channels-last memory
        x = self[3](x)
        return self[4](x) if len(self) > 4 else x


class ViTEncoder(nn.Module):
    """:param dim, depth, heads: Trunk size.
    :param hooks: Block indices producing the pyramid features (2 for the hybrid).
    :param channels: Reassembled channels per pyramid level.
    :param readout: cls-token handling {ignore, add, project}.
    :param patch: Patch size (inputs must be multiples of it).
    :param pos_grid: The stored position-embedding grid (384 / 16).
    :param hybrid: R50+ViT: the ResNetV2 stem gives strides 4 / 8.
    """

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 hooks: Sequence[int] = (2, 5, 8, 11),
                 channels: Sequence[int] = (96, 192, 384, 768), readout: str = 'project',
                 patch: int = 16, in_chans: int = 3, pos_grid: int = 24, hybrid: bool = False):
        super().__init__()
        self.dim, self.patch, self.pos_grid, self.hybrid = dim, patch, pos_grid, hybrid
        self.hooks = list(hooks)
        self.model = Trunk(dim, depth, heads, patch, in_chans, pos_grid, hybrid)
        first = 2 if hybrid else 0   # the hybrid's stages 0 and 1 are the stem's
        for s in range(first, 4):
            self.add_module(f'act_postprocess{s + 1}', Reassemble(dim, channels[s], s, readout))

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.model.pos_embed
        grid = pos[:, 1:].reshape(1, self.pos_grid, self.pos_grid, self.dim).permute(0, 3, 1, 2)
        grid = image_resize(grid, (gh, gw), 'linear').permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :1], grid], dim=1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        b, _, h, w = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(f'Input must be a multiple of {self.patch}. ({h}x{w})')
        gh, gw = h // self.patch, w // self.patch
        embed = self.model.patch_embed
        rn_feats = None
        if self.hybrid:
            rn_feats = embed.backbone(x)
            x = embed.proj(rn_feats[-1])
        else:
            x = embed.proj(x)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.model.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self._pos_embed(gh, gw)
        feats = []
        for i, blk in enumerate(self.model.blocks):
            x = blk(x)
            if i in self.hooks:
                feats.append(x)
        out = list(rn_feats[:2]) if self.hybrid else []
        for s, f in enumerate(feats, start=len(out)):
            out.append(getattr(self, f'act_postprocess{s + 1}')(f, gh, gw))
        return out
