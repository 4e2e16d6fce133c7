"""Feature-pyramid encoders of the port (ConvNeXt, ResNet, ResNeXt and the DPT ViTs).

Counterpart of `slowtv_monodepth_tpu/models/encoders/__init__.py`.
"""
from .convnext import CONVNEXT_SPECS, ConvNeXtEncoder
from .resnet import RESNET_SPECS, ResNetEncoder
from .vit import VIT_SPECS, ViTEncoder

__all__ = ['create_encoder', 'ConvNeXtEncoder', 'ResNetEncoder', 'ViTEncoder', 'CONVNEXT_SPECS',
           'RESNET_SPECS', 'VIT_SPECS']


def create_encoder(name: str, in_chans: int = 3, gelu: str = 'exact',
                   kernels: bool = True, fused_blocks: bool = False):
    """Build an encoder by timm-style name; a DPT ViT by its name with or without the
    `dpt_` prefix the cfgs give it (`dpt_vitb16_384`, `dpt_vitl16_384`,
    `dpt_vitb_rn50_384`). `gelu`, `kernels` and `fused_blocks` are the ConvNeXt
    blocks' (a ResNet has no GELU and no hand-written kernel; the ViT's GELU is flax's tanh approximation whatever `gelu` says, as in the
    JAX package; `fused_blocks` on either raises).

    :return: (module, channels per stage, reduction per stage)
    """
    if gelu not in ('exact', 'tanh'):
        raise KeyError(f'Invalid gelu flavor. ({gelu} vs. ("exact", "tanh"))')
    if fused_blocks and name not in CONVNEXT_SPECS:
        raise KeyError(f'fused_blocks is only supported for ConvNeXt encoders (got "{name}").')
    if name in RESNET_SPECS:
        spec = RESNET_SPECS[name]
        enc = ResNetEncoder(block=spec['block'], layers=spec['layers'], in_chans=in_chans,
                            groups=spec.get('groups', 1),
                            width_per_group=spec.get('width_per_group', 64))
    elif name in CONVNEXT_SPECS:
        spec = CONVNEXT_SPECS[name]
        enc = ConvNeXtEncoder(depths=spec['depths'], dims=spec['dims'],
                              in_chans=in_chans, gelu=gelu, kernels=kernels,
                              fused_blocks=fused_blocks)
    elif name.removeprefix('dpt_') in VIT_SPECS:
        spec = VIT_SPECS[name.removeprefix('dpt_')]
        enc = ViTEncoder(dim=spec['dim'], depth=spec['depth'], heads=spec['heads'],
                         hooks=spec['hooks'], channels=spec['channels'],
                         hybrid=spec.get('hybrid', False), in_chans=in_chans)
    else:
        raise NotImplementedError(
            f'Encoder "{name}" is not ported yet: ConvNeXt, ResNet, ResNeXt and the DPT ViTs '
            f'are ({sorted(CONVNEXT_SPECS) + sorted(RESNET_SPECS)}, '
            f'{sorted("dpt_" + k for k in VIT_SPECS)}). BEiT, Swin, MobileNet, EfficientNet '
            'and HRNet are ROADMAP queue A item 10d (A10d).')
    return enc, list(spec['channels']), list(spec['reductions'])
