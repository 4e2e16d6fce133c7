"""Feature-pyramid encoders of the port (ConvNeXt, ResNet and ResNeXt so far).

Counterpart of `slowtv_monodepth_tpu/models/encoders/__init__.py`.
"""
from .convnext import CONVNEXT_SPECS, ConvNeXtEncoder
from .resnet import RESNET_SPECS, ResNetEncoder

__all__ = ['create_encoder', 'ConvNeXtEncoder', 'ResNetEncoder', 'CONVNEXT_SPECS',
           'RESNET_SPECS']


def create_encoder(name: str, in_chans: int = 3, gelu: str = 'exact',
                   kernels: bool = True, fused_blocks: bool = False):
    """Build an encoder by timm-style name. `gelu`, `kernels` and
    `fused_blocks` are the ConvNeXt blocks' (a ResNet has no GELU and no
    hand-written kernel; `fused_blocks` on one raises).

    :return: (module, channels per stage, reduction per stage)
    """
    if name in RESNET_SPECS:
        if fused_blocks:
            raise KeyError(f'fused_blocks is only supported for ConvNeXt encoders (got "{name}").')
        spec = RESNET_SPECS[name]
        enc = ResNetEncoder(block=spec['block'], layers=spec['layers'], in_chans=in_chans,
                            groups=spec.get('groups', 1),
                            width_per_group=spec.get('width_per_group', 64))
    elif name in CONVNEXT_SPECS:
        spec = CONVNEXT_SPECS[name]
        enc = ConvNeXtEncoder(depths=spec['depths'], dims=spec['dims'],
                              in_chans=in_chans, gelu=gelu, kernels=kernels,
                              fused_blocks=fused_blocks)
    else:
        raise NotImplementedError(
            f'Encoder "{name}" is not ported yet: ConvNeXt, ResNet and ResNeXt are '
            f'({sorted(CONVNEXT_SPECS) + sorted(RESNET_SPECS)}). The other families are '
            'ROADMAP queue A item 10 (remaining networks).')
    return enc, list(spec['channels']), list(spec['reductions'])
