"""Feature-pyramid encoders of the port (ConvNeXt so far).

Counterpart of `slowtv_monodepth_tpu/models/encoders/__init__.py`.
"""
from .convnext import CONVNEXT_SPECS, ConvNeXtEncoder

__all__ = ['create_encoder', 'ConvNeXtEncoder', 'CONVNEXT_SPECS']


def create_encoder(name: str, in_chans: int = 3, gelu: str = 'exact',
                   kernels: bool = True):
    """Build an encoder by timm-style name.

    :return: (module, channels per stage, reduction per stage)
    """
    if name not in CONVNEXT_SPECS:
        raise NotImplementedError(
            f'Encoder "{name}" is not ported yet: only ConvNeXt is '
            f'({sorted(CONVNEXT_SPECS)}). The other families are ROADMAP '
            'queue A item 10 (remaining networks).')
    spec = CONVNEXT_SPECS[name]
    enc = ConvNeXtEncoder(depths=spec['depths'], dims=spec['dims'],
                          in_chans=in_chans, gelu=gelu, kernels=kernels)
    return enc, list(spec['channels']), list(spec['reductions'])
