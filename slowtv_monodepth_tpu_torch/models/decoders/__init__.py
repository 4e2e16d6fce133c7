from .monodepth import MonodepthDecoder

__all__ = ['MonodepthDecoder', 'DECODERS']

DECODERS = {'monodepth': MonodepthDecoder}
