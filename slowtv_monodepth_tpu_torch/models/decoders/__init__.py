from .cadepth import CaDepthDecoder
from .ddvnet import DDVNetDecoder
from .diffnet import DiffNetDecoder
from .dpt import DptDecoder
from .hrdepth import HRDepthDecoder
from .monodepth import MonodepthDecoder
from .superdepth import SuperdepthDecoder

__all__ = ['CaDepthDecoder', 'DDVNetDecoder', 'DiffNetDecoder', 'DptDecoder', 'HRDepthDecoder',
           'MonodepthDecoder', 'SuperdepthDecoder', 'DECODERS', 'kernel_kw']

DECODERS = {'monodepth': MonodepthDecoder, 'hrdepth': HRDepthDecoder, 'ddvnet': DDVNetDecoder,
            'diffnet': DiffNetDecoder, 'cadepth': CaDepthDecoder,
            'superdepth': SuperdepthDecoder, 'dpt': DptDecoder}


def kernel_kw(dec_name: str, **kw) -> dict:
    """The kernel switches (`kernels`, `fused_stages`) for decoder `dec_name`: only
    the monodepth decoder has a fused stage to switch, as only its JAX counterpart
    takes `phase_up`."""
    return kw if dec_name == 'monodepth' else {}
