"""Pretrained encoder weights: where they are looked for.

Counterpart of `slowtv_monodepth_tpu/models/encoders/pretrained.py`: with
`pretrained: True` the JAX package's `init_state` grafts
`<model_root>/timm/<enc_name>.npz|.pth|.pt` into the encoder when the file is
there and warns when it is not. The port looks in the same places and warns
with the same words; loading a file it finds is ROADMAP queue A item 7, so
until then a found file raises rather than being skipped.
"""
from __future__ import annotations

from typing import Optional

from ... import paths
from ...utils import get_logger

__all__ = ['find_weights_file', 'load_pretrained_encoder']

LOGGER = get_logger('pretrained')


def find_weights_file(enc_name: str) -> Optional[str]:
    """The first `<model_root>/timm/<enc_name>{.npz,.pth,.pt}` of `paths.MODEL_ROOTS`."""
    for root in paths.MODEL_ROOTS:
        for suffix in ('.npz', '.pth', '.pt'):
            f = root / f'timm/{enc_name}{suffix}'
            if f.is_file():
                return str(f)
    return None


def load_pretrained_encoder(enc_name: str) -> None:
    """Warn and keep the initial weights when no file is found; raise when one is."""
    file = find_weights_file(enc_name)
    if file is None:
        LOGGER.warning(
            f'No pretrained weights for "{enc_name}" under <model_root>/timm/; '
            'using random init. Export with api/data/export_timm.py.')
        return
    raise NotImplementedError(
        f'Found pretrained weights for "{enc_name}" at {file}, but loading them is not '
        'ported yet (ROADMAP queue A item 7).')
