"""Pretrained encoder weights: where they are looked for, and their graft.

Counterpart of `slowtv_monodepth_tpu/models/encoders/pretrained.py`: with
`pretrained: True` the trainer grafts `<model_root>/timm/<enc_name>.npz|.pth|.pt`
(written by `api/data/export_timm.py` on a machine with timm) into the net's
encoder when the file is there, and warns and keeps the initial weights when it
is not. The ConvNeXt, ResNet and ResNeXt families are ported (a ResNet's
BatchNorm running statistics are grafted with its parameters, as the JAX
package grafts its `batch_stats`); the other encoder families are ROADMAP
queue A item 10, and their constructors raise before a file is looked for.

The weights are copied into the encoder's existing parameters
(`load_state_dict`), so the optimizer's parameter groups and every other
reference to a parameter stay valid. A file that does not hold every encoder
key raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ... import paths
from ...utils import get_logger
from .convnext import CONVNEXT_SPECS
from .import_torch import convert_convnext, convert_resnet, load_state_dict_file
from .resnet import RESNET_SPECS

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


def load_pretrained_encoder(net: nn.Module, enc_name: str, in_chans: int = 3) -> bool:
    """Graft the pretrained weights of `enc_name` into `net.encoder`.

    :param in_chans: the encoder's input channels (6 for the pose net's image
        pairs: the 3-channel stem is adapted).
    :return: whether a file was found and loaded.
    """
    file = find_weights_file(enc_name)
    if file is None:
        LOGGER.warning(
            f'No pretrained weights for "{enc_name}" under <model_root>/timm/; '
            'using random init. Export with api/data/export_timm.py.')
        return False
    LOGGER.info(f'Loading pretrained encoder weights from {file}...')
    if enc_name in RESNET_SPECS:
        spec = RESNET_SPECS[enc_name]
        sd = convert_resnet(load_state_dict_file(file), spec['layers'], block=spec['block'],
                            in_chans=in_chans)
    else:
        sd = convert_convnext(load_state_dict_file(file), CONVNEXT_SPECS[enc_name]['depths'],
                              in_chans=in_chans)
    net.encoder.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return True
