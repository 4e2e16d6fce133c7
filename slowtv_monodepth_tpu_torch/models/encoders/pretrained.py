"""Pretrained encoder weights: where they are looked for, and their graft.

Counterpart of `slowtv_monodepth_tpu/models/encoders/pretrained.py`: with
`pretrained: True` the trainer grafts `<model_root>/timm/<enc_name>.npz|.pth|.pt`
(written by `api/data/export_timm.py` on a machine with timm) into the net's
encoder when the file is there, and warns and keeps the initial weights when it
is not. The ConvNeXt, ResNet and ResNeXt families are ported (a ResNet's
BatchNorm running statistics are grafted with its parameters, as the JAX
package grafts its `batch_stats`). `dpt_vitl16_384` also looks for the released
MiDaS `DPT_Large` file, `<model_root>/midas/dpt_large-midas-2f21e586.{npz,pth,pt}`,
and grafts its trunk, readouts and reassemble stages (`models/import_midas.py`); a
file without them warns and keeps the initial weights, as in the JAX package.
The other DPT ViTs have no converter: a file found for them warns the same way.
The other encoder families are ROADMAP A10d, and their constructors raise before
a file is looked for.

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


# DPT encoders initialise from the released MiDaS checkpoints.
_DPT_MIDAS_STEMS = {'dpt_vitl16_384': 'midas/dpt_large-midas-2f21e586'}


def find_weights_file(enc_name: str) -> Optional[str]:
    """The first `<model_root>/timm/<enc_name>{.npz,.pth,.pt}` of `paths.MODEL_ROOTS`,
    or of a DPT encoder's MiDaS stem (`_DPT_MIDAS_STEMS`)."""
    stems = [f'timm/{enc_name}'] + ([_DPT_MIDAS_STEMS[enc_name]]
                                    if enc_name in _DPT_MIDAS_STEMS else [])
    for root in paths.MODEL_ROOTS:
        for stem in stems:
            for suffix in ('.npz', '.pth', '.pt'):
                f = root / f'{stem}{suffix}'
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
    if enc_name in _DPT_MIDAS_STEMS:
        from ..import_midas import convert_midas_encoder, load_midas_state_dict
        try:
            sd = convert_midas_encoder(load_midas_state_dict(file),
                                       list(net.encoder.state_dict()))
        except KeyError as e:
            LOGGER.warning(f'MiDaS-layout weights expected for "{enc_name}" ({e}); '
                           'using random init.')
            return False
        net.encoder.load_state_dict(sd)
        return True
    if enc_name not in RESNET_SPECS and enc_name not in CONVNEXT_SPECS:
        LOGGER.warning(f'No converter for encoder "{enc_name}"; using random init.')
        return False
    if enc_name in RESNET_SPECS:
        spec = RESNET_SPECS[enc_name]
        sd = convert_resnet(load_state_dict_file(file), spec['layers'], block=spec['block'],
                            in_chans=in_chans)
    else:
        sd = convert_convnext(load_state_dict_file(file), CONVNEXT_SPECS[enc_name]['depths'],
                              in_chans=in_chans)
    net.encoder.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return True
