"""The released MiDaS DPT checkpoint -> the port's `MidasDPT` (and a DPT encoder's)
state dict.

Counterpart of `slowtv_monodepth_tpu/models/import_midas.py`, which maps the intel-isl
`DPT_Large` state dict (`dpt_large-midas-2f21e586.pt`) onto flax. The port's modules
carry the file's names (`encoders/vit.py`, `decoders/dpt.py`), so the map is by
prefix: `pretrained.` -> `encoder.`, `scratch.output_conv.` -> `decoder.out0.`,
`scratch.` -> `decoder.`; nothing is reshaped (the file's packed `qkv` is the port's,
and its ConvTranspose2d kernels are torch's own).

Keys of the file that the JAX converter never reads are dropped, and only those
(`dropped_keys`): the trunk's final LayerNorm and classifier head
(`pretrained.model.norm.*`, `pretrained.model.head.*`: the hooks read the blocks
before them) and the coarsest fusion block's `resConfUnit1` (it has no skip to
refine); a file without them (an export that left the classifier head out, say)
loads as well. Any other key of the file that the net does not hold, or a key of the
net that the file lacks, raises naming it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['load_midas_state_dict', 'dropped_keys', 'convert_midas_dpt', 'convert_midas_encoder']

_PREFIXES = (('pretrained.', 'encoder.'), ('scratch.output_conv.', 'decoder.out0.'),
             ('scratch.', 'decoder.'))


def load_midas_state_dict(path) -> dict[str, np.ndarray]:
    """A MiDaS state dict from `.npz` or a torch `.pt` / `.pth` file (a `state_dict`
    entry unwrapped, a `module.` prefix removed)."""
    path = str(path)
    if path.endswith('.npz'):
        with np.load(path) as f:
            sd = {k: f[k] for k in f.files}
    else:
        sd = torch.load(path, map_location='cpu', weights_only=True)
        if 'state_dict' in sd:
            sd = sd['state_dict']
        sd = {k: v.numpy() for k, v in sd.items()}
    return {k.removeprefix('module.'): v for k, v in sd.items()}


def dropped_keys(levels: int = 4) -> list[str]:
    """The MiDaS keys that no module reads (the JAX converter skips them too)."""
    coarsest = f'scratch.refinenet{levels}.resConfUnit1'
    return (['pretrained.model.norm.weight', 'pretrained.model.norm.bias',
             'pretrained.model.head.weight', 'pretrained.model.head.bias']
            + [f'{coarsest}.{c}.{p}' for c in ('conv1', 'conv2') for p in ('weight', 'bias')])


def _rename(key: str) -> str:
    for old, new in _PREFIXES:
        if key.startswith(old):
            return new + key[len(old):]
    return key


def _check(got: dict, want: list[str], what: str) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f'{what}: missing {missing[:8]}{"..." if len(missing) > 8 else ""}, '
                       f'unexpected {extra[:8]}{"..." if len(extra) > 8 else ""}')


def convert_midas_dpt(sd: dict[str, np.ndarray], net_keys: list[str]) -> dict[str, torch.Tensor]:
    """A MiDaS DPT state dict -> `MidasDPT` state dict.

    :param net_keys: the net's `state_dict()` keys: each must come from the file, and
        every key of the file but `dropped_keys()` must land on one.
    """
    dropped = set(dropped_keys())
    out = {_rename(k): torch.from_numpy(np.array(v)) for k, v in sd.items() if k not in dropped}
    _check(out, net_keys, 'MiDaS state dict')
    return out


def convert_midas_encoder(sd: dict[str, np.ndarray], enc_keys: list[str]) -> dict[str, torch.Tensor]:
    """The trunk, readouts and reassemble stages of a MiDaS state dict -> a DPT
    encoder's state dict (`pretrained: True` grafts it): the `pretrained.*` keys but
    the dropped ones, which must be exactly `enc_keys`."""
    dropped = set(dropped_keys())
    out = {k[len('pretrained.'):]: torch.from_numpy(np.array(v)) for k, v in sd.items()
           if k.startswith('pretrained.') and k not in dropped}
    _check(out, enc_keys, 'MiDaS encoder')
    return out
