"""Pretrained timm state dicts -> the port's encoder state dicts.

Counterpart of `slowtv_monodepth_tpu/models/encoders/import_torch.py` for the
ConvNeXt, ResNet and ResNeXt families (its own copy: the port imports nothing
of the JAX package). The port's encoders carry timm's module names, so a timm
state dict needs no layout change: `convert_convnext` and `convert_resnet`
pick exactly the encoder keys the JAX converters read (a ResNet's BatchNorm
running statistics included, as the JAX converter's `batch_stats`), drop
everything else a timm export holds (`fc.*`, `head.*`), and adapt the stem to
`in_chans` inputs in torch's OIHW layout, as timm adapts input convs (tile
along the input axis, scale by 3 / in_chans). A missing key raises `KeyError`
naming it.
"""
from __future__ import annotations

import numpy as np

__all__ = ['load_state_dict_file', 'adapt_input_conv', 'convert_convnext', 'convert_resnet']


def load_state_dict_file(path) -> dict[str, np.ndarray]:
    """Load a state dict from .npz (preferred) or torch .pth/.pt file."""
    path = str(path)
    if path.endswith('.npz'):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    import torch
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if 'state_dict' in sd:
        sd = sd['state_dict']
    return {k: v.numpy() for k, v in sd.items()}


def adapt_input_conv(w_oihw: np.ndarray, in_chans: int) -> np.ndarray:
    """Adapt a 3-channel stem conv kernel (OIHW) to `in_chans` inputs (timm-style)."""
    c_in = w_oihw.shape[1]
    if c_in == in_chans:
        return w_oihw
    reps = int(np.ceil(in_chans / c_in))
    w = np.tile(w_oihw, (1, reps, 1, 1))[:, :in_chans]
    return w * (c_in / in_chans)


def convert_convnext(sd: dict[str, np.ndarray], depths, in_chans: int = 3) -> dict[str, np.ndarray]:
    """timm ConvNeXt state dict -> the port's `ConvNeXtEncoder` state dict."""
    out = {'stem.0.weight': adapt_input_conv(sd['stem.0.weight'], in_chans)}
    keys = ['stem.0.bias', 'stem.1.weight', 'stem.1.bias']
    for stage, n_blocks in enumerate(depths):
        if stage > 0:
            keys += [f'stages.{stage}.downsample.{i}.{p}' for i in (0, 1) for p in ('weight', 'bias')]
        for i in range(n_blocks):
            pre = f'stages.{stage}.blocks.{i}'
            keys += [f'{pre}.{m}.{p}' for m in ('conv_dw', 'norm', 'mlp.fc1', 'mlp.fc2')
                     for p in ('weight', 'bias')] + [f'{pre}.gamma']
    out.update({k: sd[k] for k in keys})
    return out


_BN = ('weight', 'bias', 'running_mean', 'running_var')


def convert_resnet(sd: dict[str, np.ndarray], layers, block: str = 'basic',
                   in_chans: int = 3) -> dict[str, np.ndarray]:
    """timm/torchvision ResNet or ResNeXt state dict -> the port's `ResNetEncoder`
    state dict: parameters and BatchNorm running statistics. `num_batches_tracked`
    (which the JAX package does not keep) comes from the file where it has one,
    else 0."""
    out = {'conv1.weight': adapt_input_conv(sd['conv1.weight'], in_chans)}
    bns = ['bn1']
    n_convs = 2 if block == 'basic' else 3
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            pre = f'layer{stage + 1}.{i}'
            for c in range(1, n_convs + 1):
                out[f'{pre}.conv{c}.weight'] = sd[f'{pre}.conv{c}.weight']
                bns.append(f'{pre}.bn{c}')
            if f'{pre}.downsample.0.weight' in sd:
                out[f'{pre}.downsample.0.weight'] = sd[f'{pre}.downsample.0.weight']
                bns.append(f'{pre}.downsample.1')
    for bn in bns:
        out.update({f'{bn}.{p}': sd[f'{bn}.{p}'] for p in _BN})
        out[f'{bn}.num_batches_tracked'] = np.asarray(
            sd.get(f'{bn}.num_batches_tracked', 0), np.int64)
    return out
