"""Weight bridge: JAX package parameters -> the port's `DepthNet`, `PoseNet`
and `AutoencoderNet` state dicts.

The inverse of `slowtv_monodepth_tpu/models/import_reference.py:_convert_depth`,
`_convert_pose` and `_convert_autoencoder` with `encoders/import_torch.py:convert_convnext` and
`convert_resnet` (ConvNeXt, ResNet and ResNeXt encoders, monodepth decoders,
pose heads). A ResNet's BatchNorm running statistics come from the net's
`batch_stats` (`state.aux[net]['batch_stats']`); given them, the state dict
holds the buffers too (`num_batches_tracked`, which flax does not keep, 0).
Without them it holds the parameters only (for a tree of optimizer moments,
say). The other direction
needs no code of its own: prefix the port's `state_dict()` keys with
`nets.depth.` / `nets.pose.` / `nets.autoencoder.` and hand them to `convert_reference_ckpt`.

Layouts: conv HWIO -> OIHW, depthwise (k, k, 1, C) -> (C, 1, k, k), dense
(in, out) -> (out, in).

A JAX orbax checkpoint reaches the port in three steps: the JAX package's
`state, meta = core.checkpoint.load_checkpoint(path)` (host numpy), then
`sd = depth_state_dict_from_jax(state.params['depth'],
batch_stats=state.aux['depth'].get('batch_stats'))`, then the port's
`core.checkpoint.save_checkpoint(out, {'depth': sd}, meta['cfg'])`.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ['autoencoder_state_dict_from_jax', 'depth_state_dict_from_jax',
           'pose_state_dict_from_jax']


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # copies: jax buffers are read-only


def _conv(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))  # HWIO -> OIHW


def _dense(k) -> torch.Tensor:
    return _t(np.asarray(k).T)  # (in, out) -> (out, in)


def _convnext(p: dict) -> dict:
    sd = {'stem.0.weight': _conv(p['stem_conv']['kernel']),
          'stem.0.bias': _t(p['stem_conv']['bias']),
          'stem.1.weight': _t(p['stem_norm']['scale']),
          'stem.1.bias': _t(p['stem_norm']['bias'])}
    for name, q in p.items():
        if m := re.fullmatch(r'stage(\d+)_ds_(norm|conv)', name):
            pre = f'stages.{m[1]}.downsample.{0 if m[2] == "norm" else 1}'
            w = q['scale'] if m[2] == 'norm' else q['kernel']
            sd[f'{pre}.weight'] = _t(w) if m[2] == 'norm' else _conv(w)
            sd[f'{pre}.bias'] = _t(q['bias'])
        elif m := re.fullmatch(r'stage(\d+)_block(\d+)', name):
            pre = f'stages.{m[1]}.blocks.{m[2]}'
            sd[f'{pre}.conv_dw.weight'] = _conv(q['conv_dw']['kernel'])
            sd[f'{pre}.conv_dw.bias'] = _t(q['conv_dw']['bias'])
            sd[f'{pre}.norm.weight'] = _t(q['norm']['scale'])
            sd[f'{pre}.norm.bias'] = _t(q['norm']['bias'])
            for fc in ('fc1', 'fc2'):
                sd[f'{pre}.mlp.{fc}.weight'] = _dense(q[f'mlp_{fc}']['kernel'])
                sd[f'{pre}.mlp.{fc}.bias'] = _t(q[f'mlp_{fc}']['bias'])
            sd[f'{pre}.gamma'] = _t(q['gamma'])
    return sd


def _resnet(p: dict, stats: Optional[dict]) -> dict:
    """JAX `ResNetEncoder` params (and batch_stats) -> timm keys."""
    def bn(dst: str, q: dict, st: Optional[dict]) -> dict:
        out = {f'{dst}.weight': _t(q['scale']), f'{dst}.bias': _t(q['bias'])}
        if st is not None:
            out.update({f'{dst}.running_mean': _t(st['mean']), f'{dst}.running_var': _t(st['var']),
                        f'{dst}.num_batches_tracked': torch.zeros((), dtype=torch.int64)})
        return out

    stats = stats or {}
    sd = {'conv1.weight': _conv(p['conv1']['kernel']), **bn('bn1', p['bn1'], stats.get('bn1'))}
    for name, q in p.items():
        if not (m := re.fullmatch(r'layer(\d+)_(\d+)', name)):
            continue
        pre, st = f'layer{m[1]}.{m[2]}', stats.get(name, {})
        for sub, w in q.items():
            if sub.startswith('conv') or sub == 'downsample_conv':
                dst = f'{pre}.downsample.0' if sub == 'downsample_conv' else f'{pre}.{sub}'
                sd[f'{dst}.weight'] = _conv(w['kernel'])
            else:
                dst = f'{pre}.downsample.1' if sub == 'downsample_bn' else f'{pre}.{sub}'
                sd.update(bn(dst, w, st.get(sub)))
    return sd


def _encoder(p: dict, stats: Optional[dict]) -> dict:
    if 'stem_conv' in p:
        return _convnext(p)
    if 'conv1' in p:
        return _resnet(p, stats)
    raise NotImplementedError('Only ConvNeXt, ResNet and ResNeXt encoders are ported '
                              '(ROADMAP queue A item 10).')


def _monodepth(p: dict, out_scales: Sequence[int]) -> dict:
    names = [f'upconv_{i}_{j}' for i in range(4, -1, -1) for j in (0, 1)]
    sd = {}
    for idx, name in enumerate(names):
        q = p[name]['conv']['conv']
        sd[f'decoder.{idx}.conv.weight'] = _conv(q['kernel'])
        sd[f'decoder.{idx}.conv.bias'] = _t(q['bias'])
    for j, s in enumerate(out_scales):
        q = p[f'outconv_{s}']['conv']
        sd[f'decoder.{len(names) + j}.weight'] = _conv(q['kernel'])
        sd[f'decoder.{len(names) + j}.bias'] = _t(q['bias'])
    return sd


def _scales_of(dec: dict) -> list[int]:
    """The out scales of a JAX monodepth decoder's params, ascending."""
    return sorted(int(k.split('_')[1]) for k in dec if k.startswith('outconv_'))


def depth_state_dict_from_jax(params: dict,
                              out_scales: Optional[Sequence[int]] = None,
                              batch_stats: Optional[dict] = None
                              ) -> dict[str, torch.Tensor]:
    """JAX `DepthNet` params (ConvNeXt, ResNet or ResNeXt + monodepth) -> port
    `DepthNet` state dict.

    :param params: {'encoder': ..., 'decoders_disp': ..., ['decoders_mask']},
        leaves numpy or jax arrays.
    :param out_scales: The net's `out_scales` in cfg order (it fixes the
        outconv indices); default: the scales present, ascending.
    :param batch_stats: the net's {'encoder': ...} running statistics (a
        BatchNorm encoder): with them the buffers come out too.
    """
    if out_scales is None:
        out_scales = _scales_of(params['decoders_disp'])
    enc = _encoder(params['encoder'], (batch_stats or {}).get('encoder'))
    sd = {f'encoder.{k}': v for k, v in enc.items()}
    for dec in ('disp', 'mask'):
        if f'decoders_{dec}' in params:
            sd.update({f'decoders.{dec}.{k}': v for k, v in
                       _monodepth(params[f'decoders_{dec}'], out_scales).items()})
    return sd


def pose_state_dict_from_jax(params: dict, batch_stats: Optional[dict] = None
                             ) -> dict[str, torch.Tensor]:
    """JAX `PoseNet` params (ConvNeXt, ResNet or ResNeXt encoder) -> port
    `PoseNet` state dict.

    :param params: {'encoder', 'squeeze', 'decoders_pose',
        ['decoders_focal', 'decoders_offset']}, leaves numpy or jax arrays.
    :param batch_stats: as `depth_state_dict_from_jax`'s.
    """
    enc = _encoder(params['encoder'], (batch_stats or {}).get('encoder'))
    sd = {f'encoder.{k}': v for k, v in enc.items()}
    sq = params['squeeze']['conv']
    sd['squeeze.0.weight'], sd['squeeze.0.bias'] = _conv(sq['kernel']), _t(sq['bias'])
    for head in ('pose', 'focal', 'offset'):
        if (q := params.get(f'decoders_{head}')) is None:
            continue
        pre = f'decoders.{head}'
        for i in (0, 1):
            blk = q[f'block{i}']['conv']
            sd[f'{pre}.{i}.0.weight'], sd[f'{pre}.{i}.0.bias'] = _conv(blk['kernel']), _t(blk['bias'])
        sd[f'{pre}.2.weight'], sd[f'{pre}.2.bias'] = _conv(q['out']['kernel']), _t(q['out']['bias'])
    return sd


def autoencoder_state_dict_from_jax(params: dict,
                                    out_scales: Optional[Sequence[int]] = None,
                                    batch_stats: Optional[dict] = None
                                    ) -> dict[str, torch.Tensor]:
    """JAX `AutoencoderNet` params -> port `AutoencoderNet` state dict
    (`encoder.*`, `decoder.decoder.{idx}.*`).

    :param params: {'encoder': ..., 'decoders_autoencoder': ...}.
    :param out_scales, batch_stats: as `depth_state_dict_from_jax`'s.
    """
    dec = params['decoders_autoencoder']
    enc = _encoder(params['encoder'], (batch_stats or {}).get('encoder'))
    sd = {f'encoder.{k}': v for k, v in enc.items()}
    sd.update({f'decoder.{k}': v for k, v in
               _monodepth(dec, _scales_of(dec) if out_scales is None else out_scales).items()})
    return sd
