"""Weight bridge: JAX package parameters -> the port's `DepthNet` and
`PoseNet` state dicts.

The inverse of `slowtv_monodepth_tpu/models/import_reference.py:_convert_depth`
and `_convert_pose` with `encoders/import_torch.py:convert_convnext`
(ConvNeXt encoders, monodepth decoders, pose heads). The other direction
needs no code of its own: prefix the port's `state_dict()` keys with
`nets.depth.` / `nets.pose.` and hand them to `convert_reference_ckpt`.

Layouts: conv HWIO -> OIHW, depthwise (k, k, 1, C) -> (C, 1, k, k), dense
(in, out) -> (out, in).

A JAX orbax checkpoint reaches the port in three steps: the JAX package's
`state, meta = core.checkpoint.load_checkpoint(path)` (host numpy), then
`sd = depth_state_dict_from_jax(state.params['depth'])`, then the port's
`core.checkpoint.save_checkpoint(out, {'depth': sd}, meta['cfg'])`.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ['depth_state_dict_from_jax', 'pose_state_dict_from_jax']


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


def depth_state_dict_from_jax(params: dict,
                              out_scales: Optional[Sequence[int]] = None
                              ) -> dict[str, torch.Tensor]:
    """JAX `DepthNet` params (ConvNeXt + monodepth) -> port `DepthNet` state dict.

    :param params: {'encoder': ..., 'decoders_disp': ..., ['decoders_mask']},
        leaves numpy or jax arrays.
    :param out_scales: The net's `out_scales` in cfg order (it fixes the
        outconv indices); default: the scales present, ascending.
    """
    if 'stem_conv' not in params['encoder']:
        raise NotImplementedError('Only ConvNeXt encoders are ported.')
    if out_scales is None:
        out_scales = sorted(int(k.split('_')[1]) for k in params['decoders_disp']
                            if k.startswith('outconv_'))
    sd = {f'encoder.{k}': v for k, v in _convnext(params['encoder']).items()}
    for dec in ('disp', 'mask'):
        if f'decoders_{dec}' in params:
            sd.update({f'decoders.{dec}.{k}': v for k, v in
                       _monodepth(params[f'decoders_{dec}'], out_scales).items()})
    return sd


def pose_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX `PoseNet` params (ConvNeXt encoder) -> port `PoseNet` state dict.

    :param params: {'encoder', 'squeeze', 'decoders_pose',
        ['decoders_focal', 'decoders_offset']}, leaves numpy or jax arrays.
    """
    if 'stem_conv' not in params['encoder']:
        raise NotImplementedError('Only ConvNeXt encoders are ported.')
    sd = {f'encoder.{k}': v for k, v in _convnext(params['encoder']).items()}
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
