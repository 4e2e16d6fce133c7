"""Weight bridge: JAX package parameters -> the port's `DepthNet`, `PoseNet`
and `AutoencoderNet` state dicts.

The inverse of `slowtv_monodepth_tpu/models/import_reference.py:_convert_depth`,
`_convert_pose` and `_convert_autoencoder` with
`encoders/import_torch.py:convert_convnext` and `convert_resnet` (ConvNeXt,
ResNet and ResNeXt encoders; monodepth, HR-Depth, DDV-Net, DiffNet, CADepth
and SuperDepth decoders; pose heads), and of `import_midas.py:convert_midas_dpt`
for the DPT ViTs (the hybrid's ResNetV2 stem too) and the DPT decoder. A ResNet's BatchNorm running statistics
come from the net's `batch_stats` (`state.aux[net]['batch_stats']`), as do
CADepth's decoder BatchNorms'; given them, the state dict holds the buffers
too (`num_batches_tracked`, which flax does not keep, 0). Without them it
holds the parameters only (for a tree of optimizer moments, say). The other
direction needs no code of its own: prefix the port's `state_dict()` keys
with `nets.depth.` / `nets.pose.` / `nets.autoencoder.` and hand them to
`convert_reference_ckpt`.

Layouts: conv HWIO -> OIHW, depthwise (k, k, 1, C) -> (C, 1, k, k), dense
(in, out) -> (out, in), transposed conv (kh, kw, in, out) -> (in, out, kh, kw)
with the taps flipped (flax's `nn.ConvTranspose` does not flip its kernel; the
JAX package's MiDaS importer flips it on the way in), attention q / k / v (dim,
heads, hd) -> one packed (3 dim, dim) `qkv`, `out` (heads, hd, dim) -> (dim, dim).

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


def _convt(k) -> torch.Tensor:
    """flax `nn.ConvTranspose` (kh, kw, in, out), which does not flip its kernel ->
    torch's (in, out, kh, kw), the gradient of a conv: the taps flipped."""
    return _t(np.ascontiguousarray(np.transpose(np.asarray(k), (2, 3, 0, 1))[:, :, ::-1, ::-1]))


def _linear(sd: dict, dst: str, q: dict) -> None:
    sd[f'{dst}.weight'], sd[f'{dst}.bias'] = _dense(q['kernel']), _t(q['bias'])


def _norm(sd: dict, dst: str, q: dict) -> None:
    """flax LayerNorm / GroupNorm {scale, bias} -> `dst.weight`, `dst.bias`."""
    sd[f'{dst}.weight'], sd[f'{dst}.bias'] = _t(q['scale']), _t(q['bias'])


def _resnetv2(p: dict) -> dict:
    """JAX `_ResNetV2Stem` params -> timm's `patch_embed.backbone` keys."""
    sd = {'stem.conv.weight': _conv(p['stem_conv']['kernel'])}
    _norm(sd, 'stem.norm', p['stem_norm'])
    for name, q in p.items():
        if not (m := re.fullmatch(r'stage(\d+)_block(\d+)', name)):
            continue
        pre = f'stages.{m[1]}.blocks.{m[2]}'
        for sub, w in q.items():
            dst = f'{pre}.{sub.replace("downsample_", "downsample.")}'
            if 'conv' in sub:
                sd[f'{dst}.weight'] = _conv(w['kernel'])
            else:
                _norm(sd, dst, w)
    return sd


_QKV = ('query', 'key', 'value')   # timm's packing order


def _vit(p: dict) -> dict:
    """JAX `ViTEncoder` params -> the port's (timm / MiDaS) keys: flax's separate
    query / key / value (dim, heads, hd) packed into one `qkv` in that order, `out`
    (heads, hd, dim) into `proj`."""
    sd = {'model.cls_token': _t(p['cls_token']), 'model.pos_embed': _t(p['pos_embed'])}
    _put(sd, 'model.patch_embed.proj', p['patch_embed'])
    if 'backbone' in p:
        sd.update({f'model.patch_embed.backbone.{k}': v for k, v in _resnetv2(p['backbone']).items()})
    for name, q in p.items():
        if m := re.fullmatch(r'block(\d+)', name):
            pre = f'model.blocks.{m[1]}'
            _norm(sd, f'{pre}.norm1', q['norm1'])
            _norm(sd, f'{pre}.norm2', q['norm2'])
            att = q['attn']
            dim = np.asarray(att['query']['kernel']).shape[0]
            sd[f'{pre}.attn.qkv.weight'] = torch.cat([_dense(np.asarray(att[t]['kernel']).reshape(
                dim, -1)) for t in _QKV])
            sd[f'{pre}.attn.qkv.bias'] = torch.cat([_t(np.asarray(att[t]['bias']).reshape(-1))
                                                    for t in _QKV])
            sd[f'{pre}.attn.proj.weight'] = _dense(np.asarray(att['out']['kernel']).reshape(-1, dim))
            sd[f'{pre}.attn.proj.bias'] = _t(att['out']['bias'])
            _linear(sd, f'{pre}.mlp.fc1', q['mlp']['fc1'])
            _linear(sd, f'{pre}.mlp.fc2', q['mlp']['fc2'])
        elif m := re.fullmatch(r'readout(\d)', name):
            if 'project' in q:
                _linear(sd, f'act_postprocess{int(m[1]) + 1}.0.project.0', q['project'])
        elif m := re.fullmatch(r'reassemble(\d)', name):
            pre = f'act_postprocess{int(m[1]) + 1}'
            _put(sd, f'{pre}.3', q['proj'])
            if 'up' in q:
                sd[f'{pre}.4.weight'], sd[f'{pre}.4.bias'] = _convt(q['up']['kernel']), _t(
                    q['up']['bias'])
            elif 'down' in q:
                _put(sd, f'{pre}.4', q['down'])
    return sd


def _encoder(p: dict, stats: Optional[dict]) -> dict:
    if 'stem_conv' in p:
        return _convnext(p)
    if 'conv1' in p:
        return _resnet(p, stats)
    if 'pos_embed' in p:
        return _vit(p)
    raise NotImplementedError('Only ConvNeXt, ResNet, ResNeXt and the DPT ViT encoders are '
                              'ported (ROADMAP queue A item 10d, A10d).')


def _put(sd: dict, dst: str, q: dict) -> None:
    """A flax `nn.Conv` {kernel, [bias]} -> `dst.weight`, [`dst.bias`]."""
    sd[f'{dst}.weight'] = _conv(q['kernel'])
    if 'bias' in q:
        sd[f'{dst}.bias'] = _t(q['bias'])


def _monodepth(p: dict, out_scales: Sequence[int], stats=None) -> dict:
    names = [f'upconv_{i}_{j}' for i in range(4, -1, -1) for j in (0, 1)]
    sd = {}
    for idx, name in enumerate(names):
        _put(sd, f'decoder.{idx}.conv', p[name]['conv']['conv'])
    for j, s in enumerate(out_scales):
        _put(sd, f'decoder.{len(names) + j}', p[f'outconv_{s}']['conv'])
    return sd


def _hrdepth(p: dict, out_scales: Sequence[int], stats=None) -> dict:
    sd = {}
    for name, q in p.items():
        pre = f'convs.{name}'
        if name.endswith(('_conv_0', '_conv_1')):
            _put(sd, f'{pre}.conv', q['conv']['conv'])
        elif name.endswith('_att'):
            sd[f'{pre}.se.0.weight'] = _dense(q['se_fc1']['kernel'])
            sd[f'{pre}.se.2.weight'] = _dense(q['se_fc2']['kernel'])
            _put(sd, f'{pre}.conv.0', q['conv']['conv'])
        elif name.endswith('_down'):
            _put(sd, pre, q['conv'])
        else:  # outconv_{i}
            _put(sd, f'{pre}.0', q['conv'])
    return sd


def _diffnet(p: dict, out_scales: Sequence[int], stats=None) -> dict:
    sd = {}
    for name, q in p.items():
        pre = f'convs.{name}'
        if name.startswith('outconv_'):
            _put(sd, pre, q['conv'])
        elif 'ca' in q:  # an attention stage
            sd[f'{pre}.layers.0.fc.0.weight'] = _dense(q['ca']['fc1']['kernel'])
            sd[f'{pre}.layers.0.fc.2.weight'] = _dense(q['ca']['fc2']['kernel'])
            _put(sd, f'{pre}.layers.1', q['conv']['conv'])
        else:
            _put(sd, f'{pre}.0.conv', q['conv0']['conv']['conv'])
            _put(sd, f'{pre}.2.conv', q['conv1']['conv']['conv'])
    return sd


def _ddvnet(p: dict, out_scales: Sequence[int], stats=None) -> dict:
    sd = {}
    for t in ('query', 'key', 'value'):
        _put(sd, f'decoder.0.{t}_conv.0', p['att'][f'{t}_conv'])
    names = [f'upconv_{i}_{j}' for i in range(4, -1, -1) for j in (0, 1)]
    for k, name in enumerate(names, 1):
        _put(sd, f'decoder.{k}.conv', p[name]['conv']['conv'])
    for k, s in enumerate(out_scales, len(names) + 1):
        _put(sd, f'decoder.{k}', p[f'outconv_{s}']['conv'])
    return sd


def _cadepth(p: dict, out_scales: Sequence[int], stats: Optional[dict] = None) -> dict:
    """With `stats` (the decoder's `batch_stats`) the BatchNorm buffers too."""
    sd, k = {}, 0
    for i in range(4, -1, -1):
        _put(sd, f'decoder.{k}.conv', p[f'upconv_{i}_0']['conv']['conv'])
        _put(sd, f'decoder.{k + 1}.conv', p[f'upconv_{i}_1']['conv']['conv'])
        q, pre = p[f'detail_emphasis_{i}'], f'decoder.{k + 2}'
        _put(sd, f'{pre}.conv.0', q['conv']['conv'])
        sd[f'{pre}.conv.1.weight'] = _t(q['bn']['scale'])
        sd[f'{pre}.conv.1.bias'] = _t(q['bn']['bias'])
        if stats is not None:
            st = stats[f'detail_emphasis_{i}']['bn']
            sd[f'{pre}.conv.1.running_mean'] = _t(st['mean'])
            sd[f'{pre}.conv.1.running_var'] = _t(st['var'])
            sd[f'{pre}.conv.1.num_batches_tracked'] = torch.zeros((), dtype=torch.int64)
        _put(sd, f'{pre}.att.1', q['att_conv1'])
        _put(sd, f'{pre}.att.3', q['att_conv2'])
        k += 3
    for k, s in enumerate(out_scales, k):
        _put(sd, f'decoder.{k}', p[f'outconv_{s}']['conv'])
    return sd


def _superdepth(p: dict, out_scales: Sequence[int], stats=None) -> dict:
    sd, k = {}, 0
    for i in range(4, -1, -1):
        _put(sd, f'decoder.{k}.0.conv', p[f'upconv_{i}_0_conv']['conv']['conv'])
        _put(sd, f'decoder.{k}.1.conv', p[f'upconv_{i}_0_up']['conv'])
        _put(sd, f'decoder.{k + 1}.conv', p[f'upconv_{i}_1']['conv']['conv'])
        k += 2
    for k, s in enumerate(out_scales, k):
        if s == 0:
            _put(sd, f'decoder.{k}.0', p['outconv_0']['conv'])
        else:
            _put(sd, f'decoder.{k}.0.conv', p[f'outconv_{s}_conv']['conv']['conv'])
            _put(sd, f'decoder.{k}.1.conv', p[f'outconv_{s}_up']['conv'])
    return sd


def _dpt(p: dict, out_scales: Sequence[int], stats=None) -> dict:
    """JAX `DptDecoder` params -> the port's (MiDaS `scratch`) keys: level i is k = i + 1."""
    sd = {}
    for name, q in p.items():
        if m := re.fullmatch(r'scratch(\d)', name):
            _put(sd, f'layer{int(m[1]) + 1}_rn', q)
        elif m := re.fullmatch(r'refine(\d)', name):
            pre = f'refinenet{int(m[1]) + 1}'
            for res, unit in (('res1', 'resConfUnit1'), ('res2', 'resConfUnit2')):
                for c in ('conv1', 'conv2'):
                    if res in q:
                        _put(sd, f'{pre}.{unit}.{c}', q[res][c])
            _put(sd, f'{pre}.out_conv', q['out_conv'])
        elif m := re.fullmatch(r'out(\d)', name):
            for i, c in ((0, 'conv1'), (2, 'conv2'), (4, 'conv3')):
                _put(sd, f'{name}.{i}', q[c])
    return sd


def _decoder(p: dict, out_scales: Sequence[int], stats: Optional[dict] = None) -> dict:
    """A JAX decoder's params (and `batch_stats`) -> its port state dict; the
    decoder is told by a module name only it has."""
    for name, convert in (('detail_emphasis_4', _cadepth), ('att', _ddvnet),
                          ('04_conv_1', _hrdepth), ('upconv_4', _diffnet),
                          ('upconv_4_0_conv', _superdepth), ('refine0', _dpt)):
        if name in p:
            return convert(p, out_scales, stats)
    return _monodepth(p, out_scales)


def _scales_of(dec: dict) -> list[int]:
    """The out scales of a JAX decoder's params, ascending."""
    return sorted({int(k.split('_')[1]) for k in dec if k.startswith('outconv_')})


def depth_state_dict_from_jax(params: dict,
                              out_scales: Optional[Sequence[int]] = None,
                              batch_stats: Optional[dict] = None
                              ) -> dict[str, torch.Tensor]:
    """JAX `DepthNet` params (ConvNeXt, ResNet or ResNeXt; monodepth, HR-Depth,
    DDV-Net, DiffNet, CADepth or SuperDepth) -> port `DepthNet` state dict.

    :param params: {'encoder': ..., 'decoders_disp': ..., ['decoders_mask']},
        leaves numpy or jax arrays.
    :param out_scales: The net's `out_scales` in cfg order (it fixes the
        outconv indices); default: the scales present, ascending.
    :param batch_stats: the net's running statistics, {['encoder'] (a BatchNorm
        encoder), ['decoders_disp', 'decoders_mask'] (CADepth)}: with them the
        buffers come out too.
    """
    if out_scales is None:
        out_scales = _scales_of(params['decoders_disp'])
    stats = batch_stats or {}
    enc = _encoder(params['encoder'], stats.get('encoder'))
    sd = {f'encoder.{k}': v for k, v in enc.items()}
    for dec in ('disp', 'mask'):
        if f'decoders_{dec}' in params:
            sd.update({f'decoders.{dec}.{k}': v for k, v in _decoder(
                params[f'decoders_{dec}'], out_scales,
                None if batch_stats is None else stats.get(f'decoders_{dec}')).items()})
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
