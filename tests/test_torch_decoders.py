"""Port differentials for the HR-Depth, DDV-Net, DiffNet, CADepth and SuperDepth
decoders, their weight bridge and their reference checkpoint layout.

Same numpy inputs (seeded) through the JAX package's decoders and the port's, the
port on the CPU. Inputs: random encoder pyramids at B=2, 64x96, narrow widths with
the published doubling, on a 4-scale ConvNeXt-like pyramid (strides 4 to 32, where
HR-Depth duplicates and upsamples its first stage and DiffNet has two skip-less
stages) and a 5-scale ResNet-like one (strides 2 to 32). Weights:
`models.seeded_state_dict` draws the port's keys; the JAX package's reference
converters (`import_reference.DEC_CONVERTERS`) carry them to its params and
`batch_stats`, and `models.from_jax` carries those back, bit for bit.

- each decoder: eval and train-mode outputs, the gradient of every parameter for a
  random projection of every output, and (CADepth) the running statistics after
  the train-mode pass, the port in float64 against the JAX package in float64
  (`jax.enable_x64`: flax's float32 batch variance, E[x^2] - E[x]^2, is the wrong
  oracle, `tests/test_torch_resnet.py` says why); the port's float32 outputs
  against the same oracle;
- flax's initial weights: per tensor the port's draw against flax's `init`;
- the bridge: JAX params -> port state dict, bitwise, with the buffers;
  `train_state_from_jax` carries CADepth's `aux` statistics into both decoders;
- the reference layout: a port `DepthNet`'s `state_dict()`, as a reference
  checkpoint, through the JAX package's `convert_reference_ckpt`: the JAX net
  predicts what the port predicts (with a mask decoder where one is allowed,
  virtual stereo for SuperDepth); DDV-Net with a mask raises;
- trap (a): the keys a reference checkpoint holds and its forward never uses are
  pinned; the load path (`core.checkpoint.load_net`, `BenchmarkPredictor`) drops
  exactly those, and any other unexpected or missing key raises.

Tolerances, each of a tensor's largest JAX magnitude: float64 outputs and running
statistics 1e-9, gradients 1e-9 of the decoder's largest (measured <= 1e-14;
CADepth's conv biases in front of a train-mode BatchNorm have a gradient of zero
up to rounding, so a tensor's own largest is no scale there); float32 outputs 1e-5
(measured <= 1.2e-6, CADepth's train mode; DDV-Net's 128-bin expectation 7e-7: the
JAX package's own import test holds it to the reference only at atol 1e-3, and its
attention scaled by 1 / sqrt(c) is 3.4e-2 off); served disparities 1e-5. Initial
weights: each kernel's standard deviation within 10% of flax's. Each check has a
fault that fails it (`MUTANTS`: the smallest miss, torch's BatchNorm momentum, is
1e-3 of the running statistics).
"""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
from slowtv_monodepth_tpu.models import decoders as jdec
from slowtv_monodepth_tpu.models.encoders.convnext import CONVNEXT_SPECS as JAX_CONVNEXT_SPECS
from slowtv_monodepth_tpu.models.import_reference import DEC_CONVERTERS, convert_reference_ckpt
from slowtv_monodepth_tpu_torch import parsers
from slowtv_monodepth_tpu_torch.core import load_net, save_checkpoint
from slowtv_monodepth_tpu_torch.core.predictors import BenchmarkPredictor
from slowtv_monodepth_tpu_torch.models import DepthNet, depth_state_dict_from_jax, seeded_state_dict
from slowtv_monodepth_tpu_torch.models import norm
from slowtv_monodepth_tpu_torch.models.decoders import DECODERS, cadepth, ddvnet, superdepth
from slowtv_monodepth_tpu_torch.models.encoders import CONVNEXT_SPECS
from slowtv_monodepth_tpu_torch.models import from_jax
from slowtv_monodepth_tpu_torch.models.from_jax import _decoder
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

B, H, W = 2, 64, 96
OUT_SC = (0, 1, 2, 3)
F64_RTOL, F32_RTOL, DISP_ATOL, INIT_RTOL = 1e-9, 1e-5, 1e-5, 0.1
PYRAMIDS = {'convnext': ((16, 32, 64, 128), (4, 8, 16, 32)),
            'resnet': ((16, 16, 32, 64, 128), (2, 4, 8, 16, 32))}
NAMES = ('hrdepth', 'ddvnet', 'diffnet', 'cadepth', 'superdepth')
# Out channels: SuperDepth's 3 are the virtual stereo it is published with (its
# scale-3 sub-pixel conv then has 3 groups of 64), DDV-Net's 2 split its bins in two.
OUT_CH = {'hrdepth': 1, 'ddvnet': 2, 'diffnet': 1, 'cadepth': 1, 'superdepth': 3}
JAX_DECODERS = {'hrdepth': jdec.HRDepthDecoder, 'ddvnet': jdec.DDVNetDecoder,
                'diffnet': jdec.DiffNetDecoder, 'cadepth': jdec.CaDepthDecoder,
                'superdepth': jdec.SuperdepthDecoder}
# Every decoder behind the 4-scale pyramid; behind the 5-scale one the two whose
# structure changes with it (HR-Depth's duplicate, DiffNet's stage-1 attention).
CASES = [(n, 'convnext') for n in NAMES] + [('hrdepth', 'resnet'), ('diffnet', 'resnet')]


def _quiet(fn, *a, **kw):
    """HR-Depth warns on a 4-scale encoder; `test_hrdepth_duplicates_a_4_scale_first_stage`
    reads the warning."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return fn(*a, **kw)


def port_decoder(name: str, pyr: str):
    chans, sc = PYRAMIDS[pyr]
    return _quiet(DECODERS[name], num_ch_enc=chans, enc_sc=sc, out_sc=OUT_SC,
                  out_ch=OUT_CH[name])


def jax_decoder(name: str, pyr: str):
    chans, sc = PYRAMIDS[pyr]
    return JAX_DECODERS[name](num_ch_enc=chans, enc_sc=sc, out_sc=OUT_SC, out_ch=OUT_CH[name])


@functools.lru_cache(maxsize=None)
def weights(name: str, pyr: str) -> dict:
    return seeded_state_dict(port_decoder(name, pyr), NAMES.index(name))


def features(pyr: str) -> list:
    chans, sc = PYRAMIDS[pyr]
    rs = np.random.RandomState(1)
    return [rs.standard_normal((B, c, H // s, W // s)).astype(np.float32)
            for c, s in zip(chans, sc)]


def projections(name: str) -> dict:
    """Per out scale (b, c, h, w): SuperDepth's outputs are all at full resolution."""
    rs = np.random.RandomState(2)
    return {s: rs.standard_normal((B, OUT_CH[name]) + ((H, W) if name == 'superdepth' else
                                                       (H >> s, W >> s)))
            for s in OUT_SC}


def _nchw(tree) -> dict:
    return {s: np.transpose(np.asarray(v), (0, 3, 1, 2)) for s, v in tree.items()}


def _port_sd(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _decoder64(tree: dict, stats=None) -> dict:
    """`from_jax._decoder` keeping float64 (the bridge casts to float32)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(from_jax, '_t', lambda a: torch.from_numpy(np.array(a)))
        return _port_sd(_decoder(tree, OUT_SC, stats))


@functools.lru_cache(maxsize=None)
def jax_run(name: str, pyr: str) -> dict:
    """The JAX decoder on the seeded weights in float64 (one jit): eval and train
    outputs, the gradient of the projection loss and the updated `batch_stats`, all
    in the port's layout (the bridge); and the converted params themselves. Only
    CADepth's modes differ (its BatchNorm): the other JAX decoders ignore `train`, so
    their eval outputs are the train outputs."""
    _, sc = PYRAMIDS[pyr]
    mod = jax_decoder(name, pyr)
    params, stats = DEC_CONVERTERS[name](weights(name, pyr), OUT_SC, enc_sc=sc, use_skip=True)
    proj = {s: np.transpose(p, (0, 2, 3, 1)) for s, p in projections(name).items()}
    with jax.enable_x64(True):
        def run(p, st, feats):
            def loss(p):
                out, upd = _quiet(mod.apply, {'params': p, 'batch_stats': st}, feats,
                                  train=True, mutable=['batch_stats'])
                return sum((out[s] * proj[s]).sum() for s in out), (out, upd)
            (_, (tr, upd)), g = jax.value_and_grad(loss, has_aux=True)(p)
            ev = _quiet(mod.apply, {'params': p, 'batch_stats': st}, feats,
                        train=False) if st else tr
            return ev, tr, g, upd.get('batch_stats', {})
        p64, st64 = (jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                     for t in (params, stats))
        feats = [np.transpose(f, (0, 2, 3, 1)).astype(np.float64) for f in features(pyr)]
        ev, tr, g, st = jax.tree.map(np.asarray, jax.jit(run)(p64, st64, feats))
    buffers = _decoder64(p64, st) if st else {}
    return {'params': params, 'stats': stats, 'eval': _nchw(ev), 'train': _nchw(tr),
            'grads': _decoder64(g),
            'buffers': {k: v for k, v in buffers.items()
                        if k.endswith(('running_mean', 'running_var'))}}


def port_run(name: str, pyr: str, dtype=torch.float64) -> dict:
    """The port's decoder on the weights the bridge carries back: eval, then one
    train-mode pass with the projection loss's backward."""
    dec = port_decoder(name, pyr)
    run = jax_run(name, pyr)
    dec.load_state_dict(_decoder(run['params'], OUT_SC, run['stats'] or None))
    dec.to(dtype)
    feats = [torch.from_numpy(f).to(dtype) for f in features(pyr)]
    with torch.no_grad():
        ev = dec.eval()(feats)
    tr = dec.train()(feats)
    sum((tr[s] * torch.from_numpy(p).to(dtype)).sum()
        for s, p in projections(name).items()).backward()
    return {'eval': {s: v.numpy() for s, v in ev.items()},
            'train': {s: v.detach().numpy() for s, v in tr.items()},
            'grads': {k: p.grad.numpy() for k, p in dec.named_parameters()},
            'buffers': {k: b.numpy() for k, b in dec.named_buffers()
                        if k.endswith(('running_mean', 'running_var'))},
            'counts': {k: int(b) for k, b in dec.named_buffers()
                       if k.endswith('num_batches_tracked')}}


def _faults(got: dict, want: dict, rtol: float, scale: float = None) -> list:
    """The keys whose tensors differ by more than `rtol` of the largest JAX magnitude
    (of the tensor, or `scale`)."""
    assert sorted(got) == sorted(want)
    bad = []
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape or not np.abs(g - w).max() <= rtol * (scale or np.abs(w).max()):
            bad.append(k)
    return bad


def _all_faults(port: dict, want: dict, rtol: float = F64_RTOL) -> list:
    """Outputs and statistics per tensor; gradients against the decoder's largest
    one: a conv's bias in front of a train-mode BatchNorm (CADepth) has a gradient
    of zero up to rounding."""
    grad_max = max(np.abs(g).max() for g in want['grads'].values())
    return [(part, k) for part in ('eval', 'train', 'grads', 'buffers')
            for k in _faults(port[part], want[part], rtol,
                             grad_max if part == 'grads' else None)]


# ------------------------------------------------------------------ 1. the decoders
@pytest.mark.parametrize('name,pyr', CASES, ids=[f'{n}-{p}' for n, p in CASES])
def test_decoder_matches_jax_in_float64(name, pyr):
    """Outputs, every parameter's gradient and (CADepth) the running statistics."""
    port, want = port_run(name, pyr), jax_run(name, pyr)
    assert _all_faults(port, want) == []
    full = name == 'superdepth'
    for s, v in port['eval'].items():
        assert v.shape == (B, OUT_CH[name]) + ((H, W) if full else (H >> s, W >> s))
    assert set(port['counts'].values()) <= {1}
    assert bool(port['buffers']) == (name == 'cadepth')


@pytest.mark.parametrize('name,pyr', CASES, ids=[f'{n}-{p}' for n, p in CASES])
def test_decoder_float32_outputs_match_jax(name, pyr):
    port, want = port_run(name, pyr, torch.float32), jax_run(name, pyr)
    assert [k for part in ('eval', 'train') for k in _faults(port[part], want[part],
                                                             F32_RTOL)] == []


def test_hrdepth_duplicates_a_4_scale_first_stage():
    """Behind a 4-scale encoder the first stage is duplicated (with a warning) and
    upsampled; behind a 5-scale one it is not."""
    with pytest.warns(UserWarning, match='duplicating'):
        assert DECODERS['hrdepth'](*PYRAMIDS['convnext']).duplicate_first
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert not DECODERS['hrdepth'](*PYRAMIDS['resnet']).duplicate_first


# ----------------------------------------------------------- 2. the faults that fail
def _sdpa_attention(self, x):  # the default 1 / sqrt(c) scale of SDPA
    b, c, h, w = x.shape
    q, k, v = (conv(x).flatten(2).transpose(1, 2)
               for conv in (self.query_conv, self.key_conv, self.value_conv))
    return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, c, h, w)


def _reflect_subpixel(self, x):
    return F.pixel_shuffle(F.conv2d(F.pad(x, (1, 1, 1, 1), mode='reflect'), self.conv.weight,
                                    self.conv.bias, groups=self.conv.groups), self.up_factor)


def _transposed_shuffle(self, x):  # input channel c r^2 + dj r + di -> offset (di, dj)
    y = self.conv(x)
    b, c, h, w = y.shape
    r = self.up_factor
    y = y.reshape(b, c // r ** 2, r, r, h, w).transpose(2, 3).reshape(b, c, h, w)
    return F.pixel_shuffle(y, r)


def _torch_momentum(self, x):  # nn.BatchNorm2d's update: momentum 0.1, unbiased variance
    return torch.nn.BatchNorm2d.forward(self, x)


def _no_max_shift(self, x):
    v = x.flatten(2)
    att = torch.einsum('bcn,bdn->bcd', v, v)
    return x + torch.einsum('bcd,bdn->bcn', att.softmax(dim=-1), v).reshape(x.shape)


def _bilinear_duplicate(self, feat):  # the duplicated first stage upsampled bilinearly
    feat = [F.interpolate(feat[0], scale_factor=2, mode='bilinear')] + list(feat)
    self.duplicate_first = False
    try:
        return _HR_FORWARD(self, feat)
    finally:
        self.duplicate_first = True


def _no_duplicate(self, feat):
    self.duplicate_first = False
    try:
        return _HR_FORWARD(self, feat)
    finally:
        self.duplicate_first = True


_HR_FORWARD = DECODERS['hrdepth'].forward
MUTANTS = {
    'ddvnet_sdpa_scale': ('ddvnet', ddvnet.SelfAttentionBlock, 'forward', _sdpa_attention),
    'superdepth_reflect_pad': ('superdepth', superdepth.SubPixelConv, 'forward',
                               _reflect_subpixel),
    'superdepth_transposed_shuffle': ('superdepth', superdepth.SubPixelConv, 'forward',
                                      _transposed_shuffle),
    'cadepth_torch_momentum': ('cadepth', norm.BatchNorm2d, 'forward', _torch_momentum),
    'cadepth_no_max_shift': ('cadepth', cadepth.StructurePerception, 'forward', _no_max_shift),
    'hrdepth_no_duplicate': ('hrdepth', DECODERS['hrdepth'], 'forward', _no_duplicate),
    'hrdepth_bilinear_duplicate': ('hrdepth', DECODERS['hrdepth'], 'forward',
                                   _bilinear_duplicate),
}


@pytest.mark.parametrize('mutant', sorted(MUTANTS))
def test_the_decoder_checks_have_teeth(mutant, monkeypatch):
    """Each fault fails the float64 check on the 4-scale pyramid (HR-Depth's
    missing duplicate fails the forward itself: the grid's channels do not meet)."""
    name, cls, attr, fault = MUTANTS[mutant]
    monkeypatch.setattr(cls, attr, fault)
    if mutant == 'hrdepth_no_duplicate':
        with pytest.raises(RuntimeError):
            port_run(name, 'convnext')
        return
    assert _all_faults(port_run(name, 'convnext'), jax_run(name, 'convnext')) != []


def test_the_float32_check_has_teeth(monkeypatch):
    """DDV-Net's attention scaled by 1 / sqrt(c) fails the float32 tolerance too."""
    monkeypatch.setattr(ddvnet.SelfAttentionBlock, 'forward', _sdpa_attention)
    port, want = port_run('ddvnet', 'convnext', torch.float32), jax_run('ddvnet', 'convnext')
    assert _faults(port['eval'], want['eval'], F32_RTOL) != []


# --------------------------------------------------------- 3. initial weights, bridge
@pytest.mark.parametrize('name', NAMES)
def test_initial_weights_are_flax_s(name):
    """`init_like_flax` (the `DepthNet` constructor's) against the JAX decoder's
    params (`jax.eval_shape` of its `init`: shapes only), per tensor: zero biases,
    BatchNorm 1 / 0 with statistics 0 / 1, and every kernel's standard deviation
    within 10% of flax's `lecun_normal`, 1 / sqrt(fan-in) with the fan-in of the JAX
    kernel (H W I of HWIO, I of a dense (I, O)): 9 for SubPixelConv, one input
    channel a group."""
    from slowtv_monodepth_tpu_torch.models.init import init_like_flax
    torch.manual_seed(0)
    dec = init_like_flax(port_decoder(name, 'convnext'))
    feats = [np.transpose(f, (0, 2, 3, 1)) for f in features('convnext')]
    shapes = _quiet(jax.eval_shape, jax_decoder(name, 'convnext').init, jax.random.PRNGKey(0),
                    feats)

    def flax_init(path, a):
        key = jax.tree_util.keystr(path)
        if 'kernel' in key:  # the std flax draws for it, as a constant tensor
            return np.full(a.shape, 1 / np.sqrt(np.prod(a.shape[:-1])), np.float32)
        return np.full(a.shape, 1.0 if key.endswith(("['scale']", "['var']")) else 0.0,
                       np.float32)
    want = _port_sd(_decoder(jax.tree_util.tree_map_with_path(flax_init, shapes['params']),
                             OUT_SC, jax.tree_util.tree_map_with_path(
                                 flax_init, shapes.get('batch_stats'))))
    got = {k: t.numpy() for k, t in dec.state_dict().items()
           if not k.endswith('num_batches_tracked')}
    assert sorted(got) == sorted(k for k in want if not k.endswith('num_batches_tracked'))
    bad = []
    for k, g in got.items():
        w = want[k]
        if g.shape != w.shape:
            bad.append((k, 'shape'))
        elif g.ndim <= 1:  # biases, BatchNorm's scale and statistics: exact
            bad += [(k, 'value')] * (not np.array_equal(g, w))
        elif abs(g.std() / w.flat[0] - 1) > INIT_RTOL:
            bad.append((k, g.std() / w.flat[0]))
    assert bad == []
    if name == 'superdepth':
        up = dec.decoder[0][1].conv.weight
        assert up.shape[1] == 1 and abs(up.std().item() * 3 - 1) < INIT_RTOL


@pytest.mark.parametrize('name,pyr', CASES, ids=[f'{n}-{p}' for n, p in CASES])
def test_bridge_round_trip_is_bitwise(name, pyr):
    """port keys -> the JAX package's reference converter -> `from_jax` -> the same
    bits, BatchNorm buffers included (with the decoder's `batch_stats`)."""
    run = jax_run(name, pyr)
    back = _port_sd(_decoder(run['params'], OUT_SC, run['stats'] or None))
    want = weights(name, pyr)
    assert sorted(back) == sorted(want)
    assert [k for k in want if not np.array_equal(back[k], want[k])] == []


def test_bridge_check_has_teeth(monkeypatch):
    run = jax_run('cadepth', 'convnext')
    back = _port_sd(_decoder(run['params'], OUT_SC, None))   # the statistics left behind
    assert sorted(back) != sorted(weights('cadepth', 'convnext'))
    monkeypatch.setattr(from_jax, '_dense', from_jax._t)      # a dense kernel not transposed
    back = _port_sd(_decoder(jax_run('diffnet', 'convnext')['params'], OUT_SC))
    want = weights('diffnet', 'convnext')
    assert [k for k in want if not np.array_equal(back[k], want[k])] != []


# ----------------------------------------------- 4. the reference layout, the load path
ENC = 'convnext_atto'


@pytest.fixture(scope='module', autouse=True)
def cut_encoder():
    """convnext_atto's widths with one block a stage, in both packages: the decoders
    meet its features, and its 12 blocks would only slow the JAX net down."""
    with pytest.MonkeyPatch.context() as mp:
        for specs in (CONVNEXT_SPECS, JAX_CONVNEXT_SPECS):
            mp.setitem(specs, ENC, dict(specs[ENC], depths=(1, 1, 1, 1)))
        yield
NET_CASES = {'hrdepth': dict(mask_name='explainability', num_ch_mask=2),
             'ddvnet': {},
             'diffnet': dict(mask_name='uncertainty', num_ch_mask=2, out_scales=[0, 2]),
             'cadepth': dict(mask_name='explainability', num_ch_mask=2),
             'superdepth': dict(use_virtual_stereo=True)}


def net_cfg(name: str) -> dict:
    return {'enc_name': ENC, 'dec_name': name, 'out_scales': [0, 1, 2, 3],
            **NET_CASES[name]}


@functools.lru_cache(maxsize=None)
def net_pair(name: str):
    """A port `DepthNet` on seeded weights and the JAX package's, from the port's
    `state_dict()` as a reference checkpoint; the JAX net's eval outputs."""
    cfg = net_cfg(name)
    net = _quiet(DepthNet, pretrained=False, **cfg)
    sd = seeded_state_dict(net, 5)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params, aux = convert_reference_ckpt({f'nets.depth.{k}': v for k, v in sd.items()},
                                         {'net': {'depth': cfg}})
    x = np.random.RandomState(3).standard_normal((B, H, W, 3)).astype(np.float32)
    jnet = JaxDepthNet(pretrained=False, **cfg)
    out = _quiet(jax.jit(lambda v, x: jnet.apply(v, x, train=False)),
                 {'params': params['depth'], **aux.get('depth', {})}, x)
    want = {k: _nchw(v) for k, v in out.items() if k in ('disp', 'disp_stereo', 'mask')}
    return net.eval(), sd, (params['depth'], aux.get('depth', {})), x, want


def _net_outputs(net, x) -> dict:
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    return {k: {s: t.numpy() for s, t in v.items()} for k, v in out.items()
            if k in ('disp', 'disp_stereo', 'mask')}


@pytest.mark.parametrize('name', NAMES)
def test_a_port_state_dict_is_a_reference_checkpoint(name):
    """The JAX net built from the port's keys predicts what the port predicts, and
    its params and `batch_stats` come back through `depth_state_dict_from_jax` bitwise."""
    net, sd, (params, aux), x, want = net_pair(name)
    got = _net_outputs(net, x)
    assert sorted(got) == sorted(want) and 'disp' in got
    assert ('mask' in got) == bool(NET_CASES[name].get('mask_name'))
    for k in want:
        assert sorted(got[k]) == sorted(want[k])
        for s in want[k]:
            np.testing.assert_allclose(got[k][s], want[k][s], rtol=0, atol=DISP_ATOL,
                                       err_msg=f'{k}[{s}]')
    back = depth_state_dict_from_jax(jax.tree.map(np.asarray, params), net.out_sc,
                                     jax.tree.map(np.asarray, aux.get('batch_stats')))
    assert sorted(back) == sorted(sd)
    assert [k for k in sd if not np.array_equal(back[k].numpy(), sd[k])] == []


@pytest.mark.parametrize('aux', ['carried', 'left_behind'])
def test_train_state_from_jax_carries_the_decoder_statistics(aux):
    """A JAX `TrainState` of CADepth (both decoders) into a fresh port net: its
    `aux` running statistics become the decoders' BatchNorm buffers. Left behind
    (the fault), the buffers keep their initial 0 / 1."""
    import jax.numpy as jnp

    from slowtv_monodepth_tpu import parsers as jparsers
    from slowtv_monodepth_tpu.core.trainer import TrainState
    from slowtv_monodepth_tpu_torch.core.checkpoint import train_state_from_jax
    _, sd, (params, stats), *_ = net_pair('cadepth')
    cfg = {'net': {'depth': net_cfg('cadepth')}, 'optimizer': {'type': 'adam', 'lr': 1e-4}}
    tx = jparsers.make_optimizer(cfg, steps_per_epoch=1, accumulate=1)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params={'depth': params},
                       aux={'depth': stats if aux == 'carried' else {}},
                       opt_state=tx.init({'depth': params}), bad_step=jnp.asarray(-1, jnp.int32))
    nets = torch.nn.ModuleDict({'depth': _quiet(DepthNet, pretrained=False, **net_cfg('cadepth'))})
    train_state_from_jax(jax.tree.map(np.asarray, state), nets, parsers.make_optimizer(cfg, nets),
                         nets['depth'].out_sc)
    running = {k: b.numpy() for k, b in nets['depth'].named_buffers() if 'running' in k}
    assert len(running) == 2 * 2 * 5
    stale = [k for k, b in running.items() if not np.array_equal(b, sd[k])]
    assert sorted(stale) == ([] if aux == 'carried' else sorted(running))


def test_ddvnet_with_a_mask_raises():
    with pytest.raises(KeyError, match='DDVNet'):
        DepthNet(enc_name=ENC, pretrained=False, dec_name='ddvnet',
                 mask_name='explainability', num_ch_mask=2)


def _conv0(ch_in: int, ch_out: int) -> dict:
    return {'conv.weight': np.zeros((ch_out, ch_in, 3, 3), np.float32),
            'conv.bias': np.zeros(ch_out, np.float32)}


def reference_extras(name: str, net) -> dict:
    """What a reference checkpoint of `net` holds beyond the port's keys, shaped as the
    reference makes it: HR-Depth's row-0 conv_0s (in = the first stage's channels,
    halved past column 0; out = half of in), DiffNet's out convs outside `out_sc`,
    DDV-Net's bins."""
    extras = {}
    for dec in ('disp', 'mask'):
        if dec not in net.decoders:
            continue
        pre = f'decoders.{dec}'
        if name == 'hrdepth':
            c = CONVNEXT_SPECS[ENC]['channels'][0]  # duplicated: row 0 = row 1
            for col in range(4):
                ch_in = c if col == 0 else c // 2
                extras.update({f'{pre}.convs.0{col}_conv_0.{k}': v
                               for k, v in _conv0(ch_in, ch_in // 2).items()})
        elif name == 'diffnet':
            for i in set(range(4)) - set(net.out_sc):
                ch = net.decoders[dec].num_ch_dec[i]
                out_ch = net.decoders[dec].out_ch
                extras[f'{pre}.convs.outconv_{i}.weight'] = np.zeros((out_ch, ch, 3, 3), np.float32)
                extras[f'{pre}.convs.outconv_{i}.bias'] = np.zeros(out_ch, np.float32)
        elif name == 'ddvnet':
            extras[f'{pre}.bins'] = np.arange(128, dtype=np.float32) / 128
    return extras


UNUSED = {
    'hrdepth': [f'decoders.{d}.convs.0{c}_conv_0.conv.{p}' for d in ('disp', 'mask')
                for c in range(4) for p in ('weight', 'bias')],
    'ddvnet': ['decoders.disp.bins'],
    'diffnet': [f'decoders.{d}.convs.outconv_{i}.{p}' for d in ('disp', 'mask')
                for i in (1, 3) for p in ('weight', 'bias')],
    'cadepth': [],
    'superdepth': [],
}


@pytest.mark.parametrize('name', NAMES)
def test_the_unused_reference_keys_are_pinned(name):
    net = net_pair(name)[0]
    assert net.unused_reference_keys() == UNUSED[name]
    assert sorted(reference_extras(name, net)) == sorted(UNUSED[name])


@pytest.mark.parametrize('name', NAMES)
def test_a_reference_checkpoint_serves(name, tmp_path):
    """The port's keys plus the reference's unused ones, saved as a reference
    checkpoint: `BenchmarkPredictor` serves it as the port net predicts."""
    net, sd, _, x, want = net_pair(name)
    full = {**sd, **reference_extras(name, net)}
    save_checkpoint(tmp_path / 'ref.ckpt', {'depth': {k: torch.from_numpy(v)
                                                      for k, v in full.items()}},
                    {'net': {'depth': dict(net_cfg(name), pretrained=False)}})
    pred = BenchmarkPredictor(device='cpu')
    served = _quiet(pred.load_model, tmp_path / 'ref.ckpt')
    got = pred.forward_batch({'imgs': x}, served)
    np.testing.assert_allclose(got, np.transpose(want['disp'][0], (0, 2, 3, 1)), rtol=0,
                               atol=DISP_ATOL)


@pytest.mark.parametrize('fault', ['one_more_key', 'a_missing_key'])
def test_the_load_path_raises_on_any_other_key(fault):
    net, sd, *_ = net_pair('hrdepth')
    full = {**sd, **reference_extras('hrdepth', net)}
    if fault == 'one_more_key':
        full['decoders.disp.convs.04_conv_2.conv.weight'] = np.zeros(1, np.float32)
    else:
        del full['decoders.disp.convs.04_conv_1.conv.weight']
    fresh = _quiet(DepthNet, pretrained=False, **net_cfg('hrdepth'))
    with pytest.raises(RuntimeError, match='04_conv'):
        load_net(fresh, {k: torch.from_numpy(v) for k, v in full.items()})


def test_frozen_bn_catches_the_decoder_batchnorm():
    """`frozen_bn` picks BatchNorm affine parameters by type: CADepth's decoder ones
    are among them, as the JAX package's substring 'bn' catches them."""
    net = net_pair('cadepth')[0]
    got = {id(p) for p in parsers.bn_params(torch.nn.ModuleDict({'depth': net}))}
    want = {id(p) for k, p in net.named_parameters() if '.conv.1.' in k and 'decoders' in k}
    assert len(want) == 2 * 2 * 5 and want <= got
