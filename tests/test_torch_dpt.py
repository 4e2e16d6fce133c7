"""Port differentials for the ViT encoders (ViT-B/16, ViT-L/16, hybrid R50+ViT-B), the
DPT decoder, their weight bridge, initial weights, and a DPT depth net's trainer
micro-step.

Same numpy inputs (seeded) through the JAX package's modules and the port's, the port
on the CPU. Weights: drawn with numpy in the shapes of the JAX module's flax `init`
(`_draw`: biases, scales and the cls token off their initial 0 / 1, so a misplaced one
shows), carried to the port by `models.from_jax` (float64 kept).

- `ViTEncoder` at dim 64, 4 blocks, 2 heads, hooks (0, 1, 2, 3), each readout (ignore,
  add, project), on 160x448 images: a 10x28 token grid, so the 24x24 position
  embeddings shrink along the rows and grow along the columns (trap T6); the hybrid
  with its ResNetV2 stem at full width (stages (3, 4, 9), 1024 channels at stride 16)
  and a 64-wide trunk on 64x96 images, whose 7x7 / 2 and 3x3 / 2 TF-SAME convs pad
  (2, 3) and (0, 1);
- `DptDecoder` at `num_ch_dec` 16 on a 4-level pyramid whose stride-32 level is 7 rows
  high (so the fusion snaps 14 rows back to 13), as a disparity decoder, a mask decoder
  and a virtual-stereo decoder at two out scales;
- each: outputs and the gradient of every parameter and of the input for a random
  projection of every output, the port in float64 against the JAX package in float64
  (`jax.enable_x64`: flax's float32 LayerNorm and GroupNorm variance is E[x^2] - E[x]^2),
  and the port's float32 outputs against the same oracle;
- `DepthNet` with every DPT encoder, with and without masks and virtual stereo, and
  `AutoencoderNet(dec_name='dpt')`, which fuses its skips as the JAX one does;
- flax's initial weights, per tensor, and the bridge bitwise;
- one trainer micro-step of `cfg/benchmark/default.yaml` with `net.depth` set to
  `dpt_vitb16_384` + `dpt` (supports (-1, 1), as Monodepth2-M's; the hybrid's modules are
  held above, its micro-step on the card),
  the ViT cut to dim 64 and 4 blocks, the ResNet-18 pose net to one block a stage,
  B=2, 64x96: the port's float32 step (its warp and photometric kernels take float32
  only) against the JAX package's in float64: loss, its terms and every gradient.

Tolerances, each of a tensor's largest JAX magnitude: float64 outputs and gradients
1e-9 (measured <= 2.1e-13, the hybrid's gradients); the port's float32 outputs 1e-5
(measured <= 5.2e-6, the decoder's), the hybrid's 1e-4 (`F32_HYBRID_RTOL`); the
trainer's loss and terms rtol 1e-5, its gradients per tensor 1e-3 of the largest JAX
magnitude plus 1e-7, as
`tests/test_torch_families.py` holds a float32 micro-step, the ResNet-18 pose net's as
one vector at 2e-3 relative L2 (`POSE_GRAD_L2`). Initial weights: each kernel's
standard deviation within 10% of flax's. Each trap has a fault that fails its check
(`MUTANTS`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu.models.decoders.dpt import DptDecoder as JaxDpt
from slowtv_monodepth_tpu.models.encoders import RESNET_SPECS as JAX_RESNET_SPECS
from slowtv_monodepth_tpu.models.encoders import VIT_SPECS as JAX_VIT_SPECS
from slowtv_monodepth_tpu.models.encoders.vit import ViTEncoder as JaxViT
from slowtv_monodepth_tpu.models.import_reference import convert_reference_ckpt
from slowtv_monodepth_tpu_torch.core import HeavyLogger
from slowtv_monodepth_tpu_torch.core.trainer import MonoDepthTrainer
from slowtv_monodepth_tpu_torch.models import AutoencoderNet, DepthNet, from_jax
from slowtv_monodepth_tpu_torch.models.decoders import DECODERS, dpt
from slowtv_monodepth_tpu_torch.models.encoders import RESNET_SPECS, VIT_SPECS, vit
from slowtv_monodepth_tpu_torch.models.init import init_like_flax
from test_torch_families import (CFG, CUT_LAYERS, LOSS_RTOL, compare_grads, load_merge_yaml,
                                 make_batch, seeded_weights, supp_of)
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

F64_RTOL, F32_RTOL, INIT_RTOL = 1e-9, 1e-5, 0.1
# The hybrid's float32 features: 16 GroupNorm bottlenecks, the last 9 on a 4x6 map, then
# the trunk (measured 3.8e-5 of the stride-32 map's largest magnitude).
F32_HYBRID_RTOL = 1e-4
# The ResNet-18 pose net's float32 gradient as one vector, relative L2 to the float64 one
# (`tests/test_torch_resnet.py`'s GRAD32_L2: a train-mode BatchNorm's float32 batch
# statistics put single tensors 1e-3 off while the whole stays close).
POSE_GRAD_L2 = 2e-3
VIT_KW = dict(dim=64, depth=4, heads=2, hooks=(0, 1, 2, 3), channels=(16, 32, 48, 64))
HYBRID_KW = dict(dim=64, depth=4, heads=2, hooks=(2, 3), channels=(256, 512, 64, 64),
                 hybrid=True)
VIT_SHAPE, HYBRID_SHAPE = (2, 160, 448), (1, 64, 96)   # (b, h, w): token grids 10x28, 4x6
CASES = {'ignore': (VIT_KW, 'ignore', VIT_SHAPE), 'add': (VIT_KW, 'add', VIT_SHAPE),
         'project': (VIT_KW, 'project', VIT_SHAPE),
         'hybrid': (HYBRID_KW, 'project', HYBRID_SHAPE)}
# The decoder's pyramid: strides 4 to 32 of a 208x288 image, the stride-32 level rounded up.
DEC_CH, DEC_SIZES = (16, 24, 32, 48), ((52, 72), (26, 36), (13, 18), (7, 9))
DEC_CASES = {'disp': dict(out_ch=1, out_act='sigmoid', out_sc=(0, 1, 2, 3)),
             'mask': dict(out_ch=2, out_act='relu', out_sc=(0, 1, 2, 3)),
             'stereo': dict(out_ch=3, out_act='sigmoid', out_sc=(0, 2))}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _draw(shapes: dict, seed: int) -> dict:
    """Float64 params in the shapes of a flax `init` (`jax.eval_shape`: an eager `init`
    of the hybrid stem takes ~20 s), drawn with numpy: kernels N(0, 1 / fan-in) (fan-in
    every axis but the last: a conv's taps and inputs, an attention kernel's (dim,
    heads) or (heads, hd)), scales 1 + N(0, 0.01), biases and the cls token N(0, 0.01),
    the position embeddings N(0, 0.02^2) as flax draws them."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if 'pos_embed' in key:
            return 0.02 * rs.standard_normal(a.shape)
        if key.endswith("['kernel']"):
            return rs.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        return float(key.endswith("['scale']")) + 0.1 * rs.standard_normal(a.shape)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bridge(fn, *args) -> dict:
    """A `from_jax` converter keeping float64 (the bridge casts to float32) -> numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(from_jax, '_t', lambda a: torch.from_numpy(np.array(a)))
        return {k: v.numpy() for k, v in fn(*args).items()}


def _nchw(a) -> np.ndarray:
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _faults(got: dict, want: dict, rtol: float) -> list:
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    bad = []
    for k, w in want.items():
        g = np.asarray(got[k])
        if g.shape != w.shape or not np.abs(g - w).max() <= rtol * max(np.abs(w).max(), 1e-300):
            bad.append(k)
    return bad


# ------------------------------------------------------------------ 1. the encoders
def _images(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape + (3,))


def _feat_projections(feats) -> list:
    rs = np.random.RandomState(7)
    return [rs.standard_normal(np.shape(f)) for f in feats]


@functools.lru_cache(maxsize=None)
def jax_vit(case: str) -> dict:
    """The JAX encoder in float64 (one jit): features (NCHW), the gradient of the
    projection loss for every parameter (the port's keys) and for the input (NCHW)."""
    kw, readout, shape = CASES[case]
    mod = JaxViT(readout=readout, **kw)
    x = _images(shape)
    with jax.enable_x64(True):
        params = _draw(jax.eval_shape(mod.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1,) + shape[1:] + (3,)))['params'], 1)
        proj = _feat_projections(jax.eval_shape(lambda: mod.apply({'params': params}, x)))

        def loss(p, x):
            feats = mod.apply({'params': p}, x)
            return sum((f * q).sum() for f, q in zip(feats, proj)), feats
        (_, feats), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            params, x)
        feats, gp, gx = _f64((feats, gp, gx))
    return {'params': params, 'x': x, 'proj': [_nchw(q) for q in proj],
            'feats': [_nchw(f) for f in feats], 'grads': _bridge(from_jax._vit, gp),
            'dx': _nchw(gx)}


def port_vit(case: str, dtype=torch.float64) -> dict:
    kw, readout, _ = CASES[case]
    run = jax_vit(case)
    enc = vit.ViTEncoder(readout=readout, **kw).to(dtype)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in
                         _bridge(from_jax._vit, run['params']).items()})
    x = torch.from_numpy(_nchw(run['x'])).to(dtype).requires_grad_()
    feats = enc(x)
    sum((f * torch.from_numpy(q).to(dtype)).sum() for f, q in zip(feats, run['proj'])).backward()
    return {'feats': [f.detach().numpy() for f in feats],
            'grads': {k: p.grad.numpy() for k, p in enc.named_parameters()},
            'dx': x.grad.numpy()}


def _vit_faults(got: dict, want: dict, rtol: float = F64_RTOL, grads: bool = True) -> list:
    bad = [f'feat{i}' for i in _faults(dict(enumerate(got['feats'])),
                                       dict(enumerate(want['feats'])), rtol)]
    if grads:
        bad += _faults(got['grads'], want['grads'], rtol)
        bad += ['dx'] * bool(_faults({'dx': got['dx']}, {'dx': want['dx']}, rtol))
    return bad


@pytest.mark.parametrize('case', sorted(CASES))
def test_vit_matches_jax_in_float64(case):
    """Features, every parameter's gradient and the input's."""
    got, want = port_vit(case), jax_vit(case)
    assert _vit_faults(got, want) == []
    _, _, (b, h, w) = CASES[case]
    assert [f.shape[2:] for f in got['feats']] == [(h // r, w // r) for r in (4, 8, 16, 32)]
    assert ('act_postprocess1.0.project.0.weight' in got['grads']) == (case == 'project')


@pytest.mark.parametrize('case', sorted(CASES))
def test_vit_float32_outputs_match_jax(case):
    rtol = F32_HYBRID_RTOL if case == 'hybrid' else F32_RTOL
    assert _vit_faults(port_vit(case, torch.float32), jax_vit(case), rtol, grads=False) == []


def test_vit_refuses_a_shape_off_the_patch_grid():
    with pytest.raises(ValueError, match=r'Input must be a multiple of 16. \(72x96\)'):
        vit.ViTEncoder(**VIT_KW)(torch.zeros(1, 3, 72, 96))


def test_same_padding_is_asymmetric():
    """The hybrid stem's convs on an even input: (2, 3) for 7x7 / 2, (0, 1) for 3x3 / 2."""
    x = torch.zeros(1, 1, 64, 96)
    assert vit._same_pad(x, 7, 2).shape[-2:] == (64 + 5, 96 + 5)
    y = vit._same_pad(torch.ones(1, 1, 4, 4), 7, 2)
    assert y[0, 0, :, 2].tolist() == [0, 0, 1, 1, 1, 1, 0, 0, 0]
    y = vit._same_pad(torch.ones(1, 1, 4, 4), 3, 2)
    assert y[0, 0, :, 0].tolist() == [1, 1, 1, 1, 0]


# ------------------------------------------------------------------ 2. the decoder
def _pyramid() -> list:
    rs = np.random.RandomState(3)
    return [rs.standard_normal((2, c) + hw) for c, hw in zip(DEC_CH, DEC_SIZES)]


def _dec(case: str, cls):
    kw = DEC_CASES[case]
    return cls(num_ch_enc=DEC_CH, enc_sc=(4, 8, 16, 32), num_ch_dec=16, out_sc=kw['out_sc'],
               out_ch=kw['out_ch'], out_act=kw['out_act'])


@functools.lru_cache(maxsize=None)
def jax_dpt(case: str) -> dict:
    mod = _dec(case, JaxDpt)
    feats = [np.transpose(f, (0, 2, 3, 1)) for f in _pyramid()]
    with jax.enable_x64(True):
        params = _draw(jax.eval_shape(mod.init, jax.random.PRNGKey(2), feats)['params'], 4)
        outs = jax.eval_shape(lambda: mod.apply({'params': params}, feats))
        rs = np.random.RandomState(5)
        proj = {s: rs.standard_normal(o.shape) for s, o in sorted(outs.items())}

        def loss(p, feats):
            out = mod.apply({'params': p}, feats)
            return sum((out[s] * proj[s]).sum() for s in out), out
        (_, out), (gp, gf) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            params, feats)
        out, gp, gf = _f64((out, gp, gf))
    return {'params': params, 'proj': {s: _nchw(q) for s, q in proj.items()},
            'out': {s: _nchw(v) for s, v in out.items()},
            'grads': _bridge(from_jax._dpt, gp, DEC_CASES[case]['out_sc']),
            'dfeat': {i: _nchw(g) for i, g in enumerate(gf)}}


def port_dpt(case: str, dtype=torch.float64) -> dict:
    run = jax_dpt(case)
    dec = _dec(case, DECODERS['dpt']).to(dtype)
    dec.load_state_dict({k: torch.from_numpy(v) for k, v in _bridge(
        from_jax._dpt, run['params'], DEC_CASES[case]['out_sc']).items()})
    feats = [torch.from_numpy(f).to(dtype).requires_grad_() for f in _pyramid()]
    out = dec(feats)
    sum((out[s] * torch.from_numpy(q).to(dtype)).sum() for s, q in run['proj'].items()).backward()
    return {'out': {s: v.detach().numpy() for s, v in out.items()},
            'grads': {k: p.grad.numpy() for k, p in dec.named_parameters()},
            'dfeat': {i: f.grad.numpy() for i, f in enumerate(feats)}}


def _dpt_faults(got: dict, want: dict, rtol: float = F64_RTOL, parts=('out', 'grads', 'dfeat')):
    return [(p, k) for p in parts for k in _faults(got[p], want[p], rtol)]


@pytest.mark.parametrize('case', sorted(DEC_CASES))
def test_dpt_decoder_matches_jax_in_float64(case):
    got, want = port_dpt(case), jax_dpt(case)
    assert _dpt_faults(got, want) == []
    assert sorted(got['out']) == sorted(DEC_CASES[case]['out_sc'])
    # out[s] at stride 2^s of the 208x288 image; out[3] follows the unsnapped 7-row level.
    sizes = {0: (208, 288), 1: (104, 144), 2: (52, 72), 3: (28, 36)}
    assert {s: v.shape for s, v in got['out'].items()} == {
        s: (2, DEC_CASES[case]['out_ch']) + sizes[s] for s in DEC_CASES[case]['out_sc']}


@pytest.mark.parametrize('case', sorted(DEC_CASES))
def test_dpt_decoder_float32_outputs_match_jax(case):
    assert _dpt_faults(port_dpt(case, torch.float32), jax_dpt(case), F32_RTOL, ('out',)) == []


# ------------------------------------------------------------------ 3. the faults
def _erf_mlp(self, x):
    return self.fc2(F.gelu(self.fc1(x)))


def _erf_readout(self, tokens):
    cls, patches = tokens[:, :1], tokens[:, 1:]
    return F.gelu(self.project(torch.cat([patches, cls.expand_as(patches)], dim=-1)))


def _aliased_pos_embed(self, gh, gw):
    pos = self.model.pos_embed
    grid = pos[:, 1:].reshape(1, self.pos_grid, self.pos_grid, self.dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode='bilinear', align_corners=False)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def _unbiased_std_conv(self, x):
    w = self.weight
    w = (w - w.mean(dim=(1, 2, 3), keepdim=True)) * torch.rsqrt(
        w.var(dim=(1, 2, 3), keepdim=True) + 1e-6)
    return F.conv2d(vit._same_pad(x, self.kernel_size[0], self.stride[0]), w, None, self.stride)


def _symmetric_same(x, k, s):
    return F.pad(x, [(k - 1) // 2] * 4)


def _zero_padded_pool(x):
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 3, 2)


def _unflipped_convt(k):
    return from_jax._t(np.transpose(np.asarray(k), (2, 3, 0, 1)))


def _no_snap(self, x, skip=None):
    if skip is not None:
        x = x + self.resConfUnit1(skip)
    return self.out_conv(dpt._up2(self.resConfUnit2(x)))


def _corners_apart(x, shape):
    if tuple(x.shape[-2:]) == tuple(shape):
        return x
    return F.interpolate(x, size=tuple(shape), mode='bilinear', align_corners=False)


# name -> (the check it fails: a ViT case or a decoder case, where, attribute, fault)
MUTANTS = {
    'erf_gelu_mlp': ('ignore', vit.Mlp, 'forward', _erf_mlp),
    'erf_gelu_readout': ('project', vit.Readout, 'forward', _erf_readout),
    'aliased_pos_embed': ('add', vit.ViTEncoder, '_pos_embed', _aliased_pos_embed),
    'unbiased_std_conv': ('hybrid', vit.StdConv2dSame, 'forward', _unbiased_std_conv),
    'symmetric_same_pad': ('hybrid', vit, '_same_pad', _symmetric_same),
    'unflipped_conv_transpose': ('add', from_jax, '_convt', _unflipped_convt),
    'qkv_packed_kqv': ('ignore', from_jax, '_QKV', ('key', 'query', 'value')),
    'align_corners_false': ('disp', dpt, '_resize', _corners_apart),
}


@pytest.mark.parametrize('mutant', sorted(MUTANTS))
def test_the_checks_have_teeth(mutant, monkeypatch):
    case, where, attr, fault = MUTANTS[mutant]
    monkeypatch.setattr(where, attr, fault)
    if case in DEC_CASES:
        assert _dpt_faults(port_dpt(case), jax_dpt(case)) != []
    else:
        assert _vit_faults(port_vit(case), jax_vit(case)) != []


@pytest.mark.parametrize('fault', [None, 'zero_padded'])
def test_the_stem_max_pool_is_flax_s(fault, monkeypatch):
    """`max_pool_same` against the JAX stem's `jnp.pad(-inf)` + VALID `nn.max_pool` on a
    signed input. In the stem the pool follows a ReLU, so a pool padded with zeros there
    would give the same maps (every value is >= 0): a signed input tells them apart."""
    import flax.linen as fnn
    if fault:
        monkeypatch.setattr(vit, 'max_pool_same', _zero_padded_pool)
    x = -np.abs(np.random.RandomState(8).standard_normal((2, 10, 14, 3)))
    with jax.enable_x64(True):
        want = np.asarray(fnn.max_pool(jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)),
                                               constant_values=-jnp.inf),
                                       (3, 3), (2, 2), padding='VALID'))
    got = vit.max_pool_same(torch.from_numpy(_nchw(x)))
    assert np.array_equal(got.numpy(), _nchw(want)) == (fault is None)


def test_a_missing_snap_fails(monkeypatch):
    """Without the snap the stride-16 fusion adds 14 rows to 13."""
    monkeypatch.setattr(dpt.FusionBlock, 'forward', _no_snap)
    with pytest.raises(RuntimeError, match='size of tensor'):
        port_dpt('disp')


# --------------------------------------------------- 4. nets, initial weights, bridge
DPT_ENCODERS = ('dpt_vitb16_384', 'dpt_vitl16_384', 'dpt_vitb_rn50_384')
NET_VARIANTS = {'plain': {}, 'mask': dict(mask_name='explainability', num_ch_mask=2),
                'stereo': dict(use_virtual_stereo=True)}


@pytest.mark.parametrize('variant', sorted(NET_VARIANTS))
@pytest.mark.parametrize('enc', DPT_ENCODERS)
def test_dpt_depth_nets_build(enc, variant):
    """At published widths on the meta device: the decoders meet the encoder's pyramid
    (a forward at 192x640 checks every shape), the ViT-L's pyramid is MiDaS's."""
    with torch.device('meta'):
        net = DepthNet(enc_name=enc, dec_name='dpt', pretrained=False, **NET_VARIANTS[variant])
        out = net(torch.zeros(2, 3, 192, 640))
    spec = VIT_SPECS[enc.removeprefix('dpt_')]
    assert [tuple(f.shape[1:]) for f in out['depth_feats']] == [
        (c, 192 // r, 640 // r) for c, r in zip(spec['channels'], spec['reductions'])]
    assert {s: tuple(d.shape) for s, d in out['disp'].items()} == {
        s: (2, 1, 192 >> s, 640 >> s) for s in range(4)}
    assert ('mask' in out) == (variant == 'mask') and ('disp_stereo' in out) == (
        variant == 'stereo')
    if variant == 'mask':
        assert {tuple(m.shape[:2]) for m in out['mask'].values()} == {(2, 2)}
    assert isinstance(net.decoders['disp'], dpt.DptDecoder)


def test_the_autoencoder_builds_a_dpt_decoder_that_fuses_its_skips(monkeypatch):
    """`AutoencoderNet(dec_name='dpt')`: the decoder is built with `use_skip=False` and
    fuses its skips all the same, as the JAX one does: a skip changes the images."""
    with torch.device('meta'):
        net = AutoencoderNet(enc_name='dpt_vitb16_384', dec_name='dpt', pretrained=False)
    assert isinstance(net.decoder, dpt.DptDecoder) and net.decoder.refinenet1.resConfUnit1
    dec = _dec('disp', DECODERS['dpt']).double()
    feats = [torch.from_numpy(f) for f in _pyramid()]
    with torch.no_grad():
        a = dec(feats)[0]
        b = dec([feats[0] + 1.0] + feats[1:])[0]
    assert not torch.equal(a, b)


def test_fused_blocks_on_a_vit_raises():
    with pytest.raises(KeyError, match='fused_blocks'):
        DepthNet(enc_name='dpt_vitb16_384', dec_name='dpt', fused_blocks=True)


def test_the_net_gelu_does_not_reach_the_vit(cut_specs):
    """`gelu: 'exact'` and `'tanh'` build the same ViT (flax's tanh GELU, trap T5): the
    JAX `create_encoder` does not pass `gelu` to it either."""
    from slowtv_monodepth_tpu_torch.models.encoders import create_encoder
    x = torch.from_numpy(_nchw(_images((1, 32, 48))))
    outs = []
    for gelu in ('exact', 'tanh'):
        torch.manual_seed(0)
        enc = create_encoder('dpt_vitb16_384', gelu=gelu)[0]
        with torch.no_grad():
            outs.append(enc(x.float()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize('case', ['project', 'hybrid'])
def test_initial_weights_are_flax_s(case):
    """`init_like_flax` against the JAX module's `init` (shapes: `jax.eval_shape`), per
    tensor: zero biases, norms at 1 / 0, the cls token 0, `pos_embed` at std 0.02, and every
    kernel's standard deviation within 10% of flax's `lecun_normal`, 1 / sqrt(fan-in) with
    the fan-in of the JAX kernel (attention: dim for q / k / v, heads x hd for out; a
    ConvTranspose's kh kw in)."""
    kw, readout, shape = CASES[case]
    torch.manual_seed(0)
    enc = init_like_flax(vit.ViTEncoder(readout=readout, **kw))
    shapes = jax.eval_shape(JaxViT(readout=readout, **kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape[1:] + (3,)))['params']

    def flax_std(path, a):
        key = jax.tree_util.keystr(path)
        if 'pos_embed' in key:
            return np.full(a.shape, 0.02)
        if "['kernel']" in key:
            if any(t in key for t in ("'query'", "'key'", "'value'")):
                fan_in = a.shape[0]
            elif "'out'" in key:
                fan_in = a.shape[0] * a.shape[1]
            else:
                fan_in = np.prod(a.shape[:-1])
            return np.full(a.shape, 1 / np.sqrt(fan_in))
        return np.full(a.shape, 1.0 if key.endswith("['scale']") else 0.0)
    want = _bridge(from_jax._vit, jax.tree_util.tree_map_with_path(flax_std, shapes))
    got = {k: t.numpy() for k, t in enc.state_dict().items()}
    assert sorted(got) == sorted(want)
    bad = []
    for k, g in got.items():
        w = want[k]
        if g.shape != w.shape:
            bad.append((k, 'shape'))
        elif k.endswith('pos_embed') or (g.ndim > 1 and not k.endswith('cls_token')):
            if abs(g.std() / w.flat[0] - 1) > INIT_RTOL:
                bad.append((k, g.std() / w.flat[0]))
        else:
            if not np.array_equal(g, w):
                bad.append((k, 'value'))
    assert bad == []
    dec = init_like_flax(_dec('disp', DECODERS['dpt']))
    assert all(float(p.detach().abs().max()) == 0 for k, p in dec.named_parameters()
               if k.endswith('bias'))


@pytest.mark.parametrize('case', ['project', 'hybrid'])
def test_the_bridge_round_trip_is_bitwise(case):
    """port keys <- `from_jax` <- JAX params; the packed qkv back to flax's q / k / v and
    the flipped ConvTranspose back to flax's kernel give the JAX leaves bit for bit."""
    run = jax_vit(case)
    sd = _bridge(from_jax._vit, run['params'])
    dim = CASES[case][0]['dim']
    heads = CASES[case][0]['heads']
    for i in range(CASES[case][0]['depth']):
        att = run['params'][f'block{i}']['attn']
        qkv = sd[f'model.blocks.{i}.attn.qkv.weight']
        for j, t in enumerate(('query', 'key', 'value')):
            assert np.array_equal(qkv[j * dim:(j + 1) * dim].T.reshape(dim, heads, -1),
                                  att[t]['kernel'])
        assert np.array_equal(sd[f'model.blocks.{i}.attn.proj.weight'].T.reshape(heads, -1, dim),
                              att['out']['kernel'])
    for s in (0, 1):
        if f'reassemble{s}' in run['params']:
            k = sd[f'act_postprocess{s + 1}.4.weight']
            assert np.array_equal(np.transpose(k[:, :, ::-1, ::-1], (2, 3, 0, 1)),
                                  run['params'][f'reassemble{s}']['up']['kernel'])
    dec = jax_dpt('stereo')
    back = _bridge(from_jax._dpt, dec['params'], (0, 2))
    assert sorted(back) == sorted(_dec('stereo', DECODERS['dpt']).state_dict())
    assert np.array_equal(back['out2.4.weight'], np.transpose(
        dec['params']['out2']['conv3']['kernel'], (3, 2, 0, 1)))


# ------------------------------------------------------ 5. the trainer micro-step
VIT_CUT = dict(dim=64, depth=4, heads=2)


@pytest.fixture(scope='module')
def cut_specs():
    """The ViTs cut to dim 64 and 4 blocks (the hooks, readout and pyramid widths as
    published), the ResNet-18 pose net to one block a stage, in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for specs in (VIT_SPECS, JAX_VIT_SPECS):
            mp.setitem(specs, 'vitb16_384', dict(specs['vitb16_384'], **VIT_CUT,
                                                 hooks=(0, 1, 2, 3)))
            mp.setitem(specs, 'vitb_rn50_384', dict(specs['vitb_rn50_384'], **VIT_CUT,
                                                    hooks=(2, 3)))
        for specs in (RESNET_SPECS, JAX_RESNET_SPECS):
            mp.setitem(specs, 'resnet18', dict(specs['resnet18'], layers=CUT_LAYERS))
        yield


def dpt_cfg(enc: str) -> dict:
    """`cfg/benchmark/default.yaml` with `net.depth` a DPT net and Monodepth2-M's supports
    (the default names none): `chip_smoke.dpt_cfg`'s, without pretrained files."""
    cfg = load_merge_yaml(CFG / 'benchmark' / 'default.yaml')
    cfg['net']['depth'].update(enc_name=enc, dec_name='dpt', pretrained=False)
    cfg['net']['pose'].update(pretrained=False)
    cfg['dataset']['kitti_lmdb']['supp_idxs'] = [-1, 1]
    return cfg


@pytest.mark.parametrize('enc', ['dpt_vitb16_384', 'dpt_vitb_rn50_384'])
def test_chip_smoke_dpt_cfgs_are_the_file(enc):
    """`chip_smoke.family_cfg` of a DPT net (no yaml on the card) is `dpt_cfg` as the files
    give it, the published `pretrained` switches kept."""
    import chip_smoke
    want = load_merge_yaml(CFG / 'benchmark' / 'default.yaml')
    want['net']['depth'].update(enc_name=enc, dec_name='dpt')
    want['dataset']['kitti_lmdb']['supp_idxs'] = [-1, 1]
    assert chip_smoke.family_cfg(enc) == want
    assert {**want, 'net': {**want['net'], 'depth': {**want['net']['depth'], 'pretrained': False},
                            'pose': {**want['net']['pose'], 'pretrained': False}}} == dpt_cfg(enc)


@functools.lru_cache(maxsize=None)
def jax_step(enc: str) -> dict:
    """Micro-step 1 of the JAX trainer in float64 (one jit): the depth net drawn by
    `_draw`, the pose net from `models.seeded_state_dict` through the
    JAX package's reference converter."""
    from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
    cfg = dpt_cfg(enc)
    supp = supp_of(cfg)
    x, y = make_batch(supp, hints=False, seed=40)
    pose_w = {k: v for k, v in seeded_weights(cfg).items() if k.startswith('nets.pose.')}
    pose_p, pose_aux = convert_reference_ckpt(pose_w, cfg)
    jnet = JaxDepthNet(**cfg['net']['depth'])
    depth_p = jax.eval_shape(jnet.init, jax.random.PRNGKey(3), jnp.asarray(x['imgs']))['params']
    with jax.enable_x64(True):
        params = {'depth': _draw(depth_p, 6), 'pose': _f64(pose_p['pose'])}
        aux = {'depth': {}, 'pose': _f64(pose_aux['pose'])}
        jx, jy = _f64((x, y))
        jt = JaxTrainer(cfg)
        (v, (ld, *_)), g = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(p, aux, jx, jy, supp, jax.random.PRNGKey(41), True),
            has_aux=True))(params)
        v, ld, g = _f64((v, ld, g))
    sd = {'depth': _bridge(from_jax.depth_state_dict_from_jax, params['depth']),
          'pose': _bridge(from_jax.pose_state_dict_from_jax, params['pose'],
                          aux['pose']['batch_stats'])}
    grads = {**{f'depth.{k}': w for k, w in _bridge(from_jax.depth_state_dict_from_jax,
                                                    g['depth']).items()},
             **{f'pose.{k}': w for k, w in _bridge(from_jax.pose_state_dict_from_jax,
                                                   g['pose']).items()}}
    return {'cfg': cfg, 'x': x, 'y': y, 'sd': sd, 'loss': float(v),
            'terms': {k: float(t) for k, t in ld.items() if k.startswith('loss_')},
            'grads': grads}


@pytest.mark.parametrize('enc', ['dpt_vitb16_384'])
def test_dpt_trainer_micro_step_matches_jax(enc, cut_specs):
    """Loss, loss terms and every gradient of both nets; then the image logger's rerun
    of the same batch draws its grids."""
    run = jax_step(enc)
    with torch.device('meta'):
        trainer = MonoDepthTrainer(run['cfg'])
    trainer.nets.to_empty(device='cpu')
    for name, sd in run['sd'].items():
        trainer.nets[name].load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    trainer.nets.train()
    x, y = ({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in d.items()}
            for d in (run['x'], run['y']))
    loss, (ld, _) = trainer.loss_fn(x, y, supp_of(run['cfg']))
    loss.backward()
    np.testing.assert_allclose(loss.item(), run['loss'], rtol=LOSS_RTOL)
    assert sorted(k for k in ld if k.startswith('loss_')) == sorted(run['terms'])
    for k, v in run['terms'].items():
        np.testing.assert_allclose(ld[k].item(), v, rtol=LOSS_RTOL, err_msg=k)
    got = {f'{n}.{k}': p.grad.numpy() for n, net in trainer.nets.items()
           for k, p in net.named_parameters()}
    depth = [k for k in got if k.startswith('depth.')]
    assert compare_grads({k: got[k] for k in depth}, {k: run['grads'][k] for k in depth}) == []
    assert all(np.abs(got[k]).max() > 0 for k in depth)
    pose = sorted(set(got) - set(depth))
    num = sum(float(((got[k] - run['grads'][k]) ** 2).sum()) for k in pose)
    den = sum(float((run['grads'][k] ** 2).sum()) for k in pose)
    assert pose and sorted(pose) == sorted(set(run['grads']) - set(depth))
    assert (num / den) ** 0.5 <= POSE_GRAD_L2

    class Images:  # the image logger's writer interface
        def __init__(self):
            self.images = {}

        def add_images(self, tag, img, global_step):
            self.images[tag] = img

        def add_text(self, tag, text, global_step):
            pass
    writer = Images()
    HeavyLogger().log_step(trainer, (x, y, {}), supp_of(run['cfg']), writer, epoch=0)
    assert 'train_pred/disp' in writer.images and all(
        g.shape[:2] == (1, 3) and np.isfinite(g).all() for g in writer.images.values())


@pytest.mark.parametrize('enc', ['dpt_vitb16_384', 'dpt_vitb_rn50_384'])
def test_a_dpt_checkpoint_saves_restores_and_serves(enc, cut_specs, tmp_path):
    """A DPT `DepthNet` with virtual stereo (seeded weights) through `save_checkpoint`,
    `load_checkpoint` + `load_net` (every tensor back bitwise, none dropped) and
    `BenchmarkPredictor` (its disparities those of the net's eval forward)."""
    from slowtv_monodepth_tpu_torch.core import load_checkpoint, load_net, save_checkpoint
    from slowtv_monodepth_tpu_torch.core.checkpoint import net_state_dict
    from slowtv_monodepth_tpu_torch.core.predictors import BenchmarkPredictor
    from slowtv_monodepth_tpu_torch.models import seeded_state_dict
    cfg = dict(enc_name=enc, dec_name='dpt', pretrained=False, use_virtual_stereo=True)
    with torch.device('meta'):   # shapes only: every tensor is loaded
        net = DepthNet(**cfg)
    assert net.unused_reference_keys() == []
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(net, 9).items()}
    net.to_empty(device='cpu').load_state_dict(sd)
    save_checkpoint(tmp_path / 'last.ckpt', {'depth': net.state_dict()}, {'net': {'depth': cfg}})
    sd, saved_cfg = load_checkpoint(tmp_path / 'last.ckpt')
    with torch.device('meta'):
        fresh = DepthNet(**saved_cfg['net']['depth'])
    load_net(fresh.to_empty(device='cpu'), net_state_dict(sd, 'depth'))
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in fresh.state_dict().items())
    x = _images((2, 64, 96)).astype(np.float32)
    pred = BenchmarkPredictor(device='cpu')
    got = pred.forward_batch({'imgs': x}, pred.load_model(tmp_path / 'last.ckpt'))
    with torch.no_grad():
        want = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))['disp'][0]
    assert got.shape == (2, 64, 96, 1)
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).numpy())
