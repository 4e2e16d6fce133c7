"""Port differentials for the MiDaS `DPT_Large` baseline: `MidasDPT`, the importer of the
released file, the `pretrained: True` graft of `dpt_vitl16_384`, and `MidasPredictor`
through `export_preds`.

The ViT-L/16 is cut to dim 64, 4 blocks, 2 heads and pyramid widths (16, 32, 48, 64) in
both packages (`VIT_SPECS['vitl16_384']`, patched here; the DPT decoder keeps its 256
channels): a fake MiDaS state dict in the file's layout, drawn with numpy (as the JAX
package's `test_midas_converter_structure` lays one out, with the trunk's final norm
and classifier head the released file also holds), goes through the port's importer
and the JAX package's `convert_midas_dpt`.

- `MidasDPT` from the file: the port in float64 against the JAX net in float64, 1e-9 of
  the largest JAX magnitude (measured <= 1e-13);
- the dropped keys pinned; one key more or one key missing raises; `.pt` and `.npz`
  load alike;
- the graft: a `DepthNet('dpt_vitl16_384', pretrained=True)` takes the file's trunk,
  readouts and reassemble stages bitwise (`MidasDPT`'s encoder), as the JAX package's
  `load_pretrained_encoder` grafts them;
- `MidasPredictor.preprocess` / `postprocess` against the JAX predictor's at a shape
  that shrinks (480x640 -> 384x512) and one that grows (72x120 -> 224x384), trap T7:
  `jax.image.resize(..., 'cubic')` (Keys a = -0.5, antialiased when shrinking); the
  port in float32 against the JAX predictor in float64, 1e-5 of the largest JAX magnitude
  (measured <= 2e-7; the JAX package's own float32 is 3e-5 off where it grows 384x512 to
  480x640: it draws its resize weights in float32); the missing-file and
  unknown-variant errors, word for word;
- `export_preds` with `midas.DPT_Large` on a synthetic set (`--device cpu`) against the
  JAX `MidasPredictor` over the same batches: 1e-4 of the largest JAX disparity
  (the JAX side in float32 through 4 blocks and the 256-wide decoder; measured 1.5e-5).
Faults that must fail: cv2-style bicubic (a = -0.75, clamped taps, no antialias:
`F.interpolate(mode='bicubic')`) in the predictor, a dropped-key list one key short.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slowtv_monodepth_tpu import paths as jpaths
from slowtv_monodepth_tpu.core.predictors import MidasPredictor as JaxMidasPredictor
from slowtv_monodepth_tpu.models.encoders import VIT_SPECS as JAX_VIT_SPECS
from slowtv_monodepth_tpu.models.encoders import pretrained as jpre
from slowtv_monodepth_tpu.models.import_midas import convert_midas_dpt as jax_convert
from slowtv_monodepth_tpu.models.midas import MidasDPT as JaxMidasDPT
from slowtv_monodepth_tpu_torch import paths
from slowtv_monodepth_tpu_torch.core import predictors
from slowtv_monodepth_tpu_torch.core.predictors import MidasPredictor
from slowtv_monodepth_tpu_torch.data import collate_items
from slowtv_monodepth_tpu_torch.export_preds import compute_preds
from slowtv_monodepth_tpu_torch.models import DepthNet, from_jax, import_midas
from slowtv_monodepth_tpu_torch.models.encoders import VIT_SPECS, pretrained
from slowtv_monodepth_tpu_torch.models.midas import MidasDPT
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

F64_RTOL, RESIZE_RTOL, PRED_RTOL = 1e-9, 1e-5, 1e-4
CUT = dict(dim=64, depth=4, heads=2, hooks=(0, 1, 2, 3), channels=(16, 32, 48, 64))
STEM = 'midas/dpt_large-midas-2f21e586'
DROPPED = ['pretrained.model.norm.weight', 'pretrained.model.norm.bias',
           'pretrained.model.head.weight', 'pretrained.model.head.bias',
           'scratch.refinenet4.resConfUnit1.conv1.weight',
           'scratch.refinenet4.resConfUnit1.conv1.bias',
           'scratch.refinenet4.resConfUnit1.conv2.weight',
           'scratch.refinenet4.resConfUnit1.conv2.bias']


@pytest.fixture(scope='module', autouse=True)
def cut_vitl():
    with pytest.MonkeyPatch.context() as mp:
        for specs in (VIT_SPECS, JAX_VIT_SPECS):
            mp.setitem(specs, 'vitl16_384', dict(specs['vitl16_384'], **CUT))
        yield


@functools.lru_cache(maxsize=None)
def midas_sd() -> dict:
    """A MiDaS DPT state dict of the cut ViT-L in the released file's layout: weights
    N(0, 1 / fan-in), biases and norm scales N(0, 0.01) about 0 / 1."""
    dim, depth, chans = CUT['dim'], CUT['depth'], CUT['channels']
    shapes = {'pretrained.model.cls_token': (1, 1, dim),
              'pretrained.model.pos_embed': (1, 577, dim),
              'pretrained.model.patch_embed.proj.weight': (dim, 3, 16, 16),
              'pretrained.model.patch_embed.proj.bias': (dim,),
              'pretrained.model.norm.weight': (dim,), 'pretrained.model.norm.bias': (dim,),
              'pretrained.model.head.weight': (1000, dim), 'pretrained.model.head.bias': (1000,)}
    for i in range(depth):
        pre = f'pretrained.model.blocks.{i}'
        shapes.update({f'{pre}.norm1.weight': (dim,), f'{pre}.norm1.bias': (dim,),
                       f'{pre}.attn.qkv.weight': (3 * dim, dim), f'{pre}.attn.qkv.bias': (3 * dim,),
                       f'{pre}.attn.proj.weight': (dim, dim), f'{pre}.attn.proj.bias': (dim,),
                       f'{pre}.norm2.weight': (dim,), f'{pre}.norm2.bias': (dim,),
                       f'{pre}.mlp.fc1.weight': (4 * dim, dim), f'{pre}.mlp.fc1.bias': (4 * dim,),
                       f'{pre}.mlp.fc2.weight': (dim, 4 * dim), f'{pre}.mlp.fc2.bias': (dim,)})
    for s, ch in enumerate(chans):
        k, post = s + 1, f'pretrained.act_postprocess{s + 1}'
        shapes.update({f'{post}.0.project.0.weight': (dim, 2 * dim),
                       f'{post}.0.project.0.bias': (dim,),
                       f'{post}.3.weight': (ch, dim, 1, 1), f'{post}.3.bias': (ch,)})
        if s != 2:
            shapes[f'{post}.4.weight'] = {0: (ch, ch, 4, 4), 1: (ch, ch, 2, 2),
                                          3: (ch, ch, 3, 3)}[s]
            shapes[f'{post}.4.bias'] = (ch,)
        shapes[f'scratch.layer{k}_rn.weight'] = (256, ch, 3, 3)
        for unit in ('resConfUnit1', 'resConfUnit2'):
            for c in ('conv1', 'conv2'):
                shapes[f'scratch.refinenet{k}.{unit}.{c}.weight'] = (256, 256, 3, 3)
                shapes[f'scratch.refinenet{k}.{unit}.{c}.bias'] = (256,)
        shapes[f'scratch.refinenet{k}.out_conv.weight'] = (256, 256, 1, 1)
        shapes[f'scratch.refinenet{k}.out_conv.bias'] = (256,)
    for i, (o, c, kk) in {0: (128, 256, 3), 2: (32, 128, 3), 4: (1, 32, 1)}.items():
        shapes[f'scratch.output_conv.{i}.weight'] = (o, c, kk, kk)
        shapes[f'scratch.output_conv.{i}.bias'] = (o,)
    rs = np.random.RandomState(11)
    sd = {}
    for key, shape in sorted(shapes.items()):
        if len(shape) > 1 and not key.endswith(('cls_token', 'pos_embed')):
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = float(key.endswith('norm1.weight') or key.endswith('norm2.weight')
                      or key == 'pretrained.model.norm.weight') + 0.1 * rs.standard_normal(shape)
        sd[key] = v.astype(np.float32)
    return sd


def write_midas_file(root, suffix='.npz', sd=None) -> None:
    f = root / f'{STEM}{suffix}'
    f.parent.mkdir(parents=True, exist_ok=True)
    sd = midas_sd() if sd is None else sd
    if suffix == '.npz':
        np.savez(f, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, f)


def port_net(sd=None, dtype=torch.float64) -> MidasDPT:
    net = MidasDPT().to(dtype)
    net.load_state_dict(import_midas.convert_midas_dpt(midas_sd() if sd is None else sd,
                                                       list(net.state_dict())))
    return net.eval()


def _images(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape + (3,)).astype(np.float32)


# ------------------------------------------------------------------ 1. the importer
def test_midas_dpt_matches_jax_in_float64():
    x = _images((2, 64, 96)).astype(np.float64)
    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jax_convert(midas_sd()))
        want = np.asarray(jax.jit(JaxMidasDPT().apply)(variables, x))
    with torch.no_grad():
        got = port_net()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 1, 64, 96)
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)), rtol=0,
                               atol=F64_RTOL * np.abs(want).max())


def test_the_dropped_keys_are_pinned():
    assert import_midas.dropped_keys() == DROPPED
    sd = midas_sd()
    net = MidasDPT()
    assert sorted(set(sd) - set(DROPPED)) == sorted(
        k.replace('encoder.', 'pretrained.', 1).replace('decoder.out0.', 'scratch.output_conv.', 1)
        .replace('decoder.', 'scratch.', 1) for k in net.state_dict())


@pytest.mark.parametrize('fault', ['one_key_more', 'one_key_missing', 'a_dropped_key_kept'])
def test_any_other_key_raises(fault, monkeypatch):
    sd = dict(midas_sd())
    if fault == 'one_key_more':
        sd['scratch.refinenet4.resConfUnit3.conv1.weight'] = np.zeros(1, np.float32)
    elif fault == 'one_key_missing':
        del sd['pretrained.model.blocks.1.attn.qkv.bias']
    else:   # the list one key short: that key lands on no module of the net
        monkeypatch.setattr(import_midas, 'dropped_keys', lambda levels=4: DROPPED[:-1])
    with pytest.raises(KeyError, match='resConfUnit|qkv.bias'):
        port_net(sd)


def test_a_file_without_the_dropped_keys_loads():
    sd = {k: v for k, v in midas_sd().items() if k not in DROPPED}
    assert port_net(sd) is not None


@pytest.mark.parametrize('suffix', ['.pt', '.npz'])
def test_pt_and_npz_load_alike(suffix, tmp_path):
    write_midas_file(tmp_path, suffix)
    got = import_midas.load_midas_state_dict(tmp_path / f'{STEM}{suffix}')
    assert sorted(got) == sorted(midas_sd())
    assert all(np.array_equal(got[k], v) for k, v in midas_sd().items())


# ------------------------------------------------------------------ 2. the graft
def test_pretrained_dpt_vitl16_grafts_the_midas_trunk(tmp_path, monkeypatch):
    """The encoder of `DepthNet('dpt_vitl16_384')` after `load_pretrained_encoder` equals
    `MidasDPT`'s from the same file bitwise, and the JAX package's graft (through
    `from_jax`) gives the same bits."""
    write_midas_file(tmp_path)
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    monkeypatch.setattr(jpaths, 'MODEL_ROOTS', [tmp_path])
    monkeypatch.setattr(jpre, 'MODEL_ROOTS', [tmp_path])
    with torch.device('meta'):
        meta = DepthNet(enc_name='dpt_vitl16_384', dec_name='dpt')
    net = DepthNet(enc_name='dpt_vitl16_384', dec_name='dpt')
    assert pretrained.load_pretrained_encoder(net, 'dpt_vitl16_384')
    got = net.encoder.state_dict()
    want = {k[len('encoder.'):]: v for k, v in port_net(dtype=torch.float32).state_dict().items()
            if k.startswith('encoder.')}
    assert sorted(got) == sorted(want) == sorted(meta.encoder.state_dict())
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    jvars = jpre.load_pretrained_encoder({'params': {'encoder': {}}}, 'dpt_vitl16_384')
    back = from_jax._vit(jax.tree.map(np.asarray, jvars['params']['encoder']))
    assert sorted(back) == sorted(got)
    assert [k for k in got if not torch.equal(back[k], got[k])] == []


def test_a_file_without_the_trunk_warns_and_keeps_the_draw(tmp_path, monkeypatch, caplog):
    write_midas_file(tmp_path, sd={k: v for k, v in midas_sd().items()
                                   if not k.startswith('pretrained.model.blocks.0.')})
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    net = DepthNet(enc_name='dpt_vitl16_384', dec_name='dpt')
    before = {k: v.clone() for k, v in net.encoder.state_dict().items()}
    assert not pretrained.load_pretrained_encoder(net, 'dpt_vitl16_384')
    assert 'MiDaS-layout weights expected' in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in net.encoder.state_dict().items())


# ------------------------------------------------------------------ 3. the predictor
def jax_preprocess(imgs: np.ndarray) -> np.ndarray:
    """The JAX predictor's preprocess in float64 (in float32 it draws its resize weights
    in float32: 3e-5 of the largest value off its float64 self where it grows 384x512 to
    480x640, the port's float32 2e-7)."""
    with jax.enable_x64(True):
        return np.asarray(JaxMidasPredictor().preprocess(imgs.astype(np.float64)))


@pytest.mark.parametrize('shape,resized', [((480, 640), (384, 512)), ((72, 120), (224, 384))],
                         ids=['shrink', 'grow'])
def test_pre_and_postprocess_match_jax(shape, resized):
    """Preprocess shrinks (grows) the image, postprocess grows (shrinks) the prediction back."""
    imgs = _images((2,) + shape, 1)
    want = jax_preprocess(imgs)
    got = MidasPredictor('cpu').preprocess(imgs)
    assert got.shape == (2, 3) + resized
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())
    pred = np.abs(_images((2,) + resized, 2)[..., :1])
    with jax.enable_x64(True):
        want = np.asarray(JaxMidasPredictor().postprocess(jnp.asarray(pred, jnp.float64), imgs))
    got = MidasPredictor('cpu').postprocess(torch.from_numpy(pred).permute(0, 3, 1, 2), imgs)
    assert got.shape == (2, 1) + shape
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())


def test_cv2_style_bicubic_fails_the_check(monkeypatch):
    """The predictor's resize as cv2's bicubic (`F.interpolate`: a = -0.75, clamped taps,
    no antialias): off in both directions."""
    def cv2_like(x, shape, method='bilinear'):
        return F.interpolate(x, size=tuple(shape), mode='bicubic', align_corners=False)
    monkeypatch.setattr(predictors, 'resize', cv2_like)
    for shape in ((480, 640), (72, 120)):
        imgs = _images((2,) + shape, 1)
        want = jax_preprocess(imgs)
        got = MidasPredictor('cpu').preprocess(imgs).numpy()
        assert np.abs(got - np.transpose(want, (0, 3, 1, 2))).max() > \
            RESIZE_RTOL * np.abs(want).max()


def test_missing_file_and_unknown_variant_raise_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    monkeypatch.setattr(jpaths, 'MODEL_ROOTS', [tmp_path])
    for name, err in (('DPT_Large', FileNotFoundError), ('DPT_Banana', ValueError)):
        with pytest.raises(err) as want:
            JaxMidasPredictor().load_model(name)
        with pytest.raises(err) as got:
            MidasPredictor('cpu').load_model(name)
        assert str(got.value) == str(want.value)


class SyntheticSet:
    """Five standardized images at 32x384 (MiDaS keeps the scale at 1: the forward is
    cheap), in an evaluation dataset's item layout."""

    def __init__(self, n=5, h=32, w=384):
        self.h, self.w = h, w
        self.imgs = _images((n, h, w), 3)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return {'imgs': self.imgs[i]}, {}, {'items': str(i)}

    @staticmethod
    def collate_fn(items):
        return collate_items(items)


def test_export_preds_midas_matches_jax(tmp_path, monkeypatch):
    """`compute_preds(ckpt='midas.DPT_Large', device='cpu')`: a batch of 2, 2 and 1 over a
    synthetic set, against the JAX `MidasPredictor` over the same batches."""
    from slowtv_monodepth_tpu_torch.data import DataLoader
    write_midas_file(tmp_path)
    monkeypatch.setattr(paths, 'MODEL_ROOTS', [tmp_path])
    monkeypatch.setattr(jpaths, 'MODEL_ROOTS', [tmp_path])
    ds = SyntheticSet()
    got = compute_preds(None, 'midas.DPT_Large', device='cpu', ds=ds, batch_size=2,
                        num_workers=0)
    jpred = JaxMidasPredictor()
    want = jpred(jpred.load_model('DPT_Large'),
                 DataLoader(ds, batch_size=2, num_workers=0, shuffle=False, drop_last=False))
    assert got.shape == want.shape == (5, 32, 384)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_RTOL * np.abs(want).max())
