"""Port differential: `core.predictors` against the JAX package's predictors.

The same seeded ConvNeXt-atto depth weights (`test_torch_models.seeded_pair`,
through both weight bridges) predict over the same small loader of
standardized images: the port's `BenchmarkPredictor` on the CPU against the
JAX `BenchmarkPredictor` (its jitted forward, `arg_jitted_forward`), with and
without the stereo blend, through `__call__` and through `apply`; the
per-dataset shape table; the registry; and the 4-D and all-zero prediction
checks. Tolerance: atol 1e-5 on the predicted (scaled) disparities, as the
slice tests hold the raw ones (measured ~1e-6).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu import PRED_REG as JAX_PRED_REG
from slowtv_monodepth_tpu import trigger_preds as jax_trigger_preds
from slowtv_monodepth_tpu.core.predictors import BenchmarkPredictor as JaxPredictor
from slowtv_monodepth_tpu.core.predictors import arg_jitted_forward
from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
from slowtv_monodepth_tpu_torch.core.predictors import BenchmarkPredictor, MonoDepthPredictor
from slowtv_monodepth_tpu_torch.registry import PRED_REG, trigger_preds

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import depth_cfg, seeded_pair  # noqa: E402
from torch_threads import two_torch_threads  # noqa: F401,E402

ATOL = 1e-5
SHAPES = ('ddad', 'diode', 'kitti', 'kitti_lmdb', 'mannequin', 'mannequin_lmdb', 'mapfree',
          'nyud', 'sintel', 'syns_patches', 'tum')


class _Dataset:
    def __init__(self, imgs):
        self.imgs, self.h, self.w = imgs, imgs.shape[1], imgs.shape[2]

    def __len__(self):
        return len(self.imgs)


class _Loader:
    """A data loader's (x, y, m) batches of standardized NHWC images, the last one partial."""

    def __init__(self, imgs, b):
        self.dataset, self.b = _Dataset(imgs), b

    def __iter__(self):
        imgs = self.dataset.imgs
        for i in range(0, len(imgs), self.b):
            items = [str(j) for j in range(i, min(i + self.b, len(imgs)))]
            yield {'imgs': imgs[i:i + self.b]}, {}, {'items': items}


@pytest.fixture(scope='module')
def pair():
    """(port predictor, port net, JAX predictor, JAX forward, loader)."""
    cfg = depth_cfg()
    net, params = seeded_pair(cfg, seed=11)
    port = BenchmarkPredictor('cpu')
    port.min_depth, port.max_depth = 0.1, 100
    jax_pred = JaxPredictor()
    jax_pred.min_depth, jax_pred.max_depth = 0.1, 100
    fwd = arg_jitted_forward(JaxDepthNet(**cfg, pretrained=False), {'params': params})
    imgs = np.random.RandomState(12).standard_normal((5, 64, 96, 3)).astype(np.float32)
    return port, net, jax_pred, fwd, _Loader(imgs, b=2)


@pytest.mark.parametrize('blend', [False, True])
def test_predictions_match_jax(pair, blend):
    port, net, jax_pred, fwd, dl = pair
    got = port(net, dl, use_stereo_blend=blend)
    want = jax_pred(fwd, dl, use_stereo_blend=blend)
    assert got.shape == want.shape == (5, 64, 96)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_apply_matches_jax(pair):
    port, net, jax_pred, fwd, dl = pair
    got, want = [], []
    port.apply(net, dl, lambda batch, pred, out: out.append((batch[2]['items'], pred)), False, got)
    jax_pred.apply(fwd, dl, lambda batch, pred, out: out.append((batch[2]['items'], pred)), False,
                   want)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.ndim == 4 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_prediction_differential_has_teeth(pair):
    """A stereo blend that forgets to flip the second prediction back fails."""
    port, net, jax_pred, fwd, dl = pair

    class Unflipped(BenchmarkPredictor):
        @torch.no_grad()
        def forward_batch(self, x, net, use_stereo_blend=False):
            t = torch.from_numpy(x['imgs']).permute(0, 3, 1, 2)
            from slowtv_monodepth_tpu_torch.ops import blend_stereo
            pred = blend_stereo(self.forward(net, t), self.forward(net, t.flip(-1)))
            return self.postprocess(pred, x['imgs']).permute(0, 2, 3, 1).numpy()

    bad = Unflipped('cpu')
    bad.min_depth, bad.max_depth = 0.1, 100
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad(net, dl, use_stereo_blend=True),
                                   jax_pred(fwd, dl, use_stereo_blend=True), atol=ATOL)


def test_shape_table_and_registry_match_jax():
    trigger_preds()
    jax_trigger_preds()
    for name in SHAPES:
        assert BenchmarkPredictor.get_img_shape(name) == JaxPredictor.get_img_shape(name), name
    with pytest.raises(KeyError):
        BenchmarkPredictor.get_img_shape('unknown')
    assert MonoDepthPredictor.get_img_shape('kitti') is None
    assert set(PRED_REG) == set(JAX_PRED_REG) == {'ours', 'midas', 'newcrfs'}
    assert PRED_REG['ours'] is BenchmarkPredictor
    with pytest.raises(NotImplementedError, match=r'ROADMAP queue A item 10d \(A10d\)'):
        PRED_REG['newcrfs']('cpu').load_model('indoor')
    with pytest.raises(FileNotFoundError, match='MiDaS "DPT_Large" weights not found'):
        PRED_REG['midas']('cpu').load_model('DPT_Large')   # no file under the model roots
    with pytest.raises(TypeError):
        MonoDepthPredictor('cpu')  # `load_model` is abstract


def test_empty_and_non_4d_predictions_are_refused(pair):
    """All-zero maps and predictions that are not (b, h, w, 1) raise, as in JAX."""
    _, net, _, _, dl = pair

    class Zero(BenchmarkPredictor):
        def postprocess(self, pred, imgs):
            return pred * 0

    class Flat(BenchmarkPredictor):
        def forward_batch(self, x, net, use_stereo_blend=False):
            return super().forward_batch(x, net, use_stereo_blend)[..., 0]

    for cls in (Zero, Flat):
        p = cls('cpu')
        p.min_depth = p.max_depth = None
        match = 'empty predictions' if cls is Zero else 'must be 4-D'
        with pytest.raises(ValueError, match=match):
            p(net, dl)
        if cls is Flat:
            with pytest.raises(ValueError, match=match):
                p.apply(net, dl, lambda *a: None)
    jax_zero = type('JaxZero', (JaxPredictor,),
                    {'postprocess': lambda self, pred, imgs: pred * 0})()
    with pytest.raises(ValueError, match='empty predictions'):
        jax_zero(pair[3], dl)
