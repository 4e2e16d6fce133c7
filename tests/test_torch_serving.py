"""Port differential for the serving edges: ops, geometry, checkpoint,
`BenchmarkPredictor` and the quickstart, against the JAX package.

The quickstart test runs both quickstarts' steps on the same png: the JAX
one (`api/quickstart/run.py`: `load_img` -> DepthNet -> `resize`) and the
port's CLI (`slowtv_monodepth_tpu_torch.quickstart`: checkpoint ->
`BenchmarkPredictor.load_model` -> `predict` -> `.npy`), on the CPU with a
small ConvNeXt. Tolerance: atol 1e-5 on disparities (as the slice tests);
geometry atol 1e-6 (a few float32 operations); resize atol 1e-5 (the two
sides compute the fractional source coordinate by different float32
formulas: measured 1.7e-6 at non-integer factors).
"""
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu import ops as jops
from slowtv_monodepth_tpu_torch import ops as tops
from slowtv_monodepth_tpu_torch.core import (BenchmarkPredictor, load_checkpoint,
                                             net_state_dict, save_checkpoint)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import depth_cfg, seeded_pair  # noqa: E402
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_if_passed, drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('src,dst', [((12, 20), (24, 40)), ((24, 40), (12, 20)),
                                     ((24, 40), (17, 29)), ((9, 13), (32, 32))])
def test_resize_matches_jax(src, dst):
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    want = np.asarray(jops.resize(jnp.asarray(x), dst))
    got = tops.resize(_nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_upsample_and_standardize_match_jax():
    x = np.random.RandomState(1).rand(2, 5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tops.upsample2x_nearest(_nchw(x)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jops.upsample2x_nearest(jnp.asarray(x))))
    np.testing.assert_allclose(
        tops.standardize(_nchw(x)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jops.standardize(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize('fn', ['to_scaled', 'to_inv', 'blend_stereo'])
def test_geometry_matches_jax(fn):
    rs = np.random.RandomState(2)
    a = rs.rand(2, 6, 40, 1).astype(np.float32)
    b = rs.rand(2, 6, 40, 1).astype(np.float32)
    if fn == 'to_scaled':
        got = [t.permute(0, 2, 3, 1).numpy() for t in tops.to_scaled(_nchw(a), 0.1, 100)]
        want = [np.asarray(t) for t in jops.to_scaled(jnp.asarray(a), 0.1, 100)]
    elif fn == 'to_inv':
        a[0, 0, :3, 0] = [0.0, -1.0, 1e-9]
        got = [tops.to_inv(_nchw(a)).permute(0, 2, 3, 1).numpy()]
        want = [np.asarray(jops.to_inv(jnp.asarray(a)))]
    else:
        got = [tops.blend_stereo(_nchw(a), _nchw(b)).permute(0, 2, 3, 1).numpy()]
        want = [np.asarray(jops.blend_stereo(jnp.asarray(a), jnp.asarray(b)))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope='module')
def ckpt(request, tmp_path_factory):
    """A reference-layout checkpoint of a seeded ConvNeXt-atto depth net."""
    cfg = depth_cfg(out_scales=(0, 1, 2, 3))
    net, params = seeded_pair(cfg, seed=7)
    path = tmp_path_factory.mktemp('ckpt') / 'atto.ckpt'
    save_checkpoint(path, {'depth': net.state_dict()},
                    {'net': {'depth': cfg}, 'trainer': {'min_depth': 0.1, 'max_depth': 100}})
    failed = request.session.testsfailed
    yield path, net, params, cfg
    drop_if_passed(request, failed, path.parent)


def test_checkpoint_layout_reads_back(ckpt):
    path, net, _, cfg = ckpt
    sd, got_cfg = load_checkpoint(path)
    assert got_cfg['net']['depth'] == cfg
    assert all(k.startswith('nets.depth.') for k in sd)
    for k, v in net.state_dict().items():
        assert torch.equal(net_state_dict(sd, 'depth')[k], v)


def test_quickstart_cli_matches_jax_quickstart(ckpt, tmp_path):
    from PIL import Image

    from api.quickstart import run as jax_run
    from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
    from slowtv_monodepth_tpu_torch import quickstart

    path, _, params, cfg = ckpt
    img_dir, out_dir = tmp_path / 'imgs', tmp_path / 'out'
    img_dir.mkdir()
    rgb = (np.random.RandomState(3).rand(100, 150, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(img_dir / 'scene.png')

    quickstart.main(Namespace(ckpt_file=path, img_dir=img_dir, img_ext='.png',
                              out_dir=out_dir, out_ext=['.npy', '.png'],
                              width=160, height=96, device='cpu'))
    got = np.load(out_dir / 'scene.npy')
    assert (out_dir / 'scene.png').is_file()

    img, ref_shape = jax_run.load_img(img_dir / 'scene.png', 160, 96)
    jnet = JaxDepthNet(**cfg, pretrained=False)   # one jit: faster than op by op
    disp = jax.jit(lambda p, x: jnet.apply({'params': p}, x, train=False)['disp'][0])(
        params, jnp.asarray(img))
    want = np.asarray(jax_run.resize(disp, tuple(ref_shape))).squeeze()
    assert got.shape == want.shape == (100, 150)
    np.testing.assert_allclose(got, want, atol=ATOL)


class _Dataset:
    def __init__(self, imgs):
        self.imgs, self.h, self.w = imgs, imgs.shape[1], imgs.shape[2]

    def __len__(self):
        return len(self.imgs)


class _Loader:
    """A data loader's (x, *rest) batches of standardized NHWC images."""

    def __init__(self, imgs, b):
        self.dataset, self.b = _Dataset(imgs), b

    def __iter__(self):
        imgs = self.dataset.imgs
        for i in range(0, len(imgs), self.b):
            yield {'imgs': imgs[i:i + self.b]}, None


@pytest.mark.parametrize('blend', [False, True])
def test_benchmark_predictor_over_loader(ckpt, blend):
    path, net, _, _ = ckpt
    pred = BenchmarkPredictor('cpu')
    model = pred.load_model(path)
    imgs = np.random.RandomState(4).standard_normal((3, 64, 96, 3)).astype(np.float32)
    out = pred(model, _Loader(imgs, b=2), use_stereo_blend=blend)
    assert out.shape == (3, 64, 96)

    with torch.no_grad():
        x = _nchw(imgs)
        disp = net(x)['disp'][0]
        if blend:
            disp = tops.blend_stereo(disp, net(x.flip(-1))['disp'][0].flip(-1))
    want = tops.to_scaled(disp, 0.1, 100)[0][:, 0].numpy()
    # Batches of 2 + 1 vs one batch of 3: float32 sums in another order.
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_port_imports_no_jax_and_nothing_the_card_lacks():
    code = (
        'import sys\n'
        'import slowtv_monodepth_tpu_torch, slowtv_monodepth_tpu_torch._build\n'
        'import slowtv_monodepth_tpu_torch.ops, slowtv_monodepth_tpu_torch.models\n'
        'import slowtv_monodepth_tpu_torch.core, slowtv_monodepth_tpu_torch.quickstart\n'
        'import chip_smoke\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '    ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "matplotlib",\n'
        '     "slowtv_monodepth_tpu"))\n'
        'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_cfg_is_the_kbr_cfg():
    """`chip_smoke.py` carries the KBR cfg inline (no yaml on the card)."""
    import chip_smoke
    from slowtv_monodepth_tpu.config import load_yaml
    cfg = load_yaml(ROOT / 'cfg' / 'kbr' / 'default.yaml')
    assert chip_smoke.KBR_DEPTH_CFG == cfg['net']['depth']
    assert chip_smoke.KBR_TRAINER_CFG == {k: cfg['trainer'][k]
                                          for k in ('min_depth', 'max_depth')}


def test_chip_smoke_refuses_without_a_card():
    """No CUDA here: the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_fused_blocks_checkpoint_serves_through_predictor_and_quickstart(tmp_path):
    """The slice with the fused ConvNeXt blocks on: a checkpoint whose cfg says
    `fused_blocks: True` -> `BenchmarkPredictor.load_model` -> `quickstart.predict`,
    against the JAX quickstart's steps on the same image file."""
    from PIL import Image

    from api.quickstart import run as jax_run
    from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
    from slowtv_monodepth_tpu_torch import quickstart
    from slowtv_monodepth_tpu_torch.models.encoders.convnext import ConvNeXtBlock

    cfg = depth_cfg(out_scales=(0, 1, 2, 3))
    net, params = seeded_pair(cfg, seed=8)
    fused_cfg = {**cfg, 'fused_blocks': True}
    save_checkpoint(tmp_path / 'fused.ckpt', {'depth': net.state_dict()},
                    {'net': {'depth': fused_cfg}, 'trainer': {'min_depth': 0.1, 'max_depth': 100}})
    model = BenchmarkPredictor('cpu').load_model(tmp_path / 'fused.ckpt')
    blocks = [m for m in model.modules() if isinstance(m, ConvNeXtBlock)]
    assert len(blocks) == 12 and all(m.fused for m in blocks)
    assert not any(m.fused for m in net.modules() if isinstance(m, ConvNeXtBlock))

    rgb = (np.random.RandomState(5).rand(100, 150, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / 'scene.png')
    got = quickstart.predict(model, quickstart.load_img(tmp_path / 'scene.png'), 160, 96)

    img, ref_shape = jax_run.load_img(tmp_path / 'scene.png', 160, 96)
    jnet = JaxDepthNet(**cfg, pretrained=False)   # one jit: faster than op by op
    disp = jax.jit(lambda p, x: jnet.apply({'params': p}, x, train=False)['disp'][0])(
        params, jnp.asarray(img))
    want = np.asarray(jax_run.resize(disp, tuple(ref_shape))).squeeze()
    assert got.shape == want.shape == (100, 150)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # The same weights served unfused give the same map (one more sum order).
    np.testing.assert_allclose(got, quickstart.predict(net, rgb.astype(np.float32) / 255, 160, 96),
                               atol=ATOL)


def test_training_cfg_passes_fused_blocks_to_the_depth_net():
    """`fused_blocks` is a constructor argument of the net, so a cfg's
    `net.depth` section reaches it through `parsers.get_net` with no new flag."""
    from slowtv_monodepth_tpu_torch import parsers
    from slowtv_monodepth_tpu_torch.models.encoders.convnext import ConvNeXtBlock
    for fused in (True, False):
        nets = parsers.get_net({'depth': {**depth_cfg(), 'fused_blocks': fused}})
        assert all(m.fused == fused for m in nets['depth'].modules()
                   if isinstance(m, ConvNeXtBlock))
