"""Port differential: the offline evaluator (`slowtv_monodepth_tpu_torch.eval`).

The same seeded inputs go through the JAX package's `eval` (cv2, scikit-learn)
and the port's copy (numpy and scipy only): the four metric families, the
alignment modes, the crops, the prediction resize, the Chamfer query, the
depth edges, and whole `run`s in and out of process.

Tolerances. Continuous metrics (AbsRel, RMSE, LogSI, Chamfer, EdgeAcc, ...):
rtol 1e-5. Thresholded metrics (the deltas, F-Score, IoU, DirAcc, Dir (-),
Dir (+)) are step functions: each pixel or point that crosses a threshold
moves a per-item percentage by 100 / N, so their tolerance is one flipped
pixel of the item with the fewest (100 / (n_items * N_min), N stated per
test). The resize: bilinear and nearest bitwise `cv2.resize`; bicubic within
3 float32 ulps of the source's largest value (measured 2.5 at 192x640 ->
375x1242: OpenCV's bicubic sums are not restated to the bit; no eval cfg
upsamples bicubic). The Chamfer distances and the
Canny and Sobel edge maps: bitwise.

Each differential fails on an injected fault: `F.interpolate` for the resize,
a dropped Eigen crop, a swapped lsqr shift sign, un-subsampled Chamfer points.
"""
import numpy as np
import pytest

from slowtv_monodepth_tpu import eval as jeval
from slowtv_monodepth_tpu.eval import edges as jedges
from slowtv_monodepth_tpu.eval import metrics as jmetrics
from slowtv_monodepth_tpu_torch import eval as teval
from slowtv_monodepth_tpu_torch.eval import edges as tedges
from slowtv_monodepth_tpu_torch.eval import metrics as tmetrics
from slowtv_monodepth_tpu_torch.utils.resize import resize
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

RTOL = 1e-5
BICUBIC_ULPS = 3
THRESHOLDED = ('delta', 'F-Score', 'IoU', 'Dir')
SYNS_ARGS = {'min': 0.001, 'max': 100, 'use_eigen_crop': False,  # cfg/eval/syns_test.yaml
             'metrics': ['eigen', 'benchmark', 'pointcloud', 'ibims']}
EIGEN_ARGS = {'min': 0.001, 'max': 80, 'use_eigen_crop': True,  # cfg/eval/kitti_eigen.yaml
              'metrics': ['eigen', 'pointcloud']}


def assert_metrics_close(got: dict, want: dict, n_items: int, n_min: int) -> None:
    """Continuous metrics within RTOL; thresholded ones within one flipped pixel
    of the item with the fewest (`n_min`) of `n_items`."""
    assert got.keys() == want.keys()
    step = 100 / (n_items * n_min)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        elif any(t in k for t in THRESHOLDED):
            assert abs(got[k] - w) <= step, (k, got[k], w, step)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=0, err_msg=k)


def _item(seed=0, shape=(60, 90), pred_shape=(32, 48)):
    """(disparity prediction, depth target, edge map, K): a smooth scene with a step."""
    rs = np.random.RandomState(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    target = (3 + 20 * yy + 5 * (xx > 0.6) + rs.rand(h, w)).astype(np.float32)
    target[rs.rand(h, w) < 0.1] = 0  # no measurement
    disp = 1 / (3 + 20 * yy[::2, ::2] + 5 * (xx[::2, ::2] > 0.55))
    pred = resize((2.5 * disp * (1 + 0.05 * rs.randn(*disp.shape))).astype(np.float32),
                  pred_shape, 'bilinear')
    edge = np.zeros(shape, bool)
    edge[:, int(0.6 * w)] = True
    K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return pred, target, edge, K


def _ulps(got, want, src) -> float:
    """Largest |got - want| in float32 ulps of the source's largest value (every
    output is a weighted sum of source values)."""
    return float(np.abs(got.astype(np.float64) - want).max() / np.spacing(np.abs(src).max()))


# ------------------------------------------------------------------- resize
@pytest.mark.parametrize('dst', [(376, 1242), (375, 1242), (720, 1280)])
@pytest.mark.parametrize('mode', ['nearest', 'bilinear', 'bicubic'])
def test_resize_is_cv2s(dst, mode):
    import cv2
    x = (0.01 + 0.5 * np.random.RandomState(0).rand(192, 640)).astype(np.float32)
    flag = {'nearest': cv2.INTER_NEAREST, 'bilinear': cv2.INTER_LINEAR,
            'bicubic': cv2.INTER_CUBIC}[mode]
    want = cv2.resize(x, dst[::-1], interpolation=flag)
    got = resize(x, dst, mode)
    assert got.dtype == np.float32 and got.shape == want.shape == dst
    if mode == 'bicubic':
        assert _ulps(got, want, x) <= BICUBIC_ULPS
    else:
        np.testing.assert_array_equal(got, want)


def test_resize_check_has_teeth():
    """`F.interpolate` (bilinear, align_corners=False) is not cv2's resize."""
    import cv2
    import torch
    import torch.nn.functional as F
    x = (0.01 + 0.5 * np.random.RandomState(0).rand(192, 640)).astype(np.float32)
    want = cv2.resize(x, (1242, 376), interpolation=cv2.INTER_LINEAR)
    got = F.interpolate(torch.from_numpy(x)[None, None], size=(376, 1242), mode='bilinear',
                        align_corners=False)[0, 0].numpy()
    assert _ulps(got, want, x) > BICUBIC_ULPS


def test_evaluator_upsample_is_the_jax_one():
    pred, target, _, _ = _item()
    for mode in ('nearest', 'bilinear', 'bicubic'):
        got = teval.MonoDepthEvaluator(interp_mode=mode).upsample(pred, target)
        want = jeval.MonoDepthEvaluator(interp_mode=mode).upsample(pred, target)
        assert got.shape == target.shape
        assert _ulps(got, want, pred) <= (BICUBIC_ULPS if mode == 'bicubic' else 0)


# ------------------------------------------------------------- metric families
def _masked(seed=1, n=4000):
    rs = np.random.RandomState(seed)
    target = (0.5 + 30 * rs.rand(n)).astype(np.float32)
    return (target * np.exp(0.2 * rs.randn(n))).astype(np.float32), target


@pytest.mark.parametrize('family', ['eigen', 'benchmark'])
def test_masked_metric_families_match_jax(family):
    pred, target = _masked()
    fn = f'metrics_{family}'
    assert_metrics_close(getattr(tmetrics, fn)(pred, target), getattr(jmetrics, fn)(pred, target),
                         1, len(pred))


def test_pointcloud_metrics_match_jax():
    pred, target, _, K = _item()
    depth = 1 / resize(pred, target.shape)
    mask = target > 0
    got = tmetrics.metrics_pointcloud(depth, target, mask, K)
    want = jmetrics.metrics_pointcloud(depth, target, mask, K)
    assert_metrics_close(got, want, 1, int(mask.sum()) // 2)  # the queried points


def test_ibims_metrics_match_jax():
    pred, target, edge, _ = _item()
    depth = np.where(target > 0, 1 / resize(pred, target.shape), 0).astype(np.float32)
    got = tmetrics.metrics_ibims(depth, target, edge)
    assert_metrics_close(got, jmetrics.metrics_ibims(depth, target, edge), 1, target.size)


def test_chamfer_distances_are_bitwise_the_jax_ones():
    rs = np.random.RandomState(2)
    pred = (10 * rs.rand(5001, 3)).astype(np.float32)
    target = (10 * rs.rand(4700, 3)).astype(np.float32)
    pairs = zip(tmetrics._chamfer_dist(pred, target), jmetrics._chamfer_dist(pred, target))
    for got, want in pairs:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_chamfer_check_has_teeth(monkeypatch):
    """A Chamfer query on every point (no every-2nd subsampling) fails."""
    def every_point(pred, target):
        from sklearn.neighbors import NearestNeighbors
        nn = NearestNeighbors(n_neighbors=1, algorithm='kd_tree').fit(target)
        p = nn.kneighbors(pred)[0].astype(np.float32).squeeze()
        nn.fit(pred)
        return p, nn.kneighbors(target)[0].astype(np.float32).squeeze()

    pred, target, _, K = _item()
    depth = 1 / resize(pred, target.shape)
    mask = target > 0
    want = jmetrics.metrics_pointcloud(depth, target, mask, K)
    monkeypatch.setattr(tmetrics, '_chamfer_dist', every_point)
    with pytest.raises(AssertionError):
        assert_metrics_close(tmetrics.metrics_pointcloud(depth, target, mask, K), want,
                             1, int(mask.sum()) // 2)


# --------------------------------------------------------------------- edges
@pytest.mark.parametrize('preprocess', ['log', 'inv', None])
@pytest.mark.parametrize('use_canny', [True, False])
def test_edges_are_bitwise_the_jax_ones(preprocess, use_canny):
    _, target, _, _ = _item(seed=3)
    mask = target > 0
    got = tedges.extract_edges(target, preprocess=preprocess, mask=mask, use_canny=use_canny)
    want = jedges.extract_edges(target, preprocess=preprocess, mask=mask, use_canny=use_canny)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def test_gaussian_blur_and_sobel_are_cv2s():
    import cv2
    x = (1 + 20 * np.random.RandomState(4).rand(96, 320)).astype(np.float32)
    blur = cv2.GaussianBlur(x, (3, 3), sigmaX=1, sigmaY=1)
    np.testing.assert_array_equal(tedges._gaussian_blur3(x, 1), blur)
    for axis, (dx, dy) in ((1, (1, 0)), (0, (0, 1))):
        np.testing.assert_array_equal(tedges._sobel5(blur, axis),
                                      cv2.Sobel(blur, ddepth=cv2.CV_64F, dx=dx, dy=dy, ksize=5))


# ----------------------------------------------------------- alignment, crops
@pytest.mark.parametrize('align_mode', ['median', 'lsqr', 1, 5.4])
@pytest.mark.parametrize('args', [SYNS_ARGS, EIGEN_ARGS], ids=['syns', 'eigen'])
def test_evaluator_item_matches_jax(align_mode, args):
    pred, target, edge, K = _item(seed=5)
    kw = {k: v for k, v in args.items() if k != 'metrics'}
    metrics = [m for m in args['metrics'] if m != 'ibims']
    got = teval.MonoDepthEvaluator(align_mode=align_mode, **kw)(pred, target, metrics, K)
    want = jeval.MonoDepthEvaluator(align_mode=align_mode, **kw)(pred, target, metrics, K)
    n = int(jeval.MonoDepthEvaluator(**kw).get_mask(target).sum())
    assert_metrics_close(got, want, 1, n // 2)  # pointcloud: every 2nd valid point
    if 'ibims' in args['metrics']:
        got = teval.MonoDepthEvaluator(align_mode=align_mode, **kw)(
            pred, target, args['metrics'], K, edge)
        want = jeval.MonoDepthEvaluator(align_mode=align_mode, **kw)(
            pred, target, args['metrics'], K, edge)
        assert_metrics_close(got, want, 1, int(edge.sum()) // 2)


@pytest.mark.parametrize('shape', [(375, 1242), (370, 1224), (480, 640)])
def test_crops_match_jax(shape):
    ev, jev = teval.MonoDepthEvaluator(), jeval.MonoDepthEvaluator()
    np.testing.assert_array_equal(ev._get_eigen_mask(shape), jev._get_eigen_mask(shape))
    if shape == (480, 640):
        np.testing.assert_array_equal(ev._get_nyud_mask(shape), jev._get_nyud_mask(shape))


@pytest.mark.parametrize('fault', ['no_eigen_crop', 'lsqr_sign'])
def test_evaluator_differential_has_teeth(fault, monkeypatch):
    pred, target, _, K = _item(seed=5)
    kw = {k: v for k, v in EIGEN_ARGS.items() if k != 'metrics'}
    want = jeval.MonoDepthEvaluator(align_mode='lsqr', **kw)(pred, target, ['eigen'], K)
    if fault == 'no_eigen_crop':
        kw['use_eigen_crop'] = False
    else:
        lsqr = teval.MonoDepthEvaluator._align_lsqr
        monkeypatch.setattr(teval.MonoDepthEvaluator, '_align_lsqr', staticmethod(
            lambda p, t: (lambda a, b: [a, -b])(*lsqr(p, t))))
    got = teval.MonoDepthEvaluator(align_mode='lsqr', **kw)(pred, target, ['eigen'], K)
    with pytest.raises(AssertionError):
        assert_metrics_close(got, want, 1, target.size)


# ----------------------------------------------------------------------- run
def _dataset(n=3, ragged=False):
    items = [_item(seed=10 + i, shape=(60 + (i if ragged else 0), 90)) for i in range(n)]
    preds = np.stack([p for p, _, _, _ in items])
    depth = [t for _, t, _, _ in items]
    data = {'depth': np.array(depth, dtype=object) if ragged else np.stack(depth),
            'K': np.stack([k for _, _, _, k in items])}
    if not ragged:
        data['edge'] = np.stack([e for _, _, e, _ in items])
        data['cat'] = np.array(['Outdoor'] * n)
        data['subcat'] = np.array(['Park', 'Forest', 'Park'][:n])
    return preds, data


@pytest.mark.parametrize('args,ragged', [(SYNS_ARGS, False), (EIGEN_ARGS, True)],
                         ids=['syns', 'kitti_eigen_object_targets'])
def test_run_matches_jax(args, ragged):
    preds, data = _dataset(ragged=ragged)
    got, items = teval.MonoDepthEvaluator(align_mode='lsqr', **args).run(preds, data, nproc=0)
    want, jitems = jeval.MonoDepthEvaluator(align_mode='lsqr', **args).run(preds, data, nproc=0)
    assert len(items) == len(jitems) == len(preds)
    n_min = min(int(e.sum()) for e in data['edge']) if 'edge' in data else 60 * 90 // 3
    assert_metrics_close(got, want, len(preds), n_min // 2)
    for a, b in zip(items, jitems):
        assert a.get('Cat') == b.get('Cat') and a.get('SubCat') == b.get('SubCat')


def test_run_in_a_pool_equals_in_process(tmp_path):
    """`nproc=2` (a Pool forked after torch has run ops on its thread pool in the
    same process) gives what `nproc=0` gives, bit for bit. Both run in a fresh
    interpreter that never imports JAX (`fresh_interpreter.py`: a fork of this
    JAX-loaded process can deadlock its worker)."""
    from fresh_interpreter import run_fresh
    preds, data = _dataset()
    (mean0, items0), (mean2, items2) = run_fresh("""
        from slowtv_monodepth_tpu_torch import eval as teval
        torch.ones(256, 256).matmul(torch.ones(256, 256)).sum().item()
        preds, data, args = INPUTS
        ev = teval.MonoDepthEvaluator(align_mode='lsqr', **args)
        OUTPUT = ev.run(preds, data, nproc=0), ev.run(preds, data, nproc=2)
        """, tmp_path, inputs=(preds, data, SYNS_ARGS))
    assert mean0 == mean2 and items0 == items2
    assert mean0 == teval.MonoDepthEvaluator(align_mode='lsqr', **SYNS_ARGS).run(
        preds, data, nproc=0)[0]


def test_the_item_path_imports_no_torch():
    """`run`'s forked workers must not touch torch: the evaluator, a whole `run` in
    process and the resize leave torch unimported in a fresh interpreter."""
    import subprocess
    import sys
    from pathlib import Path
    code = ('import sys, numpy as np\n'
            'from slowtv_monodepth_tpu_torch.eval import MonoDepthEvaluator\n'
            'rs = np.random.RandomState(0)\n'
            't = (1 + 20 * rs.rand(2, 40, 60)).astype(np.float32)\n'
            'K = np.tile(np.array([[30, 0, 30, 0], [0, 30, 20, 0], [0, 0, 1, 0], [0, 0, 0, 1]],\n'
            '                     np.float32), (2, 1, 1))\n'
            'data = {"depth": t, "K": K, "edge": t > 15}\n'
            'ev = MonoDepthEvaluator(metrics=["eigen", "benchmark", "pointcloud", "ibims"],\n'
            '                        align_mode="lsqr", max=100)\n'
            'ev.run(1 / t[:, ::2, ::2], data, nproc=0)\n'
            'print("TORCH", "torch" in sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == 'TORCH False'
