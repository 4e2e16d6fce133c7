"""Port differential: the zero-shot evaluation datasets against the JAX package.

DDAD, DIODE (indoors and outdoor), NYUD-v2, Sintel and TUM-RGBD on seeded
synthetic trees in each dataset's on-disk layout, written once for both
packages: items (x, y, m) BITWISE equal to the JAX classes' at the native
shape and at the predictor's shape, for the eval cfgs' datum and for every
datum each class accepts; the guards raise alike; Sintel's and TUM's
`create_splits` write byte-identical split files; a wrong Sintel tag asserts on
both sides; `project_ddad_lidar` writes the JAX script's depth maps bitwise.

Then every new cfg of `cfg/eval/` through the port's console scripts
(`slowtv-export-gt-torch` -> `slowtv-export-preds-torch --device cpu` ->
`slowtv-eval-depth-torch`), with DDAD's and Sintel's targets bitwise the JAX
`export_gt` script's (the JAX script cannot export the datasets without K);
the predictor at the new input shapes (416x640, 480x640, 288x640: stage-4
maps of 13, 15 and 9 rows) against the JAX predictor's jitted forward (atol
1e-5, as `tests/test_torch_predictors.py`); and `chip_smoke.EvalStandIn`'s
layouts of the new sets against the real datasets'.
"""
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu import paths as jpaths
from slowtv_monodepth_tpu_torch import export_gt, parsers, paths
from test_torch_eval_api import API, _run_main, _run_script
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_if_passed, drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EVAL_CFGS = ROOT / 'cfg' / 'eval'
TAG = 202021.25
SIZES = {'ddad': (40, 64), 'diode': (48, 64), 'nyud': (480, 640), 'sintel': (44, 100),
         'tum': (48, 64)}
PRED_SHAPES = {'ddad': (416, 640), 'diode': (480, 640), 'nyud': (480, 640),
               'sintel': (288, 640), 'tum': (480, 640)}
DIRS = {'ddad': 'DDAD', 'diode': 'Diode', 'nyud': 'NYUD_v2', 'sintel': 'Sintel',
        'tum': 'TUM_RGBD'}
ATOL = 1e-5


def _img(path: Path, shape, rng) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 255, shape + (3,), dtype=np.uint8)).save(path)


def _depth(shape, rng, valid=0.9) -> np.ndarray:
    d = (1 + 40 * rng.random(shape)).astype(np.float32)
    d[rng.random(shape) >= valid] = 0
    return d


def _quat(rng) -> dict:
    """A small rotation (w, x, y, z): most points stay in front of the camera."""
    q = np.array([1, *(0.1 * rng.standard_normal(3))])
    q /= np.linalg.norm(q)
    return dict(zip(('qw', 'qx', 'qy', 'qz'), map(float, q)))


def write_ddad(root: Path, rng, n: int = 3) -> None:
    """A DGP scene: camera_01 (and a camera_05 to skip) frames, LiDAR point clouds
    (structured X/Y/Z arrays) and poses; `ddad.json` with DGP's `scene_splits`."""
    h, w = SIZES['ddad']
    scene_dir = root / 'ddad_train_val' / '000150'
    samples = []
    for i in range(n):
        ts = f'1561645824993{i:04d}'
        img = {'filename': f'rgb/CAMERA_01/{ts}.png', 'height': h, 'width': w,
               'intrinsics': {'fx': 31.5 + i, 'fy': 30.25, 'cx': w / 2 - 0.5, 'cy': h / 2 + 0.25},
               'pose': {'rotation': {'qw': 1.0, 'qx': 0.0, 'qy': 0.0, 'qz': 0.0},
                        'translation': {'x': 0.1 * i, 'y': -0.2, 'z': 1.5}}}
        _img(scene_dir / img['filename'], (h, w), rng)
        pts = np.zeros(4000, dtype=[('X', 'f4'), ('Y', 'f4'), ('Z', 'f4'), ('INTENSITY', 'f4')])
        pts['X'], pts['Y'] = rng.uniform(-8, 8, 4000), rng.uniform(-4, 4, 4000)
        pts['Z'] = rng.uniform(-2, 40, 4000)
        pc = {'filename': f'point_cloud/LIDAR/{ts}.npz',
              'pose': {'rotation': _quat(rng) if i == 2 else
                       {'qw': 1.0, 'qx': 0.0, 'qy': 0.0, 'qz': 0.0},
                       'translation': {'x': 0.1 * i, 'y': -0.2, 'z': 1.2}}}
        (scene_dir / 'point_cloud' / 'LIDAR').mkdir(parents=True, exist_ok=True)
        np.savez(scene_dir / pc['filename'], data=pts)
        samples.append({'datum': {'image': img, 'point_cloud': pc}})
        samples.append({'datum': {'image': dict(img, filename=f'rgb/CAMERA_05/{ts}.png')}})
    (scene_dir / 'scene_a1b2.json').write_text(json.dumps({'data': samples}))
    (root / 'ddad_train_val' / 'ddad.json').write_text(json.dumps(
        {'scene_splits': {'0': {'filenames': []},
                          '1': {'filenames': ['000150/scene_a1b2.json']}}}))


def write_diode(root: Path, rng, n: int = 2) -> None:
    h, w = SIZES['diode']
    for split in ('indoors', 'outdoor'):
        lines = []
        for i in range(n):
            scan = root / 'val' / split / f'scene_{i:05}' / f'scan_{10 + i:05}'
            stem = f'{i:05}_{10 + i:05}_{split}_000_010'
            _img(scan / f'{stem}.png', (h, w), rng)
            depth = _depth((h, w), rng)
            np.save(scan / f'{stem}_depth.npy', depth[..., None])
            np.save(scan / f'{stem}_depth_mask.npy', (depth > 0).astype(np.float32))
            rel = f'./val/{split}/scene_{i:05}/scan_{10 + i:05}/{stem}'
            lines.append(f'{rel}.png,{rel}_depth.npy,{rel}_depth_mask.npy\n')
        (root / 'data_list').mkdir(parents=True, exist_ok=True)
        (root / 'data_list' / f'val_{split}.csv').write_text(''.join(lines))


def write_nyud(root: Path, rng, n: int = 2) -> None:
    h, w = SIZES['nyud']
    for i in range(n):
        _img(root / 'test' / 'rgb' / f'{i:05}.png', (h, w), rng)
        (root / 'test' / 'depth').mkdir(parents=True, exist_ok=True)
        np.save(root / 'test' / 'depth' / f'{i:05}.npy', _depth((h, w), rng, valid=1))
    (root / 'splits').mkdir(parents=True)
    (root / 'splits' / 'test_files.txt').write_text(''.join(f'{i:05}\n' for i in range(n)))


def write_dpt(path: Path, depth: np.ndarray, tag: float = TAG) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w = depth.shape
    path.write_bytes(struct.pack('<fii', tag, w, h) + depth.astype('<f4').tobytes())


def write_cam(path: Path, K3: np.ndarray, tag: float = TAG) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(struct.pack('<f', tag) + K3.astype('<f8').tobytes()
                     + np.zeros(12, '<f8').tobytes())


def write_sintel(root: Path, rng) -> None:
    """Two sequences of .png frames, .dpt depth and .cam intrinsics (no split file:
    `create_splits` writes it)."""
    h, w = SIZES['sintel']
    for seq, n in (('alley_1', 2), ('bamboo_2', 1)):
        for i in range(1, n + 1):
            stem = f'frame_{i:04}'
            _img(root / 'train' / 'final' / seq / f'{stem}.png', (h, w), rng)
            write_dpt(root / 'train' / 'depth' / seq / f'{stem}.dpt', _depth((h, w), rng, 1))
            K3 = np.array([[45.0 + i + rng.random() / 3, 0, w / 2 - 0.3],
                           [0, 44.1 + rng.random() / 7, h / 2 + 0.7], [0, 0, 1]])
            write_cam(root / 'train' / 'camdata_left' / seq / f'{stem}.cam', K3)


def write_tum(root: Path, rng) -> None:
    """Two sequences (a freiburg2 one is decimated x3) with rgb/depth timestamp lists
    a few ms apart, and a stray `splits` dir; uint16 depth PNGs at 5000 per metre."""
    h, w = SIZES['tum']
    for seq, n in (('rgbd_dataset_freiburg2_xyz', 7), ('rgbd_dataset_freiburg3_office', 3)):
        d = root / seq
        rgb, dep = ['# color images', '# timestamp filename'], ['# depth maps']
        for i in range(n):
            t_rgb, t_dep = 1311868164.0 + 0.1 * i, 1311868164.0 + 0.1 * i + 0.004 * (i % 3)
            rgb.append(f'{t_rgb:.6f} rgb/{t_rgb:.6f}.png')
            dep.append(f'{t_dep:.6f} depth/{t_dep:.6f}.png')
            _img(d / 'rgb' / f'{t_rgb:.6f}.png', (h, w), rng)
            (d / 'depth').mkdir(parents=True, exist_ok=True)
            Image.fromarray((_depth((h, w), rng, 0.8) * 5000 / 8).astype(np.uint16)).save(
                d / 'depth' / f'{t_dep:.6f}.png')
        (d / 'rgb.txt').write_text('\n'.join(rgb) + '\n')
        (d / 'depth.txt').write_text('\n'.join(dep) + '\n')
    (root / 'splits').mkdir(parents=True, exist_ok=True)


def point(key: str, root: Path) -> None:
    for p in (paths, jpaths):
        p.DATA_PATHS[key] = root


def unpoint(*keys) -> None:
    for p in (paths, jpaths):
        for k in keys:
            p.DATA_PATHS.pop(k, None)


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    """Every zero-shot dataset's tree, pointed to by both packages; Sintel's and TUM's
    split files written by the JAX `create_splits`, DDAD's depth by the JAX projection."""
    from slowtv_monodepth_tpu.data.devkits import sintel as jsi
    from slowtv_monodepth_tpu.data.devkits import tum as jtu
    base = tmp_path_factory.mktemp('zero_shot')
    rng = np.random.default_rng(19)
    out = {}
    for key, write in (('ddad', write_ddad), ('diode', write_diode), ('nyud', write_nyud),
                       ('sintel', write_sintel), ('tum', write_tum)):
        out[key] = base / DIRS[key]
        write(out[key], rng)
        point(key, out[key])
    jsi.create_splits()
    jtu.create_splits()
    _run_script(API / 'data' / 'preprocess' / 'project_ddad_lidar.py', ['--mode', 'val'])
    yield out
    unpoint(*out)


def _ds(get_ds, key: str, **kw):
    return next(iter(get_ds({key: {'use_aug': False, 'log_time': False, **kw}}).values()))


def _assert_items_equal(a, b) -> None:
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        (xa, ya, ma), (xb, yb, mb) = a[i], b[i]
        for da, db in ((xa, xb), (ya, yb)):
            assert list(da) == list(db)
            for k in da:
                va, vb = np.asarray(da[k]), np.asarray(db[k])
                assert va.dtype == vb.dtype and va.shape == vb.shape, k
                np.testing.assert_array_equal(va, vb, err_msg=k)
        assert ma == mb


# key, dataset kwargs, datums: the eval cfg's, then every datum the class accepts
CASES = [('ddad', {'mode': 'val'}, ('image', 'image depth K')),
         ('diode', {'mode': 'val', 'scene': 'indoors'}, ('image', 'image depth mask')),
         ('diode', {'mode': 'val', 'scene': 'outdoor'}, ('image', 'image depth mask')),
         ('nyud', {'mode': 'test'}, ('image', 'image depth')),
         ('sintel', {'mode': 'train'}, ('image', 'image depth K')),
         ('tum', {'mode': 'test'}, ('image', 'image depth'))]


@pytest.mark.parametrize('key,kw,datums', CASES,
                         ids=[f'{c[0]}-{c[1].get("scene", c[1]["mode"])}' for c in CASES])
@pytest.mark.parametrize('resize', [False, True], ids=['native', 'predictor_shape'])
def test_items_are_bitwise_the_jax_datasets(roots, key, kw, datums, resize):
    shape = PRED_SHAPES[key] if resize else None
    for datum in datums:
        got, want = (_ds(g, key, datum=datum, shape=shape, **kw)
                     for g in (parsers.get_ds, jparsers.get_ds))
        assert len(got) == len(want) and got.split_file == want.split_file
        _assert_items_equal(got, want)
        x, y, _ = got[0]
        assert x['imgs'].shape[:2] == (shape or SIZES[key]), datum
        if 'K' in y and resize:  # K follows the image, scaled from the class's SHAPE
            K = (want.items_data[0].load_K() if key == 'ddad'
                 else want.items_data[0].load_intrinsics())
            np.testing.assert_array_equal(y['K'][0], K[0] * (shape[1] / got.SHAPE[1]))
            np.testing.assert_array_equal(y['K'][1], K[1] * (shape[0] / got.SHAPE[0]))


def test_tum_depth_is_png_over_5000(roots):
    """The Kinect PNG's counts / 5000 in float32 metres (a `/ 1000` is 5x off)."""
    ds = _ds(parsers.get_ds, 'tum', mode='test', datum='image depth')
    item = ds.items_data[0]
    raw = np.array(Image.open(item.get_depth_file()))
    assert raw.dtype == np.uint16 and raw.max() > 0
    np.testing.assert_array_equal(ds[0][1]['depth'][..., 0],
                                  raw.astype(np.float32) / np.float32(5000))


@pytest.mark.parametrize('key,kw,bad', [
    ('ddad', {'mode': 'val'}, {'use_aug': True}),
    ('ddad', {'mode': 'val'}, {'supp_idxs': [1]}),
    ('ddad', {'mode': 'val'}, {'randomize_supp': True}),
    ('ddad', {'mode': 'train'}, {}),
    ('nyud', {'mode': 'test'}, {'datum': 'image K'}),
    ('diode', {'mode': 'val', 'scene': 'indoors'}, {'use_aug': True}),
    ('sintel', {'mode': 'train'}, {'supp_idxs': [-1, 1]}),
    ('tum', {'mode': 'test'}, {'randomize_supp': True}),
])
def test_guards_raise_alike(roots, key, kw, bad):
    errors = []
    for get_ds in (parsers.get_ds, jparsers.get_ds):
        with pytest.raises(Exception) as e:
            _ds(get_ds, key, **{**kw, **bad})
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_missing_projected_depth_raises_alike(roots, tmp_path):
    got, want = (_ds(g, 'ddad', mode='val', datum='image depth')
                 for g in (parsers.get_ds, jparsers.get_ds))
    f = got.items_data[0].depth_file
    shutil.move(f, tmp_path / f.name)
    try:
        errors = []
        for ds in (got, want):
            with pytest.raises(FileNotFoundError, match='Missing projected LiDAR depth') as e:
                ds.items_data[0].load_depth()
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    finally:
        shutil.move(tmp_path / f.name, f)


@pytest.mark.parametrize('key,kw', [('sintel', {}), ('tum', {}), ('tum', {'max': 4})],
                         ids=['sintel', 'tum', 'tum-max4'])
def test_split_files_are_byte_identical(roots, key, kw):
    """`create_splits` of both packages; TUM's: freiburg2 every third match, both
    sequences, `random.Random(42)`'s shuffle, its first `max` sorted."""
    import importlib
    port, jax_mod = (importlib.import_module(f'{pkg}.data.devkits.{key}')
                     for pkg in ('slowtv_monodepth_tpu_torch', 'slowtv_monodepth_tpu'))
    file = roots[key] / 'splits' / ('train_files.txt' if key == 'sintel' else 'test_files.txt')
    try:
        jax_mod.create_splits(**kw)
        want = file.read_bytes()
        file.unlink()
        port.create_splits(**kw)
        assert file.read_bytes() == want
    finally:
        jax_mod.create_splits()
    lines = want.decode().splitlines()
    if key == 'sintel':
        assert lines == ['alley_1 frame_0001', 'alley_1 frame_0002', 'bamboo_2 frame_0001']
    elif kw:
        assert len(lines) == 4
    else:
        assert sum('freiburg2' in ln for ln in lines) == 3 == sum('freiburg3' in ln for ln in lines)


@pytest.mark.parametrize('kind', ['dpt', 'cam'])
def test_wrong_sintel_tag_asserts_on_both_sides(roots, tmp_path, kind):
    from slowtv_monodepth_tpu.data.devkits import sintel as jsi
    from slowtv_monodepth_tpu_torch.data.devkits import sintel as si
    root = tmp_path / 'Sintel'
    seq, stem = 'cave_4', 'frame_0001'
    write_dpt(root / 'train' / 'depth' / seq / f'{stem}.dpt', np.ones((3, 4), np.float32),
              tag=TAG + (kind == 'dpt'))
    write_cam(root / 'train' / 'camdata_left' / seq / f'{stem}.cam', np.eye(3),
              tag=TAG + (kind == 'cam'))
    point('sintel', root)
    try:
        for mod in (si, jsi):
            item = mod.Item('train', seq, stem)
            load, file = ((item.load_depth, 'depth') if kind == 'dpt'
                          else (item.load_intrinsics, 'cam'))
            with pytest.raises(AssertionError, match=f'Wrong tag in {file} file'):
                load()
    finally:
        point('sintel', roots['sintel'])


def test_ddad_projection_is_bitwise_the_jax_script(roots):
    from slowtv_monodepth_tpu_torch import project_ddad_lidar
    files = sorted((roots['ddad'] / 'ddad_train_val' / '000150' / 'depth_01').glob('*.npz'))
    assert len(files) == 3  # the camera_01 frames only
    want = {f.name: np.load(f)['depth'] for f in files}
    _run_main(project_ddad_lidar.main, ['--mode', 'val'])  # existing files are kept
    assert {f.name: np.load(f)['depth'].tobytes() for f in files} == \
        {k: v.tobytes() for k, v in want.items()}
    for f in files:
        f.unlink()
    _run_main(project_ddad_lidar.main, ['--mode', 'val'])
    for f in files:
        got = np.load(f)['depth']
        assert got.dtype == want[f.name].dtype == np.float32 and (got > 0).sum() > 20
        np.testing.assert_array_equal(got, want[f.name])


@pytest.fixture(scope='module')
def port_ckpt(request, tmp_path_factory):
    """A finished run's `last.ckpt`: seeded ConvNeXt-atto depth weights."""
    import torch

    from slowtv_monodepth_tpu_torch.core import save_checkpoint
    from slowtv_monodepth_tpu_torch.models import DepthNet, seeded_state_dict
    from test_torch_models import depth_cfg
    cfg = {'net': {'depth': depth_cfg(pretrained=False)},
           'trainer': {'min_depth': 0.1, 'max_depth': 100}}
    sd = seeded_state_dict(DepthNet(**cfg['net']['depth']), 21)
    path = tmp_path_factory.mktemp('run') / 'models' / 'last.ckpt'
    save_checkpoint(path, {'depth': {k: torch.from_numpy(v) for k, v in sd.items()}}, cfg)
    (path.parent / 'finished').touch()
    failed = request.session.testsfailed
    yield path
    drop_if_passed(request, failed, path.parents[1])


# cfg -> (dataset key, export_gt datum, export_gt kwargs)
CHAIN = {'ddad': ('ddad', 'image depth K', {}),
         'diode_indoors': ('diode', 'image depth mask', {'scene': 'indoors'}),
         'diode_outdoor': ('diode', 'image depth mask', {'scene': 'outdoor'}),
         'nyud': ('nyud', 'image depth', {}),
         'sintel': ('sintel', 'image depth K', {}),
         'tum': ('tum', 'image depth', {})}


@pytest.mark.parametrize('cfg_name', list(CHAIN))
def test_eval_cfg_runs_through_the_port_chain(roots, port_ckpt, tmp_path, cfg_name):
    """`slowtv-export-gt-torch` -> `slowtv-export-preds-torch` -> `slowtv-eval-depth-torch`
    on the cfg as it stands; DDAD's and Sintel's targets bitwise the JAX script's."""
    from slowtv_monodepth_tpu_torch import eval_depth, export_preds
    key, datum, kw = CHAIN[cfg_name]
    cfg_file = EVAL_CFGS / f'{cfg_name}.yaml'
    cfg = yaml.safe_load(cfg_file.read_text())
    mode, stem = cfg['dataset']['mode'], cfg['dataset']['target_stem']
    argv = (['--type', key, '--mode', mode, '--datum', datum]
            + [a for k, v in kw.items() for a in ('--kw', f'{k}={v}')])
    jax_argv = argv + ['--save-stem', 'jax', '--overwrite', 1]
    _run_main(export_gt.main, argv + ['--save-stem', stem, '--overwrite', 1])
    ds = _ds(jparsers.get_ds, key, mode=mode, datum=datum, **kw)
    target_file = ds.split_file.parent / f'{stem}.npz'
    got = dict(np.load(target_file, allow_pickle=True))
    assert set(got) == ({'depth', 'K'} if 'K' in datum else {'depth'})
    assert got['depth'].shape == (len(ds),) + SIZES[key]
    if 'K' in datum:
        _run_script(API / 'data' / 'export_gt' / 'from_dataset.py', jax_argv)
        want = dict(np.load(target_file.parent / 'jax.npz', allow_pickle=True))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    else:  # the JAX script reads every item's K; these datasets have none
        with pytest.raises(KeyError, match='K'):
            _run_script(API / 'data' / 'export_gt' / 'from_dataset.py', jax_argv)
        for i in range(len(ds)):
            y = ds[i][1]
            want = np.where(y['mask'][..., 0], y['depth'][..., 0], 0) if 'mask' in y \
                else y['depth'][..., 0]
            np.testing.assert_array_equal(got['depth'][i], want)

    pred_file, res_file = tmp_path / 'preds.npz', tmp_path / 'results.yaml'
    _run_main(export_preds.main, ['--cfg-file', cfg_file, '--ckpt', port_ckpt,
                                  '--save-file', pred_file, '--device', 'cpu'])
    preds = np.load(pred_file)['pred']
    assert preds.shape == (len(ds),) + PRED_SHAPES[key] and np.isfinite(preds).all()
    _run_main(eval_depth.main, ['--cfg-file', cfg_file, '--pred-file', pred_file,
                                '--save-file', res_file, '--nproc', 0])
    metrics = yaml.safe_load(res_file.read_text())
    assert np.isfinite(metrics['AbsRel']) and ('F-Score (10)' in metrics) == ('K' in datum)


@pytest.fixture(scope='module')
def jax_pair():
    from slowtv_monodepth_tpu.core.predictors import arg_jitted_forward
    from slowtv_monodepth_tpu.models import DepthNet as JaxDepthNet
    from test_torch_models import depth_cfg, seeded_pair
    cfg = depth_cfg()
    net, params = seeded_pair(cfg, seed=19)
    return net, arg_jitted_forward(JaxDepthNet(**cfg, pretrained=False), {'params': params})


@pytest.mark.parametrize('key', ['ddad', 'diode', 'sintel', 'mapfree'])
def test_predictor_matches_jax_at_the_new_shapes(jax_pair, key):
    """One standardized image at the dataset's input shape through both predictors:
    the odd stage-4 heights go through the decoder's reflect padding and nearest
    upsampling; MapFree's is portrait."""
    from slowtv_monodepth_tpu.core.predictors import BenchmarkPredictor as JaxPredictor
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor
    from test_torch_predictors import _Loader
    net, fwd = jax_pair
    h, w = BenchmarkPredictor.get_img_shape(key)
    assert (h, w) == JaxPredictor.get_img_shape(key) == {**PRED_SHAPES, 'mapfree': (512, 384)}[key]
    assert (h // 32) % 2 == (key != 'mapfree')  # 13, 15, 9; MapFree 16x12
    imgs = np.random.RandomState(h).standard_normal((1, h, w, 3)).astype(np.float32)
    port, jax_pred = BenchmarkPredictor('cpu'), JaxPredictor()
    for p in (port, jax_pred):
        p.min_depth, p.max_depth = 0.1, 100
    got, want = port(net, _Loader(imgs, 1)), jax_pred(fwd, _Loader(imgs, 1))
    assert got.shape == want.shape == (1, h, w)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_chip_smoke_zero_shot_stand_ins_match_the_datasets(roots, tmp_path):
    """`chip_smoke.EvalStandIn` of each zero-shot set yields what
    `export_preds.make_dataset` builds for its cfgs (keys in order, dtypes, shapes at
    the predictor's shape), and its targets have the layout `export_gt` writes."""
    import chip_smoke
    from slowtv_monodepth_tpu_torch.config import load_yaml
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor
    from slowtv_monodepth_tpu_torch.data import DataLoader
    from slowtv_monodepth_tpu_torch.export_preds import make_dataset
    from test_torch_eval_api import _layout, _target_layout
    scenes = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    assert set(chip_smoke.ZERO_SHOT_SETS) == set(DIRS)
    for name in chip_smoke.ZERO_SHOT_SETS:
        for cfg_name in chip_smoke.EVAL_SETS[name][1]:
            cfg = load_yaml(EVAL_CFGS / f'{cfg_name}.yaml')
            assert cfg['args'] == chip_smoke.EVAL_ARGS[cfg_name]
            real = make_dataset(cfg['dataset'], BenchmarkPredictor('cpu'))
            stand_in = chip_smoke.EvalStandIn(scenes, name, n=len(real))
            assert (real.h, real.w) == (stand_in.h, stand_in.w)
            got, want = (_layout(next(iter(DataLoader(ds, batch_size=12, num_workers=0,
                                                      drop_last=False))))
                         for ds in (stand_in, real))
            assert got == want, (name, got, want)
            key, datum, kw = CHAIN[cfg_name]
            targets = dict(np.load(export_gt.export(
                key, cfg['dataset']['mode'], datum, 'layout', overwrite=True, **kw),
                allow_pickle=True))
            assert _target_layout(stand_in.targets[cfg_name]) == _target_layout(targets), cfg_name
