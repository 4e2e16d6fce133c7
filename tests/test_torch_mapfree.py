"""Port differential: MapFreeReloc and its challenge predictions against the JAX package.

`MapFreeRelocDataset` on a seeded synthetic tree in MapFree's layout (jpg
frames, DPT depth PNGs in millimetres at another size than the dataset's
SHAPE, per-scene intrinsics and quaternion poses): items, poses and
intrinsics BITWISE equal to the JAX class's with `random.seed` set alike
(the randomised support scale draws from Python's `random`), at the native
shape and at the predictor's portrait 512x384 (the depth gathered to
720x540 as `cv2.resize(INTER_NEAREST)` does); `create_split_file` writes the
same bytes.

`mapfree_preds.process_single_pred` on the same (target, pred, file): PNG
pixels bitwise the JAX function's (`cv2.resize` bilinear, `cv2.imwrite`),
read back by PIL and by cv2, also where depths pass 65.535 m and wrap. The
console script end to end against `api/mapfree/generate_preds.py` on the
same seeded weights: every pixel within 1 mm. A write that fails raises; a
mesh is refused (ROADMAP A11).
"""
import random

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from slowtv_monodepth_tpu import parsers as jparsers
from slowtv_monodepth_tpu import paths as jpaths
from slowtv_monodepth_tpu_torch import mapfree_preds, parsers, paths
from fresh_interpreter import run_fresh
from test_torch_eval_api import API, _run_main, _runs
from test_torch_eval_datasets import port_ckpt  # noqa: F401
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

FRAME = (72, 54)   # portrait frames (h, w)
DPT = (60, 45)     # the DPT depth PNGs' size: gathered to the dataset's SHAPE 720x540
N_FRAMES = 8       # per sequence: one scene of two is one batch of 16


def _write_scene(root, rng, mode: str, scene: str) -> list:
    lines, intr, poses = [], [], []
    for seq in ('seq0', 'seq1'):
        d = root / mode / scene / seq
        d.mkdir(parents=True, exist_ok=True)
        for i in range(N_FRAMES):
            stem = f'frame_{i:05}'
            Image.fromarray(rng.integers(0, 255, FRAME + (3,), dtype=np.uint8)).save(
                d / f'{stem}.jpg')
            mm = (1000 * (0.5 + 20 * rng.random(DPT))).astype(np.uint16)
            Image.fromarray(mm).save(d / f'{stem}.dptkitti.png')
            q = rng.standard_normal(4)
            q /= np.linalg.norm(q)
            intr.append(f'{seq}/{stem}.jpg {40 + rng.random():.4f} {40.5 + rng.random():.4f} '
                        f'{27 + rng.random():.4f} {36 + rng.random():.4f} {FRAME[1]} {FRAME[0]}')
            poses.append(f'{seq}/{stem}.jpg ' + ' '.join(f'{v:.6f}' for v in q) + ' '
                         + ' '.join(f'{v:.4f}' for v in rng.uniform(-2, 2, 3)))
            lines.append(f'{scene} {seq} {stem}\n')
    (root / mode / scene / 'intrinsics.txt').write_text('\n'.join(intr) + '\n')
    (root / mode / scene / 'poses.txt').write_text('\n'.join(poses) + '\n')
    return lines


@pytest.fixture
def mapfree_root(tmp_path):
    root = tmp_path / 'mapfree'
    rng = np.random.default_rng(23)
    lines = _write_scene(root, rng, 'val', 's00000')
    train = _write_scene(root, rng, 'train', 's00007')
    (root / 'splits').mkdir(parents=True)
    (root / 'splits' / 'val_files.txt').write_text(''.join(lines))
    (root / 'splits' / 'train_files.txt').write_text(''.join(train))
    for p in (paths, jpaths):
        p.DATA_PATHS['mapfree'] = root
    yield root
    for p in (paths, jpaths):
        p.DATA_PATHS.pop('mapfree', None)


def _items(get_ds, n: int, seed: int, **kw) -> list:
    ds = next(iter(get_ds({'mapfree': {'log_time': False, **kw}}).values()))
    random.seed(seed)
    np.random.seed(seed)
    return [ds[i] for i in range(n)]


def _assert_items_equal(a: list, b: list) -> None:
    for (xa, ya, ma), (xb, yb, mb) in zip(a, b):
        for da, db in ((xa, xb), (ya, yb)):
            assert list(da) == list(db)
            for k in da:
                va, vb = np.asarray(da[k]), np.asarray(db[k])
                assert va.dtype == vb.dtype and va.shape == vb.shape, k
                np.testing.assert_array_equal(va, vb, err_msg=k)
        assert ma == mb


@pytest.mark.parametrize('kw', [
    {'mode': 'val', 'datum': 'image depth pose K'},
    {'mode': 'val', 'datum': 'image depth pose K', 'shape': (512, 384)},
    {'mode': 'val', 'datum': 'image support depth pose K', 'supp_idxs': [-1, 1],
     'randomize_supp': True, 'use_aug': True, 'shape': (512, 384)},
    {'mode': 'train', 'datum': 'image support K', 'supp_idxs': [-1, 1],
     'randomize_supp': True},
], ids=['native', 'predictor_shape', 'random_support', 'train'])
def test_items_are_bitwise_the_jax_dataset(mapfree_root, kw):
    got, want = (_items(g, 2 * N_FRAMES, 5, **kw) for g in (parsers.get_ds, jparsers.get_ds))
    _assert_items_equal(got, want)
    x, y, m = got[3]
    if 'depth' in y:  # gathered to SHAPE once the image is resized, else as stored
        assert y['depth'].shape == ((720, 540, 1) if 'shape' in kw else DPT + (1,))
        assert y['depth'].dtype == np.float32 and (y['depth'] > 0.4).all()
    if 'supp_idxs' in kw and kw['mode'] == 'val':
        assert {m2['supp'] for _, _, m2 in got} != {m['supp']}  # the scales were drawn
    if 'T' in y:
        R = y['T'][:3, :3].astype(np.float64)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_guards_and_split_file(mapfree_root):
    from slowtv_monodepth_tpu.data.devkits import mapfreereloc as jmfr
    from slowtv_monodepth_tpu_torch.data.devkits import mapfreereloc as mfr
    for get_ds, kw in ((g, kw) for g in (parsers.get_ds, jparsers.get_ds)
                       for kw in ({'mode': 'train', 'datum': 'image depth'},
                                  {'mode': 'val', 'datum': 'image support', 'supp_idxs': [0]})):
        with pytest.raises(ValueError):
            get_ds({'mapfree': {'log_time': False, **kw}})
    for mode in ('train', 'val'):
        file = mapfree_root / 'splits' / f'{mode}_files.txt'
        jmfr.create_split_file(mode)
        want = file.read_bytes()
        file.unlink()
        mfr.create_split_file(mode)
        assert file.read_bytes() == want and len(want.splitlines()) == 2 * N_FRAMES


def _jax_process_single_pred():
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location('jax_mapfree_generate_preds',
                                                  API / 'mapfree' / 'generate_preds.py')
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(API / 'mapfree'))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(API / 'mapfree'))
    return mod


@pytest.mark.parametrize('case', ['upsampled', 'same_shape', 'wraps'])
def test_process_single_pred_writes_the_jax_pixels(tmp_path, case):
    """The same (target, pred, file) through both functions: the PNGs decode, by PIL and
    by cv2, to the same uint16 millimetres (`(depth * 1000).astype(np.uint16)`: truncated,
    and wrapped above 65.535 m)."""
    jmod = _jax_process_single_pred()
    rs = np.random.RandomState(7)
    target = (1 + 30 * rs.rand(720, 540)).astype(np.float32)
    target[rs.rand(720, 540) < 0.1] = 0
    shape = (720, 540) if case == 'same_shape' else (512, 384)
    v = np.linspace(0, 1, shape[0])[:, None] + 0.2 * rs.rand(*shape)
    pred = (0.05 + v).astype(np.float32)
    if case == 'wraps':  # far depths: the lsqr fit maps the smallest disparities past 65.5 m
        target = np.where(target > 0, 1 / (0.01 + np.float32(0.9) * (
            np.float32(1) - cv2.resize(pred, (540, 720), interpolation=cv2.INTER_LINEAR))), 0
        ).astype(np.float32)
    files = {}
    for name, fn in (('port', mapfree_preds.process_single_pred),
                     ('jax', jmod.process_single_pred)):
        files[name] = tmp_path / f'frame_00000.{name}.png'
        fn((target, pred, files[name]))
    for read in (lambda f: np.array(Image.open(f)),
                 lambda f: cv2.imread(str(f), cv2.IMREAD_UNCHANGED)):
        got, want = read(files['port']), read(files['jax'])
        assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape == (720, 540)
        np.testing.assert_array_equal(got, want)
    if case == 'wraps':
        depth = jmod.align(jmod.upsample(pred, target), target)
        assert (depth > 65.535).any() and (got > 0).any()


def test_script_matches_the_jax_script(mapfree_root, tmp_path):
    """`slowtv-mapfree-preds-torch --device cpu` and `api/mapfree/generate_preds.py` on
    the same seeded weights write PNGs within 1 mm of each other, at the dataset's SHAPE."""
    port_ckpt, jax_ckpt = _runs(tmp_path)
    argv = ['--mode', 'val', '--depth-src', 'dptkitti']
    with pytest.raises(SystemExit):  # the run has not finished
        _run_main(mapfree_preds.main, ['--ckpt', port_ckpt, '--name', 'ours', '--device', 'cpu']
                  + argv)
    (port_ckpt.parent / 'finished').touch()
    # Both scripts write through a forked Pool: each in a fresh interpreter
    # (`fresh_interpreter.py`), the port's without JAX.
    env = {'SLOWTV_DATA_ROOTS': str(mapfree_root.parent)}
    run_fresh("""
        from slowtv_monodepth_tpu_torch import mapfree_preds
        sys.argv = ['slowtv-mapfree-preds-torch'] + INPUTS
        mapfree_preds.main()
        """, tmp_path / 'fresh_port', env=env,
              inputs=[str(a) for a in ['--ckpt', port_ckpt, '--name', 'ours', '--device', 'cpu']
                      + argv])
    run_fresh("""
        import runpy
        script = INPUTS[0]
        sys.argv = INPUTS
        sys.path.insert(0, str(__import__('pathlib').Path(script).parent))
        runpy.run_path(script, run_name='__main__')
        """, tmp_path / 'fresh_jax', env=env, jax_free=False,
              inputs=[str(a) for a in [API / 'mapfree' / 'generate_preds.py', '--ckpt', jax_ckpt,
                                       '--name', 'jax'] + argv])
    files = sorted(mapfree_root.glob('val/*/*/*.ours.png'))
    assert len(files) == 2 * N_FRAMES
    worst = 0
    for f in files:
        got = np.array(Image.open(f)).astype(np.int64)
        want = np.array(Image.open(str(f).replace('.ours.', '.jax.'))).astype(np.int64)
        assert got.shape == want.shape == (720, 540) and (got > 0).any()
        worst = max(worst, int(np.abs(got - want).max()))
    assert worst <= 1


def test_chip_smoke_mapfree_stand_in_matches_the_dataset(mapfree_root):
    """`chip_smoke.MapFreeStandIn` yields what `mapfree_preds` builds from its cfg: one
    batch of `BATCH_SIZE` with the same keys in order, dtypes and shapes (the frames
    at the predictor's 512x384, the DPT targets at the dataset's 720x540), and the
    metadata that names each PNG."""
    import chip_smoke
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor
    from slowtv_monodepth_tpu_torch.data import DataLoader
    from slowtv_monodepth_tpu_torch.export_preds import make_dataset
    from test_torch_eval_api import _layout
    cfg = {'type': 'mapfree', 'mode': 'val', 'depth_src': 'dptkitti', 'datum': 'image depth'}
    real = make_dataset(cfg, BenchmarkPredictor('cpu'))
    scenes = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    stand_in = chip_smoke.MapFreeStandIn(scenes)
    assert len(stand_in) == len(real) == mapfree_preds.BATCH_SIZE
    stand_in.fit_targets(np.random.RandomState(0).rand(len(stand_in), stand_in.h, stand_in.w)
                         .astype(np.float32))
    batches = [next(iter(DataLoader(ds, batch_size=mapfree_preds.BATCH_SIZE, num_workers=0,
                                    drop_last=False))) for ds in (stand_in, real)]
    got, want = (_layout(b) for b in batches)
    assert got == want, (got, want)
    assert np.asarray(batches[0][1]['depth']).shape[1:3] == chip_smoke.MapFreeStandIn.SHAPE
    assert all(np.asarray(batches[0][1]['depth']).min(axis=(1, 2, 3)) >= 1 - 1e-5)


def test_a_failed_write_raises(mapfree_root, port_ckpt, tmp_path):  # noqa: F811
    """The JAX script drops a failed item without a word; the port raises. The
    writes fork a Pool: in a fresh interpreter without JAX (`fresh_interpreter.py`)."""
    cfg = {'type': 'mapfree', 'mode': 'val', 'depth_src': 'dptkitti', 'datum': 'image depth'}
    raised = run_fresh("""
        from slowtv_monodepth_tpu_torch import mapfree_preds
        try:  # the PNG's directory is missing
            mapfree_preds.compute_preds('no_such_dir/ours', *INPUTS, device='cpu', num_workers=0)
        except FileNotFoundError as e:
            OUTPUT = str(e)
        """, tmp_path / 'fresh', inputs=(cfg, str(port_ckpt)),
        env={'SLOWTV_DATA_ROOTS': str(mapfree_root.parent)})
    assert raised and 'no_such_dir' in raised
    with pytest.raises(NotImplementedError, match='ROADMAP queue A item 11'):
        mapfree_preds.compute_preds('ours', cfg, str(port_ckpt), devices=2)
    if not torch.cuda.is_available():  # `--device` defaults to the card
        with pytest.raises(RuntimeError, match='--device cpu'):
            _run_main(mapfree_preds.main, ['--ckpt', port_ckpt, '--name', 'ours'])
