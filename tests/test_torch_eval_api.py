"""Port differential: the evaluation chain's entry points against the JAX scripts.

`export_gt` -> `export_preds` (the `finished` guard refused, then accepted)
-> `eval_depth` -> `generate_tables`, each through its `main` as the console
scripts run it (`--device cpu`), on the SYNS-Patches fixture of
`tests/test_eval_api.py`, beside `api/data/export_gt/from_dataset.py`,
`api/eval/export_preds.py`, `eval_depth.py` and `generate_tables.py` run as
scripts on the same seeded ConvNeXt-atto weights (both weight bridges).
KITTI's target export (raw velodyne for Eigen, benchmark depth otherwise)
against `api/data/export_gt/kitti.py` on a synthetic drive. And
`chip_smoke.py`'s evaluation stand-ins against the datasets they stand in
for: the same batch layouts at the predictor's shapes, the same target
layouts as `export_gt` writes.

Tolerances: targets bitwise; predictions atol 1e-5; the results YAMLs of
both `eval_depth`s on the port's predictions as `test_torch_eval.py` holds
metrics (continuous rtol 1e-5, thresholded within one flipped pixel of the
smallest item: 100 / (2 * N_min)); the tables' text equal.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from slowtv_monodepth_tpu import paths as jpaths
from slowtv_monodepth_tpu_torch import export_gt, paths
from slowtv_monodepth_tpu_torch.core import save_checkpoint
from test_torch_eval import assert_metrics_close
from test_torch_models import depth_cfg, seeded_pair
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
API = ROOT / 'api'
EVAL_CFG = ROOT / 'cfg' / 'eval' / 'syns_test.yaml'
ATOL = 1e-5
SRC = (48, 64)


def _write_img(path: Path, shape, seed: int, ext: str = '.png') -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    rgb = np.random.default_rng(seed).integers(0, 255, shape + (3,), dtype=np.uint8)
    Image.fromarray(rgb).save(path.with_suffix(ext))


def _point(root: Path, key: str):
    for p in (paths, jpaths):
        p.DATA_PATHS[key] = root


@pytest.fixture
def syns_root(tmp_path):
    """`tests/test_eval_api.py:syns_root`, for both packages."""
    root = tmp_path / 'syns_patches'
    scene = '01'
    for i, stem in enumerate(('00.png', '01.png')):
        _write_img(root / scene / 'images' / stem, SRC, seed=1 + i)
        (root / scene / 'depths').mkdir(parents=True, exist_ok=True)
        np.save(root / scene / 'depths' / stem.replace('.png', '.npy'),
                1 + 20 * np.random.default_rng(i).random(SRC).astype(np.float32))
        edges = np.zeros(SRC, np.uint8)
        edges[20] = 255
        (root / scene / 'edges').mkdir(parents=True, exist_ok=True)
        Image.fromarray(edges).save(root / scene / 'edges' / stem)
    (root / scene / 'info.txt').write_text('Scene 01\nScene Category: Outdoor: Park\n')
    (root / 'splits').mkdir(parents=True)
    (root / 'splits' / 'test_files.txt').write_text(f'{scene} 00.png\n{scene} 01.png\n')
    _point(root, 'syns_patches')
    yield root
    for p in (paths, jpaths):
        p.DATA_PATHS.pop('syns_patches', None)


KITTI_DRIVES = {'2011_09_26/2011_09_26_drive_0001_sync': (48, 160),  # the drives' sizes differ
                '2011_09_28/2011_09_28_drive_0002_sync': (46, 156)}


@pytest.fixture
def kitti_root(tmp_path):
    """Two KITTI raw drives: calibration, left images, velodyne scans and benchmark
    depth for the Eigen and Eigen-benchmark test splits."""
    root = tmp_path / 'kitti_raw_sync'
    rng = np.random.default_rng(5)
    lines = []
    for seq, (h, w) in KITTI_DRIVES.items():
        f, cx, cy = 60.0, w / 2, h / 2
        calib = root / seq.split('/')[0]
        calib.mkdir(parents=True)
        cam = ''.join(f'K_0{c}: {f} 0 {cx} 0 {f} {cy} 0 0 1\nS_rect_0{c}: {w} {h}\n'
                      f'P_rect_0{c}: {f} 0 {cx} {0.1 * (c - 2)} 0 {f} {cy} 0 0 0 1 0\n'
                      for c in (2, 3))
        (calib / 'calib_cam_to_cam.txt').write_text(
            'calib_time: 0\nR_rect_00: 1 0 0 0 1 0 0 0 1\n' + cam)
        (calib / 'calib_velo_to_cam.txt').write_text(
            'calib_time: 0\nR: 0 -1 0 0 0 -1 1 0 0\nT: 0 -0.08 -0.27\n')
        (calib / 'calib_imu_to_velo.txt').write_text(
            'calib_time: 0\nR: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n')
        for stem in range(2):
            _write_img(root / seq / 'image_02' / 'data' / f'{stem:010d}', (h, w), stem)
            pts = np.stack([rng.uniform(2, 60, 3000), rng.uniform(-20, 20, 3000),
                            rng.uniform(-2, 1, 3000), np.ones(3000)], 1).astype(np.float32)
            file = root / seq / 'velodyne_points' / 'data' / f'{stem:010d}.bin'
            file.parent.mkdir(parents=True, exist_ok=True)
            pts.tofile(file)
            depth = np.where(rng.random((h, w)) < 0.2, rng.uniform(1, 80, (h, w)), 0)
            file = (root / 'depth_benchmark' / seq / 'proj_depth' / 'groundtruth' / 'image_02'
                    / f'{stem:010d}.png')
            file.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray((depth * 256).astype(np.uint16)).save(file)
            lines.append(f'{seq} {stem} l\n')
    for split in ('eigen', 'eigen_benchmark'):
        (root / 'splits' / split).mkdir(parents=True)
        (root / 'splits' / split / 'test_files.txt').write_text(''.join(lines))
    _point(root, 'kitti_raw')
    yield root
    for p in (paths, jpaths):
        p.DATA_PATHS.pop('kitti_raw', None)


@pytest.fixture
def mc_root(tmp_path):
    """A MannequinChallenge test sequence: frames, depth and calibration."""
    root = tmp_path / 'MannequinChallenge'
    seq, (h, w) = 'seqC', (72, 128)
    lines = ['3 0']
    for stem in range(3):
        _write_img(root / 'test' / seq / f'{stem:05}', (h, w), 20 + stem, ext='.jpg')
        np.save(root / 'test' / seq / f'{stem:05}.npy',
                (1 + 9 * np.random.default_rng(stem).random((h, w))).astype(np.float32))
        lines += [f'0 {h - 1} 0 {w - 1}', '0.9 1.6 0.5 0.5', '1 0 0', '0 1 0', '0 0 1', '0 0 0']
    (root / 'test' / seq / 'calibration.txt').write_text('\n'.join(lines) + '\n')
    (root / 'splits').mkdir(parents=True)
    (root / 'splits' / 'test_files.txt').write_text(''.join(f'{seq} {i:05}\n' for i in range(3)))
    _point(root, 'mannequin')
    yield root
    for p in (paths, jpaths):
        p.DATA_PATHS.pop('mannequin', None)


def _run_script(script: Path, argv: list) -> None:
    """Run a JAX `api/` script as `python script.py argv` runs it."""
    old = sys.argv
    sys.argv = [str(script)] + [str(a) for a in argv]
    sys.path.insert(0, str(script.parent))
    try:
        runpy.run_path(str(script), run_name='__main__')
    finally:
        sys.argv = old
        sys.path.remove(str(script.parent))


def _run_main(main, argv: list) -> None:
    """Run a port entry point as its console script runs it."""
    old = sys.argv
    sys.argv = ['slowtv-torch'] + [str(a) for a in argv]
    try:
        main()
    finally:
        sys.argv = old


def _runs(tmp_path) -> tuple[Path, Path]:
    """The same seeded weights as a port run (`last.ckpt`) and a JAX run (`last/`)."""
    from types import SimpleNamespace

    from slowtv_monodepth_tpu.core.checkpoint import save_checkpoint as jax_save
    cfg = {'net': {'depth': depth_cfg(pretrained=False)},
           'trainer': {'min_depth': 0.1, 'max_depth': 100}}
    net, params = seeded_pair(cfg['net']['depth'], seed=21)
    port = tmp_path / 'models' / 'kbr' / 'tiny' / '42' / 'models' / 'last.ckpt'
    save_checkpoint(port, {'depth': net.state_dict()}, cfg)
    jax_run = tmp_path / 'jax' / 'models'
    jax_run.mkdir(parents=True)
    jax_save(jax_run / 'last', SimpleNamespace(step=0, params={'depth': params}, aux={},
                                               opt_state={'count': np.zeros((), np.int32)}), cfg)
    (jax_run / 'finished').touch()
    return port, jax_run / 'last'


def test_eval_chain_matches_jax(syns_root, tmp_path, capsys):
    from fresh_interpreter import run_fresh
    from slowtv_monodepth_tpu_torch import export_preds, generate_tables
    port_ckpt, jax_ckpt = _runs(tmp_path)

    # Targets: the port's next to the split file, bitwise the JAX script's.
    _run_script(API / 'data' / 'export_gt' / 'from_dataset.py',
                ['--type', 'syns_patches', '--datum', 'image depth edge K', '--save-stem', 'jax'])
    _run_main(export_gt.main, ['--type', 'syns_patches', '--mode', 'test',
                               '--datum', 'image depth edge K'])
    got = dict(np.load(syns_root / 'splits' / 'targets_test.npz', allow_pickle=True))
    want = dict(np.load(syns_root / 'splits' / 'jax.npz', allow_pickle=True))
    assert got.keys() == want.keys() == {'depth', 'K', 'edge', 'cat', 'subcat'}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])

    # Predictions: refused before the run has finished, then equal to JAX's.
    pred_file, jax_pred_file = tmp_path / 'preds.npz', tmp_path / 'jax_preds.npz'
    argv = ['--cfg-file', EVAL_CFG, '--ckpt', port_ckpt, '--save-file', pred_file,
            '--device', 'cpu']
    with pytest.raises(SystemExit):
        _run_main(export_preds.main, argv)
    (port_ckpt.parent / 'finished').touch()
    _run_main(export_preds.main, argv)
    _run_script(API / 'eval' / 'export_preds.py',
                ['--cfg-file', EVAL_CFG, '--ckpt', jax_ckpt, '--save-file', jax_pred_file])
    preds, jax_preds = np.load(pred_file)['pred'], np.load(jax_pred_file)['pred']
    assert preds.shape == jax_preds.shape == (2, 192, 640)
    np.testing.assert_allclose(preds, jax_preds, atol=ATOL)

    # Metrics: the port's results YAML (a Pool of 2) against the JAX script's, both
    # on the port's predictions: the lsqr fit of a random net's maps is ill-conditioned
    # (a scale near 0), and it would carry their 1e-6 differences into every metric.
    results = port_ckpt.parents[1] / 'results' / 'syns_test_last_lsqr.yaml'
    jax_results = tmp_path / 'jax_results.yaml'
    # The port's Pool forks: in a fresh interpreter without JAX (`fresh_interpreter.py`).
    run_fresh("""
        from slowtv_monodepth_tpu_torch import eval_depth
        sys.argv = ['slowtv-eval-depth-torch'] + INPUTS
        eval_depth.main()
        """, tmp_path / 'fresh', env={'SLOWTV_DATA_ROOTS': str(syns_root.parent)},
              inputs=[str(a) for a in ('--cfg-file', EVAL_CFG, '--pred-file', pred_file,
                                       '--save-file', results, '--align-mode', 'lsqr',
                                       '--nproc', 2)])
    _run_script(API / 'eval' / 'eval_depth.py',
                ['--cfg-file', EVAL_CFG, '--pred-file', pred_file, '--save-file',
                 jax_results, '--align-mode', 'lsqr', '--nproc', 0])
    got, want = yaml.safe_load(results.read_text()), yaml.safe_load(jax_results.read_text())
    assert list(got) == list(want) and any(k.endswith('-Edges') for k in got)
    edges = np.load(syns_root / 'splits' / 'jax.npz')['edge']
    edge_pixels = int(edges.sum(axis=(1, 2)).min())
    assert_metrics_close(got, want, 2, edge_pixels // 2)

    # Tables over seeds: the port's text is the JAX script's.
    capsys.readouterr()
    argv = ['--root', tmp_path / 'models', '--exp', 'kbr', '--dataset', 'syns_test',
            '--ckpt', 'last', '--mode', 'lsqr']
    _run_main(generate_tables.main, argv)
    out = capsys.readouterr().out
    _run_script(API / 'eval' / 'generate_tables.py', argv)
    assert out == capsys.readouterr().out and 'tiny' in out and 'Rel' in out


@pytest.mark.parametrize('split', ['eigen', 'eigen_benchmark'])
def test_kitti_targets_match_jax(kitti_root, split):
    save = export_gt.export_kitti(split)
    _run_script(API / 'data' / 'export_gt' / 'kitti.py', ['--split', split, '--save-stem', 'jax'])
    got = dict(np.load(save, allow_pickle=True))
    want = dict(np.load(save.parent / 'jax.npz', allow_pickle=True))
    assert got.keys() == want.keys() == {'depth', 'K'}
    assert got['depth'].dtype == object and len(got['depth']) == 4
    shapes = np.repeat(list(KITTI_DRIVES.values()), 2, axis=0)
    for a, b, shape in zip(got['depth'], want['depth'], shapes):
        assert a.dtype == b.dtype and a.shape == tuple(shape) and (a > 0).any()
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got['K'], want['K'])
    with pytest.raises(FileExistsError):
        export_gt.export_kitti(split)


def test_export_preds_refuses_a_mesh_and_a_missing_card(tmp_path):
    from slowtv_monodepth_tpu_torch.export_preds import compute_preds, load_predictor
    for kw in ({'devices': 8}, {'model_shards': 2}, {'spatial_shards': 4}):
        with pytest.raises(NotImplementedError, match='ROADMAP queue A item 11'):
            compute_preds({}, 'last.ckpt', **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='--device cpu'):
            load_predictor('last.ckpt')


def _layout(batch) -> list:
    x, y, m = batch
    arrays = [(k, v.dtype, v.shape) for d in (x, y) for k, v in d.items()]
    return arrays + [(k, type(v), len(v), type(v[0])) for k, v in m.items()]


def _target_layout(data: dict) -> dict:
    """Key -> (dtype, ndim of an item, dtype of an item): what `eval_depth` reads
    (strings of any width)."""
    def kind(dtype):
        return 'str' if dtype.kind == 'U' else dtype
    return {k: (kind(v.dtype), np.asarray(v[0]).ndim, kind(np.asarray(v[0]).dtype))
            for k, v in data.items()}


def test_chip_smoke_eval_stand_ins_match_the_datasets(syns_root, kitti_root, mc_root):
    """`chip_smoke.EvalStandIn` yields what `export_preds.make_dataset` builds for each
    dataset (keys in order, dtypes, shapes at the predictor's shape) in batches of 12,
    and its targets have the layout `export_gt` writes for each eval cfg."""
    import chip_smoke
    from slowtv_monodepth_tpu_torch.config import load_yaml
    from slowtv_monodepth_tpu_torch.core import BenchmarkPredictor
    from slowtv_monodepth_tpu_torch.data import DataLoader
    from slowtv_monodepth_tpu_torch.export_preds import make_dataset

    scenes = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    exports = {'syns_test': lambda: export_gt.export('syns_patches', 'test', 'image depth edge K',
                                                     'targets_test'),
               'kitti_eigen': lambda: export_gt.export_kitti('eigen', overwrite=True),
               'kitti_eigen_benchmark': lambda: export_gt.export_kitti('eigen_benchmark',
                                                                       overwrite=True),
               'mc': lambda: export_gt.export('mannequin', 'test', 'image depth K', 'targets_test')}
    for name in chip_smoke.EVAL_A8A_SETS:  # the zero-shot sets: test_torch_eval_datasets.py
        for cfg_name in chip_smoke.EVAL_SETS[name][1]:
            cfg = load_yaml(ROOT / 'cfg' / 'eval' / f'{cfg_name}.yaml')
            assert cfg['args'] == chip_smoke.EVAL_ARGS[cfg_name]
            real = make_dataset(cfg['dataset'], BenchmarkPredictor('cpu'))
            stand_in = chip_smoke.EvalStandIn(scenes, name, n=len(real))
            assert (real.h, real.w) == (stand_in.h, stand_in.w)
            got, want = (_layout(next(iter(DataLoader(ds, batch_size=12, num_workers=0,
                                                      drop_last=False))))
                         for ds in (stand_in, real))
            assert got == want, (name, got, want)
            targets = dict(np.load(exports[cfg_name](), allow_pickle=True))
            assert _target_layout(stand_in.targets[cfg_name]) == _target_layout(targets), cfg_name
