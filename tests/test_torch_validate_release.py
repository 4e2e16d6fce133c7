"""Port differential: `slowtv-validate-release-torch`, `align` and `data.play`.

Release validation in preds-only mode, the port's `validate_release.main`
beside `api/eval/validate_release.py` run as a script, on the same
prediction NPZs over synthetic SYNS-Patches and NYUD-v2 (its crop on), the
targets exported by `slowtv-export-gt-torch`: the same report rows (every
float equal), statuses and exit code, against the published baselines (exit
1), against baselines seeded from the metrics (exit 0), and with no data
(exit 3). Then the port alone: `--ckpt` on a seeded checkpoint, a file and a
run directory (exit 1 against the published numbers, 0 against its own);
the two repairs of the JAX script (a directory's `<ds>_*.npz` fallback no
longer binds `kitti_eigen` to `kitti_eigen_benchmark.npz`, which the JAX
function does; `--preds` with `--ckpt` refused).

`align`: `align_median` / `align_lsqr` (the evaluator's, singular guard
included) and `main` on two `.npy` files against `api/quickstart/align.py`'s
functions. `play`: the two cases of `tests/test_data.py::TestPlayCli` against
the port's module.
"""
import importlib.util
import logging
import sys

import numpy as np
import pytest
import yaml

from slowtv_monodepth_tpu_torch import export_gt, validate_release
from test_torch_eval_api import API, _run_main, _run_script, syns_root  # noqa: F401
from test_torch_eval_datasets import point, port_ckpt, unpoint, write_nyud  # noqa: F401
from torch_threads import two_torch_threads  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401


@pytest.fixture
def data(syns_root, tmp_path):  # noqa: F811
    """SYNS-Patches and NYUD-v2 targets (`slowtv-export-gt-torch`) and released-style
    prediction NPZs of both."""
    nyud = tmp_path / 'NYUD_v2'
    write_nyud(nyud, np.random.default_rng(3))
    point('nyud', nyud)
    export_gt.export('syns_patches', 'test', 'image depth edge K', 'targets_test')
    export_gt.export('nyud', 'test', 'image depth', 'targets_test')
    released = tmp_path / 'released'
    released.mkdir()
    rng = np.random.default_rng(0)
    for ds in ('syns_test', 'nyud'):
        np.savez_compressed(released / f'{ds}.npz',
                            pred=(0.05 + rng.random((2, 48, 64))).astype(np.float32))
    yield released
    unpoint('nyud')


def _port(argv) -> int:
    old = sys.argv
    sys.argv = ['slowtv-validate-release-torch'] + [str(a) for a in argv]
    try:
        return validate_release.main()
    finally:
        sys.argv = old


def _jax(argv) -> int:
    try:
        _run_script(API / 'eval' / 'validate_release.py', argv)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def _report(out) -> dict:
    return yaml.safe_load((out / 'validation_report.yaml').read_text())


def _both(tmp_path, tag: str, argv) -> tuple[dict, dict]:
    """Both scripts on `argv`: the same exit code -> (port report, JAX report)."""
    rcs = [run(argv + ['--out', tmp_path / f'{tag}_{name}']) for name, run in
           (('port', _port), ('jax', _jax))]
    assert rcs[0] == rcs[1], rcs
    return (_report(tmp_path / f'{tag}_port'), _report(tmp_path / f'{tag}_jax')), rcs[0]


def test_preds_only_matches_the_jax_script(data, tmp_path):
    argv = ['--preds', data, '--datasets', 'syns_test', 'nyud', '--nproc', 0]
    (got, want), rc = _both(tmp_path, 'published', argv)
    assert rc == 1 and got == want
    assert got['preds_only'] and got['n_failed'] > 0 and got['n_evaluated'] == 6  # NYUD: no F-Score
    assert {(r['dataset'], r['align']) for r in got['rows']} == {
        (d, a) for d in ('nyud', 'syns_test') for a in ('lsqr', 'median')}
    for ds in ('syns_test', 'nyud'):
        for align in ('lsqr', 'median'):
            files = [tmp_path / f'published_{n}' / 'preds_only' / 'results' /
                     f'{ds}_last_{align}.yaml' for n in ('port', 'jax')]
            assert yaml.safe_load(files[0].read_text()) == yaml.safe_load(files[1].read_text())

    # Baselines seeded from the metrics: both pass.
    base = {'kbr/base': {ds: {'last': {a: {r['metric']: r['ours'] for r in got['rows']
                                           if r['dataset'] == ds and r['align'] == a}
                                       for a in ('lsqr', 'median')}}
                         for ds in ('syns_test', 'nyud')}}
    base_file = tmp_path / 'baselines_self.yaml'
    base_file.write_text(yaml.safe_dump(base))
    (got, want), rc = _both(tmp_path, 'self', argv + ['--baselines', base_file])
    assert rc == 0 and got == want and got['passed'] and got['n_evaluated'] == 6

    # No data for any dataset asked for: nothing evaluated, exit 3.
    (got, want), rc = _both(tmp_path, 'none', ['--preds', data, '--datasets', 'sintel', 'tum'])
    assert rc == 3 and got == want
    assert {r['status'] for r in got['rows']} == {'SKIPPED'}


def test_checkpoint_mode_gates_on_its_own_metrics(syns_root, port_ckpt, tmp_path):  # noqa: F811
    export_gt.export('syns_patches', 'test', 'image depth edge K', 'targets_test')
    argv = ['--datasets', 'syns_test', '--device', 'cpu', '--num-workers', 0, '--nproc', 0]
    rc = _port(['--ckpt', port_ckpt, '--out', tmp_path / 'fail'] + argv)
    report = _report(tmp_path / 'fail')
    assert rc == 1 and report['n_seeds'] == 1 and not report['preds_only']
    assert (tmp_path / 'fail' / 'seed_000' / 'preds' / 'syns_test_last.npz').is_file()
    for align in ('lsqr', 'median'):
        res = yaml.safe_load((tmp_path / 'fail' / 'seed_000' / 'results' /
                              f'syns_test_last_{align}.yaml').read_text())
        assert np.isfinite(res['AbsRel']) and 'F-Score (10)' in res
    base = {'kbr/base': {'syns_test': {'last': {a: {r['metric']: r['ours'] for r in report['rows']
                                                    if r['align'] == a}
                                                for a in ('lsqr', 'median')}}}}
    base_file = tmp_path / 'baselines_self.yaml'
    base_file.write_text(yaml.safe_dump(base))
    # The run directory resolves to its `models/last.ckpt`.
    run_dir = port_ckpt.parents[1]
    rc = _port(['--ckpt', run_dir, '--out', tmp_path / 'pass', '--baselines', base_file] + argv)
    report = _report(tmp_path / 'pass')
    assert rc == 0 and report['passed'] and report['n_evaluated'] == 4
    with pytest.raises(FileNotFoundError, match='models/last.ckpt'):
        validate_release._resolve_ckpt(tmp_path / 'nowhere')


def test_sibling_npz_is_not_bound_to_another_dataset(tmp_path, caplog):
    """`kitti_eigen` with only its siblings' files in the directory: the JAX function binds
    it to `kitti_eigen_benchmark.npz`, the port leaves it out (SKIPPED) and logs what
    each dataset resolved to; a file of its own (`kitti_eigen_042.npz`) binds."""
    spec = importlib.util.spec_from_file_location('jax_validate_release',
                                                  API / 'eval' / 'validate_release.py')
    jmod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(API / 'eval'))
    try:
        spec.loader.exec_module(jmod)
    finally:
        sys.path.remove(str(API / 'eval'))
    d = tmp_path / 'released'
    d.mkdir()
    for stem in ('kitti_eigen_benchmark', 'kitti_eigen_zhou_042', 'syns_test_042'):
        np.savez_compressed(d / f'{stem}.npz', pred=np.ones((1, 4, 4), np.float32))
    datasets = ['kitti_eigen', 'syns_test']
    assert jmod._find_released_preds([d], datasets)['kitti_eigen'].name == \
        'kitti_eigen_benchmark.npz'
    known = [f.stem for f in validate_release.EVAL_CFGS.glob('*.yaml')]
    with caplog.at_level(logging.INFO, logger='slowtv_torch'):
        got = validate_release._find_released_preds([d], datasets, known)
    assert got == {'syns_test': d / 'syns_test_042.npz'}
    assert 'syns_test_042.npz' in caplog.text
    np.savez_compressed(d / 'kitti_eigen_042.npz', pred=np.ones((1, 4, 4), np.float32))
    got = validate_release._find_released_preds([d], datasets, known)
    assert got['kitti_eigen'] == d / 'kitti_eigen_042.npz'

    (d / 'kitti_eigen_042.npz').unlink()
    rc = _port(['--preds', d, '--datasets', 'kitti_eigen', '--out', tmp_path / 'out'])
    assert rc == 3
    assert [(r['dataset'], r['status']) for r in _report(tmp_path / 'out')['rows']] == [
        ('kitti_eigen', 'SKIPPED')]


def test_preds_and_ckpt_are_refused_together(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _port(['--preds', tmp_path, '--ckpt', tmp_path / 'x.ckpt', '--out', tmp_path / 'out'])
    assert e.value.code == 2 and 'cannot be mixed' in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _port(['--out', tmp_path / 'out'])  # neither


# ------------------------------------------------------------------- align
def _jax_align():
    spec = importlib.util.spec_from_file_location('jax_align', API / 'quickstart' / 'align.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('case', ['random', 'singular'])
def test_align_matches_the_jax_snippet(case):
    from slowtv_monodepth_tpu_torch import align
    jmod = _jax_align()
    rs = np.random.RandomState(4)
    pred = np.full(50, 0.3) if case == 'singular' else 0.1 + rs.rand(50)
    target = 2 + 3 * pred + 0.01 * rs.randn(50)
    assert align.align_median(pred, target) == jmod.align_median(pred, target)
    got, want = align.align_lsqr(pred, target), jmod.align_lsqr(pred, target)
    assert got == want
    if case == 'singular':
        assert got == (0, 0)
    else:
        np.testing.assert_allclose(got, [3, 2], atol=0.05)


def test_align_main_on_npy_files(tmp_path):
    """`main(depth_file, lidar_file)`: the snippet's median-then-disparity-lsqr, here on
    files, against the JAX snippet's functions step by step."""
    from slowtv_monodepth_tpu_torch import align
    jmod = _jax_align()
    rs = np.random.RandomState(5)
    lidar = np.where(rs.rand(30, 40) < 0.3, 1 + 50 * rs.rand(30, 40), 0)
    lidar[0, :5] = 150  # out of range: not used
    # affine in disparity, as a scaleless prediction is: the lsqr fit recovers the metric
    depth = (1 + 0.01 * rs.rand(30, 40)) / (0.5 / np.maximum(lidar, 1) + 0.02)
    np.save(tmp_path / 'depth.npy', depth)
    np.save(tmp_path / 'lidar.npy', lidar)
    got, got_mask = align.main(tmp_path / 'depth.npy', tmp_path / 'lidar.npy',
                               tmp_path / 'aligned.npy')

    def to_inv(d, eps=1e-5):
        return (d > 0) / (d + eps)
    valid = (lidar > 0) & (lidar < 100)
    s = jmod.align_median(depth[valid], lidar[valid])
    d, dm = depth * s, depth[valid] * s
    scale, shift = jmod.align_lsqr(to_inv(dm), to_inv(lidar[valid]))
    want, want_mask = to_inv(to_inv(d) * scale + shift), to_inv(to_inv(dm) * scale + shift)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(np.load(tmp_path / 'aligned.npy'), want)
    assert np.median(np.abs(got_mask - lidar[valid]) / lidar[valid]) < 0.02


# -------------------------------------------------------------------- play
class TestPlayCli:
    """`python -m slowtv_monodepth_tpu_torch.data.play`: `tests/test_data.py::TestPlayCli`'s
    cases against the port's module."""

    def _run(self, argv, monkeypatch):
        import slowtv_monodepth_tpu_torch.data.play as play
        monkeypatch.setattr('sys.argv', ['play'] + argv)
        play.main()

    def test_unknown_type_exits_with_listing(self, monkeypatch):
        with pytest.raises(SystemExit, match="nope_ds.*'ddad'"):
            self._run(['nope_ds'], monkeypatch)

    def test_plays_registered_dataset_with_kw(self, monkeypatch):
        from slowtv_monodepth_tpu_torch.registry import DATA_REG
        calls = {}

        class _FakeDs:
            def __init__(self, mode, **kw):
                calls['init'] = (mode, kw)

            def __len__(self):
                return 3

            def play(self, fps, skip, reverse):
                calls['play'] = (fps, skip, reverse)

        monkeypatch.setitem(DATA_REG, 'fake_ds', _FakeDs)
        self._run(['fake_ds', '--mode', 'val', '--kw', '{shape: [32, 64]}',
                   '--fps', '2', '--skip', '5', '--reverse'], monkeypatch)
        assert calls['init'] == ('val', {'shape': [32, 64]})
        assert calls['play'] == (2.0, 5, True)
