"""Port differential: the train metrics against a depth target.

`core.train_metrics.compute_train_metrics` (median-aligned MAE, RMSE,
LogSI, AbsRel, Acc with the reference's legacy `Acc` denominator) and the
depth branch of `MonoDepthTrainer.scalars` (the finest depth resized to the
target, then the metrics) against the JAX package's on the same seeded
inputs: rows with no valid pixel, even and odd valid counts, ties, and
depths outside [min_depth, max_depth]. Tolerance rtol 1e-5 (float32 on both
sides, sums in another order: ~1e-7 seen). Two mutants of the port must
fail both comparisons: a median that takes the lower middle only, and `Acc`
over a count of valid pixels.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowtv_monodepth_tpu.core.train_metrics import compute_train_metrics as jax_metrics
from slowtv_monodepth_tpu.core.trainer import MonoDepthTrainer as JaxTrainer
from slowtv_monodepth_tpu_torch.core import train_metrics as tm
from slowtv_monodepth_tpu_torch.core import trainer as port_trainer
from test_torch_loop import LOSS, NET
from torch_threads import two_torch_threads  # noqa: F401

RTOL = 1e-5
MIN_DEPTH, MAX_DEPTH = 0.1, 100.0


def metric_inputs(h=6, w=9) -> tuple[np.ndarray, np.ndarray]:
    """(pred, target), (6, h, w, 1) float32: one row per case the median must handle."""
    rs = np.random.RandomState(0)
    n = h * w
    target = rs.uniform(0.5, 80, (6, n)).astype(np.float32)
    pred = rs.uniform(0.05, 150, (6, n)).astype(np.float32)
    target[0] = 0                            # no valid pixel: both medians 1.0
    target[1, 2 * (n // 4):] = 0             # an even count of valid pixels
    target[2, 2 * (n // 4) + 1:] = -1        # an odd count
    target[3] = np.repeat(rs.uniform(1, 50, n // 6), 6)[:n]   # ties in the target
    pred[3] = np.repeat(rs.uniform(1, 50, n // 3), 3)[:n]     # and in the prediction
    target[4, ::3] = rs.uniform(100, 300, len(target[4, ::3]))  # targets past max_depth
    target[4, 1::5] = rs.uniform(0, MIN_DEPTH, len(target[4, 1::5]))  # and under min_depth
    pred[4, ::4] = rs.uniform(0, MIN_DEPTH, len(pred[4, ::4]))  # predictions clipped
    pred[4, 2::4] = rs.uniform(100, 500, len(pred[4, 2::4]))
    return pred.reshape(6, h, w, 1), target.reshape(6, h, w, 1)


def _valid_counts(target) -> list:
    t = target.reshape(len(target), -1)
    return [int(((r > MIN_DEPTH) & (r < MAX_DEPTH)).sum()) for r in t]


def _compare(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k].cpu() if torch.is_tensor(got[k]) else got[k]), np.asarray(want[k])
        assert np.isfinite(w).all(), k
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)


def mutant(old: str, new: str):
    """`compute_train_metrics` of a copy of the port's module with `old` replaced by `new`."""
    src = inspect.getsource(tm)
    assert src.count(old) == 1, old
    ns: dict = {}
    exec(compile(src.replace(old, new), tm.__file__, 'exec'), ns)
    return ns['compute_train_metrics']


MUTANTS = {
    'median_lower_middle': ('med = 0.5 * (take(lo) + take(hi))', 'med = take(lo)'),
    'acc_over_count': ('torch.where(mask, thresh, 0.0).sum(dim=1).clamp(min=1.0)',
                       'mask.sum(dim=1).clamp(min=1)'),
}


def test_the_inputs_cover_every_case():
    pred, target = metric_inputs()
    counts = _valid_counts(target)
    assert counts[0] == 0 and counts[1] % 2 == 0 and counts[2] % 2 == 1
    assert len(np.unique(target[3])) < target[3].size and len(np.unique(pred[3])) < pred[3].size
    assert (target[4] > MAX_DEPTH).any() and ((0 < target[4]) & (target[4] < MIN_DEPTH)).any()
    assert (pred[4] < MIN_DEPTH).any() and (pred[4] > MAX_DEPTH).any()


@pytest.mark.parametrize('depth_range', [(MIN_DEPTH, MAX_DEPTH), (1.0, 40.0)],
                         ids=['kbr', 'narrow'])
def test_metrics_match_the_jax_function(depth_range):
    pred, target = metric_inputs()
    got = tm.compute_train_metrics(torch.from_numpy(pred), torch.from_numpy(target), *depth_range)
    _compare(got, jax_metrics(jnp.asarray(pred), jnp.asarray(target), *depth_range))
    assert tuple(got) == tm.METRIC_NAMES
    assert all(v.dim() == 0 and v.dtype == torch.float32 for v in got.values())


# ----------------------------------------------------------------- the scalars
@pytest.fixture(scope='module')
def trainers():
    cfg = {'net': NET, 'loss': LOSS, 'trainer': {'min_depth': MIN_DEPTH, 'max_depth': MAX_DEPTH}}
    torch.manual_seed(0)
    return port_trainer.MonoDepthTrainer(cfg), JaxTrainer(cfg)


def scalar_inputs() -> tuple[dict, dict, dict]:
    """(fwd, y, loss_dict) as numpy: two scales of depth at 8x12 and a 12x20 target,
    poses, learned intrinsics."""
    rs = np.random.RandomState(1)
    b = 6
    _, target = metric_inputs(12, 20)
    fwd = {'disp_up': {s: rs.rand(b, 8, 12, 1).astype(np.float32) for s in (0, 1)},
           'depth_up': {s: rs.uniform(0.5, 60, (b, 8, 12, 1)).astype(np.float32) for s in (1, 0)},
           'T_-1': rs.randn(b, 4, 4).astype(np.float32), 'T_1': rs.randn(b, 4, 4).astype(np.float32),
           'fs': rs.rand(2, b, 2).astype(np.float32), 'cs': rs.rand(2, b, 2).astype(np.float32)}
    fwd['Ts'] = np.stack([fwd['T_-1'], fwd['T_1']])
    ld = {'loss_img_recon': np.float32(0.25), 'loss_disp_smooth': np.float32(0.5),
          'auto_mask': rs.rand(b, 8, 12, 1).astype(np.float32)}
    return fwd, {'depth': target}, ld


def _tree(d, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in d.items()}


def _scalars(trainers, metrics_fn=None):
    port, jax_t = trainers
    fwd, y, ld = scalar_inputs()
    loss = np.float32(0.75)
    want = jax_t.scalars(jnp.asarray(loss), _tree(ld, jnp.asarray), _tree(fwd, jnp.asarray),
                         _tree(y, jnp.asarray))
    with pytest.MonkeyPatch.context() as mp:
        if metrics_fn is not None:
            mp.setattr(port_trainer, 'compute_train_metrics', metrics_fn)
        got = port.scalars(torch.tensor(loss), _tree(ld, torch.tensor), _tree(fwd, torch.tensor),
                           _tree(y, torch.tensor))
    return got, want


def test_scalars_depth_branch_matches_the_jax_scalars(trainers):
    got, want = _scalars(trainers)
    assert set(tm.METRIC_NAMES) <= set(got) and 'fx' in got
    _compare(got, want)


@pytest.mark.parametrize('where', ['metrics', 'scalars'])
@pytest.mark.parametrize('name', list(MUTANTS))
def test_each_mutant_fails_the_comparison(trainers, name, where):
    fn = mutant(*MUTANTS[name])
    if where == 'metrics':
        pred, target = metric_inputs()
        got = fn(torch.from_numpy(pred), torch.from_numpy(target), MIN_DEPTH, MAX_DEPTH)
        want = jax_metrics(jnp.asarray(pred), jnp.asarray(target), MIN_DEPTH, MAX_DEPTH)
    else:
        got, want = _scalars(trainers, fn)
    with pytest.raises(AssertionError):
        _compare(got, want)
