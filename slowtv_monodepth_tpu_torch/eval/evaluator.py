"""Offline depth evaluator (per-item alignment + metric fan-out).

Capability parity with `src/core/evaluator.py:16-256`: upsample scaleless
disparity to GT resolution, convert to depth, range/crop masking, alignment
(median / least-squares-in-disparity / fixed metric factor), then the metric
collections from `eval.metrics`, fanned out over a multiprocessing Pool with
category averaging.

Known reference divergence (intentional): the public reference swaps the
Eigen/NYUD crop implementations (`evaluator.py:175-198` routes
`use_eigen_crop` -> `_get_nyud_mask`, which asserts a (480, 640) shape and
would crash `cfg/eval/kitti_eigen.yaml`). The published result YAMLs predate
that regression, so this implementation uses the correct mapping:
`use_eigen_crop` -> Garg/Eigen crop ratios, `use_nyud_crop` -> NYU-D border.

Copy of `slowtv_monodepth_tpu/eval/evaluator.py`, with two changes:
- `upsample` uses `utils.resize`, a numpy restatement of `cv2.resize`
  (nearest and bilinear bitwise, bicubic within 3 float32 ulps): the card's
  machine has no cv2;
- the per-item path (`__call__` and everything it calls) imports and runs
  numpy and scipy only, never torch. `run` forks its Pool workers from the
  caller, which may have initialised CUDA and torch's thread pools (as
  `eval_depth --ckpt` has): a forked child must not touch either, and this
  path does not. A `forkserver` or `spawn` Pool would not inherit that state,
  but each of its workers imports the caller's `__main__` again, and a caller
  without an `if __name__ == '__main__'` guard (a notebook, a script read from
  stdin) makes that Pool hang.
"""
from __future__ import annotations

import multiprocessing
from typing import Optional, Sequence, Union

import numpy as np

from .. import LOGGER
from ..utils.resize import resize
from .metrics import metrics_benchmark, metrics_eigen, metrics_ibims, metrics_pointcloud

__all__ = ['MonoDepthEvaluator']


def _to_inv(x):
    """Depth <-> disparity with zeroed invalids (numpy twin of `ops.to_inv`)."""
    x = np.asarray(x)
    return (x > 0) / np.maximum(x, np.finfo(np.float32).tiny)


class MonoDepthEvaluator:
    """:param metrics: Metric collections {benchmark, eigen, pointcloud, ibims}.
    :param align_mode: {median, lsqr} or a float metric scale factor (1, 5.4...).
    :param interp_mode: Prediction upsampling {nearest, bilinear, bicubic}.
    :param min: Min GT depth for evaluation.
    :param max: Max GT depth for evaluation (None to disable).
    :param use_eigen_crop: Classic Eigen/Garg crop (legacy KITTI).
    :param use_nyud_crop: NYU-D border crop.
    """

    def __init__(self,
                 metrics: Sequence[str] = ('benchmark', 'pointcloud'),
                 align_mode: Union[str, float] = 1,
                 interp_mode: str = 'bilinear',
                 min: float = 1e-3,  # noqa: A002
                 max: Optional[float] = None,  # noqa: A002
                 use_eigen_crop: bool = False,
                 use_nyud_crop: bool = False):
        self.align_mode = align_mode
        self.metrics = metrics
        self.min = min
        self.max = max
        self.use_eigen_crop = use_eigen_crop
        self.use_nyud_crop = use_nyud_crop
        if interp_mode not in ('nearest', 'bilinear', 'bicubic'):
            raise KeyError(interp_mode)
        self.interp_mode = interp_mode

    # ------------------------------------------------------------ single item
    def __call__(self, pred: np.ndarray, target: np.ndarray, metrics: Sequence[str],
                 K: Optional[np.ndarray] = None,
                 mask: Optional[np.ndarray] = None) -> dict:
        """Compute metrics for one item (ref `evaluator.py:50-94`).

        :param pred: (h', w') scaleless disparity prediction.
        :param target: (h, w) ground-truth depth.
        :param metrics: Metric collections to compute for this pass.
        :param K: (4, 4) intrinsics (pointcloud only).
        :param mask: (h, w) extra valid/edge mask.
        """
        target = target.astype(np.float32)
        pred = _to_inv(self.upsample(pred, target))

        if mask is None:
            mask = np.ones_like(target, dtype=bool)
        mask = mask & self.get_mask(target) & (pred > 0)
        if mask.sum() == 0:
            return {}
        pred_mask, target_mask = pred[mask], target[mask]
        if pred_mask.sum() == 0:
            return {}

        inv = self.align_mode == 'lsqr'  # LSQR runs in disparity space (MiDaS).
        a, b = self.align(pred_mask, target_mask, inv=inv)
        pred = self.scale(pred, a, b, inv=inv)
        pred_mask = self.scale(pred_mask, a, b, inv=inv)

        ms = {'Scale': a, 'Shift': b}
        for m in metrics:
            if m == 'eigen':
                ms |= metrics_eigen(pred_mask, target_mask)
            elif m == 'benchmark':
                ms |= metrics_benchmark(pred_mask, target_mask)
            elif m == 'pointcloud':
                ms |= metrics_pointcloud(pred, target, mask, K)
            elif m == 'ibims':
                ms |= metrics_ibims(pred, target, mask)
        return ms

    # ---------------------------------------------------------------- dataset
    def run(self, preds: np.ndarray, data: dict, nproc: Optional[int] = None,
            chunks: int = 1, max_items: Optional[int] = None):
        """Evaluate a whole dataset (ref `evaluator.py:96-143`).

        :param preds: (b, h', w') scaleless disparity predictions.
        :param data: NPZ-style dict {depth, [K], [edge], [cat], [subcat]}.
        :return: (mean_metrics, per-item metrics list).
        """
        targets, Ks, edges = data['depth'], data.get('K'), data.get('edge')
        cats, subcats = data.get('cat'), data.get('subcat')

        if Ks is None and 'pointcloud' in self.metrics:
            raise ValueError('Missing intrinsics when computing pointcloud metrics!')
        if edges is None and 'ibims' in self.metrics:
            raise ValueError('Missing edge masks when computing IBIMS metrics!')
        if (a := len(preds)) != (b := len(targets)):
            raise ValueError(f'Non-matching preds and targets! ({a} vs. {b})')

        n = min(len(targets), max_items) if max_items else len(targets)
        preds, targets = preds[:n], targets[:n]

        metrics = self._run(preds, targets, [m for m in self.metrics if m != 'ibims'],
                            Ks, nproc=nproc, chunks=chunks)
        if edges is not None:
            edge_metrics = self._run(preds, targets, self.metrics, Ks, edges,
                                     nproc=nproc, chunks=chunks)
            for m1, m2 in zip(metrics, edge_metrics):
                m1.update({f'{k}-Edges': v for k, v in m2.items()})

        if cats is not None:
            self.add_cats(metrics, cats, subcats)

        metrics = [m for m in metrics if m]
        mean_metrics = self.average(metrics)
        self.summarize(mean_metrics)
        return mean_metrics, metrics

    def _run(self, preds, targets, metrics, Ks=None, masks=None,
             nproc: Optional[int] = None, chunks: int = 1) -> list:
        """Pool fan-out over items (ref `evaluator.py:145-162`), forked (see the
        module docstring)."""
        n = len(preds)
        args = list(zip(
            preds, targets, (metrics for _ in range(n)),
            [None] * n if Ks is None else Ks,
            [None] * n if masks is None else masks,
        ))
        if nproc == 0:  # In-process (tests / small sets).
            return [self(*a) for a in args]
        with multiprocessing.get_context('fork').Pool(nproc) as p:
            return list(p.starmap(self, args, chunksize=chunks))

    def summarize(self, mean_metrics: dict) -> None:
        from ..tools import TableFormatter
        LOGGER.info('Summarizing results...')
        print(TableFormatter.from_dict(mean_metrics).to_latex(precision=4))

    # ---------------------------------------------------------------- helpers
    def upsample(self, pred: np.ndarray, target: np.ndarray) -> np.ndarray:
        h, w = target.shape
        if pred.shape != target.shape:
            pred = resize(pred, (h, w), self.interp_mode)
        return pred

    def get_mask(self, target: np.ndarray) -> np.ndarray:
        """Range mask + optional crops (ref `evaluator.py:175-198`; see module
        docstring for the deliberate crop-mapping fix)."""
        mask = target > self.min
        if self.max:
            mask &= target < self.max
        if self.use_eigen_crop:
            mask &= self._get_eigen_mask(target.shape)
        if self.use_nyud_crop:
            mask &= self._get_nyud_mask(target.shape)
        return mask

    @staticmethod
    def _get_eigen_mask(shape: tuple) -> np.ndarray:
        h, w = shape
        crop = np.array([0.40810811 * h, 0.99189189 * h,
                         0.03594771 * w, 0.96405229 * w], dtype=int)
        mask = np.zeros((h, w), dtype=bool)
        mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
        return mask

    @staticmethod
    def _get_nyud_mask(shape: tuple) -> np.ndarray:
        assert shape == (480, 640)
        mask = np.zeros(shape, dtype=bool)
        mask[45:471, 41:601] = 1
        return mask

    def align(self, pred: np.ndarray, target: np.ndarray, inv: bool = False):
        """Scale & shift per `align_mode` (ref `evaluator.py:200-234`)."""
        if inv:
            pred, target = _to_inv(pred), _to_inv(target)
        if self.align_mode == 'median':
            r, s = self._align_median(pred, target)
        elif self.align_mode == 'lsqr':
            r, s = self._align_lsqr(pred, target)
        else:
            r, s = self._align_metric(self.align_mode)
        return float(r), float(s)

    @staticmethod
    def _align_metric(factor=None):
        return factor or 1, 0

    @staticmethod
    def _align_median(pred, target):
        return np.median(target) / np.median(pred), 0

    @staticmethod
    def _align_lsqr(pred, target):
        A = np.array([[(pred ** 2).sum(), pred.sum()], [pred.sum(), pred.shape[0]]])
        if np.linalg.det(A) <= 0:
            return 0, 0  # Singular-matrix guard.
        b = np.array([(pred * target).sum(), target.sum()])
        x = np.linalg.inv(A) @ b
        return x.tolist()

    def scale(self, pred: np.ndarray, scale: float, shift: float, inv: bool = False):
        """Apply `a*x + b` (in disparity space if `inv`), clip to range."""
        if inv:
            pred = _to_inv(pred)
        pred = scale * pred + shift
        if inv:
            pred = _to_inv(pred)
        return pred.clip(self.min, self.max)

    def add_cats(self, metrics, cats, subcats) -> None:
        for m, cat, subcat in zip(metrics, cats, subcats):
            if m:
                m['Cat'], m['SubCat'] = str(cat), str(subcat)

    @staticmethod
    def average(metrics: list) -> dict:
        keys = (k for k, v in metrics[0].items() if isinstance(v, float))
        return {k: float(np.mean([d[k] for d in metrics if k in d])) for k in keys}
