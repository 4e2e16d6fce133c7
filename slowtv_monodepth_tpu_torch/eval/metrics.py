"""Offline evaluation metric collections (host-side numpy).

Copy of `slowtv_monodepth_tpu/eval/metrics.py`, with the Chamfer query on
`scipy.spatial.cKDTree` in place of scikit-learn's KD-tree (the card's
machine has no scikit-learn; both return the same float32 distances).
Numerics match `src/core/metrics.py:10-205` exactly — they define the
published results:

- `metrics_eigen` keeps the *intentionally wrong* legacy SqRel
  (`err_sq/target`, not `err_sq/target**2`; ref note `metrics.py:29-34`).
- `metrics_benchmark` reports m / 1/km / log(m)*100 / % units and the
  DIRECTIONAL log error feeding LogSI (ref `:81-94`).
- `metrics_pointcloud` backprojects with K^-1, subsamples every 2nd point for
  the KD-tree Chamfer query, thresholds at 5/10/20cm (ref `:112-165`).
- `metrics_ibims` uses log-preprocessed Canny edges, 10m direction plane, and
  edge distance threshold 10px (ref `:171-205`).
"""
from __future__ import annotations

from functools import wraps
from typing import Optional

import numpy as np

from .edges import extract_edges

__all__ = ['metrics_eigen', 'metrics_benchmark', 'metrics_pointcloud', 'metrics_ibims']


def to_float(fn):
    """Convert all metric values to plain floats (ref `metrics.py:15-21`)."""
    @wraps(fn)
    def wrapper(*a, **kw):
        return {k: float(v) for k, v in fn(*a, **kw).items()}
    return wrapper


@to_float
def metrics_eigen(pred: np.ndarray, target: np.ndarray) -> dict:
    """Kitti Eigen metrics on masked 1-D depths (ref `metrics.py:26-59`)."""
    err = np.abs(pred - target)
    err_rel = err / target
    err_sq = err ** 2
    err_sq_rel = err_sq / target  # Legacy-incorrect on purpose (see module doc).
    err_log_sq = (np.log(pred) - np.log(target)) ** 2
    thresh = np.maximum(target / pred, pred / target)
    return {
        'AbsRel': err_rel.mean(),
        'SqRel': err_sq_rel.mean(),
        'RMSE': np.sqrt(err_sq.mean()),
        'LogRMSE': np.sqrt(err_log_sq.mean()),
        '$\\delta_{.05}$': 100 * (thresh < 1.05).mean(),
        '$\\delta_{.1}$': 100 * (thresh < 1.1).mean(),
        '$\\delta_{.25}$': 100 * (thresh < 1.25).mean(),
        '$\\delta_{.25^2}$': 100 * (thresh < 1.25 ** 2).mean(),
        '$\\delta_{.25^3}$': 100 * (thresh < 1.25 ** 3).mean(),
    }


@to_float
def metrics_benchmark(pred: np.ndarray, target: np.ndarray) -> dict:
    """Kitti Benchmark metrics on masked 1-D depths (ref `metrics.py:65-105`)."""
    err = np.abs(pred - target)                      # m
    err_sq = err ** 2
    err_inv = 1000 * np.abs(1 / pred - 1 / target)   # 1/km
    err_inv_sq = err_inv ** 2
    err_log = 100 * (np.log(pred) - np.log(target))  # log(m)*100, directional
    err_log_sq = err_log ** 2
    err_rel = 100 * (err / target)                   # %
    err_rel_sq = 100 * (err_sq / target ** 2)
    return {
        'MAE': err.mean(),
        'RMSE': np.sqrt(err_sq.mean()),
        'InvMAE': err_inv.mean(),
        'InvRMSE': np.sqrt(err_inv_sq.mean()),
        'LogMAE': np.abs(err_log).mean(),
        'LogRMSE': np.sqrt(err_log_sq.mean()),
        'LogSI': np.sqrt(err_log_sq.mean() - err_log.mean() ** 2),
        'AbsRel': err_rel.mean(),
        'SqRel': err_rel_sq.mean(),
    }


# POINTCLOUD
# -----------------------------------------------------------------------------
def _backproject(depth: np.ndarray, K_inv: np.ndarray) -> np.ndarray:
    """(h, w) depth + (4, 4) K^-1 -> (h*w, 3) points (ref `geometry.py:285-316`)."""
    h, w = depth.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing='ij')
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w, np.float32)], axis=-1)
    rays = pix @ K_inv[:3, :3].T
    return rays * depth.reshape(-1, 1)


def _metrics_pts(pred: np.ndarray, target: np.ndarray, th: float):
    """F-Score/IoU from chamfer distances (ref `metrics.py:112-120`)."""
    P = (pred < th).mean()
    R = (target < th).mean()
    if (P < 1e-3) and (R < 1e-3):
        return 0, 0
    f = 2 * P * R / (P + R + 1e-5)
    iou = P * R / (P + R - (P * R) + 1e-5)
    return 100 * f, 100 * iou


def _chamfer_dist(pred: np.ndarray, target: np.ndarray):
    """Bidirectional NN distances via KD-tree, every-2nd-point subsampling
    (ref `metrics.py:122-132`)."""
    from scipy.spatial import cKDTree
    pred_nn = cKDTree(target).query(pred[::2], k=1)[0].astype(np.float32).squeeze()
    target_nn = cKDTree(pred).query(target[::2], k=1)[0].astype(np.float32).squeeze()
    return pred_nn, target_nn


@to_float
def metrics_pointcloud(pred: np.ndarray, target: np.ndarray, mask: np.ndarray,
                       K: np.ndarray) -> dict:
    """Pointcloud reconstruction metrics (Ornek; ref `metrics.py:135-165`).

    :param pred: (h, w) aligned predicted depth.
    :param target: (h, w) ground-truth depth.
    :param mask: (h, w) valid pixels.
    :param K: (4, 4) intrinsics.
    """
    K_inv = np.linalg.inv(np.asarray(K, np.float32))
    m = mask.ravel()
    pred_pts = _backproject(np.asarray(pred, np.float32), K_inv)[m]
    target_pts = _backproject(np.asarray(target, np.float32), K_inv)[m]

    pred_nn, target_nn = _chamfer_dist(pred_pts, target_pts)
    out = {'Chamfer': pred_nn.mean() + target_nn.mean()}
    for th in (0.05, 0.1, 0.2):
        out[f'F-Score ({th * 100:.0f})'], out[f'IoU ({th * 100:.0f})'] = _metrics_pts(
            pred_nn, target_nn, th=th)
    return out


@to_float
def metrics_ibims(pred: np.ndarray, target: np.ndarray, mask: np.ndarray) -> dict:
    """IBIMS depth-edge accuracy/completeness (ref `metrics.py:171-205`).

    :param mask: (h, w) ground-truth EDGE map (not a validity mask).
    """
    from scipy import ndimage
    th_dir = 10
    pred_dir = np.where(pred <= th_dir, 1, 0)
    target_dir = np.where(target <= th_dir, 1, 0)
    err_dir = pred_dir - target_dir

    th_edges = 10
    D_target = ndimage.distance_transform_edt(1 - mask)

    pred_edges = extract_edges(pred, preprocess='log', sigma=1)
    D_pred = ndimage.distance_transform_edt(1 - pred_edges)
    pred_edges = pred_edges & (D_target < th_edges)

    return {
        'DirAcc': 100 * (err_dir == 0).mean(),
        'Dir (-)': 100 * (err_dir == 1).mean(),
        'Dir (+)': 100 * (err_dir == -1).mean(),
        'EdgeAcc': D_target[pred_edges].mean() if pred_edges.sum() else th_edges,
        'EdgeComp': D_pred[mask].mean() if pred_edges.sum() else th_edges,
    }
