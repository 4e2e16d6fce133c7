"""Aligning scaleless predictions to metric ground truth.

Counterpart of the JAX package's `api/quickstart/align.py`: median depth
scaling, and MiDaS-style least-squares alignment computed in DISPARITY
space, as `eval.MonoDepthEvaluator` aligns (whose `_align_lsqr` this calls).

    python -m slowtv_monodepth_tpu_torch.align pred_depth.npy lidar_depth.npy [--out aligned.npy]
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np

from .eval.evaluator import MonoDepthEvaluator

__all__ = ['align_median', 'align_lsqr', 'to_inv', 'main']


def align_median(pred: np.ndarray, target: np.ndarray) -> float:
    """Scale factor for median-depth alignment."""
    return float(np.median(target) / np.median(pred))


def align_lsqr(pred: np.ndarray, target: np.ndarray):
    """Scale & shift for least-squares alignment (with singular guard)."""
    return MonoDepthEvaluator._align_lsqr(pred, target)


def to_inv(depth: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    return (depth > 0) / (depth + eps)


def main(depth_file, lidar_file, out_file: Optional[Path] = None):
    """A predicted depth map and a metric LiDAR map, (h, w) `.npy` files ->
    (aligned depth, its valid pixels): the median scale, then the lsqr fit in
    disparity space."""
    depth = np.load(depth_file)  # (h, w) predicted depth.
    lidar = np.load(lidar_file)  # (h, w) metric GT.
    valid = (lidar > 0) & (lidar < 100)
    depth_mask, lidar_mask = depth[valid], lidar[valid]

    # Median alignment.
    scale = align_median(depth_mask, lidar_mask)
    depth, depth_mask = depth * scale, depth_mask * scale

    # Least-squares alignment happens in disparity space, not depth.
    disp, disp_mask = to_inv(depth), to_inv(depth_mask)
    scale, shift = align_lsqr(disp_mask, to_inv(lidar_mask))
    disp, disp_mask = disp * scale + shift, disp_mask * scale + shift
    depth, depth_mask = to_inv(disp), to_inv(disp_mask)
    if out_file is not None:
        np.save(out_file, depth)
    return depth, depth_mask


def _cli() -> None:
    parser = ArgumentParser(description='Align a predicted depth map to metric LiDAR depth.')
    parser.add_argument('depth_file', type=Path)
    parser.add_argument('lidar_file', type=Path)
    parser.add_argument('--out', default=None, type=Path)
    args = parser.parse_args()
    main(args.depth_file, args.lidar_file, args.out)


if __name__ == '__main__':
    _cli()
