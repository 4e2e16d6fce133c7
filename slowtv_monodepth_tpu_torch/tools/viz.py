"""Visualization helpers for disparity maps and dense features.

Parity with `src/tools/viz.py:19-74`: turbo-colormapped disparity with a
95th-percentile vmax default, and batch-PCA feature RGB. Host-side numpy
(NHWC), matplotlib colormaps (imported lazily), numpy-SVD PCA (no sklearn
dependency). Copy of `slowtv_monodepth_tpu/tools/viz.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

__all__ = ['apply_cmap', 'rgb_from_disp']


def _get_percentile(x: np.ndarray, p: int) -> float:
    """Safe percentile handling empty/NaN inputs (ref `viz.py:14-17`)."""
    try:
        return float(np.percentile(x, p))
    except IndexError:
        return 0.0


def apply_cmap(x: np.ndarray, cmap: str = 'turbo', vmin: float = 0,
               vmax: Optional[float] = None) -> np.ndarray:
    """(h, w) scalar map -> (h, w, 3) float RGB via a matplotlib colormap."""
    import matplotlib
    x = np.asarray(x, np.float32)
    vmax = vmax if vmax is not None else (x.max() or 1.0)
    denom = (vmax - vmin) or 1.0
    xn = np.clip((x - vmin) / denom, 0, 1)
    return matplotlib.colormaps[cmap](xn)[..., :3].astype(np.float32)


def rgb_from_disp(disp: np.ndarray, invert: bool = False, cmap: str = 'turbo',
                  vmin: float = 0,
                  vmax: Optional[Union[float, Sequence[float]]] = None) -> np.ndarray:
    """Colormap a (batch of) disparity/depth map(s) (ref `viz.py:19-50`).

    :param disp: (h, w) | (b, h, w) | (b, h, w, 1) disparity (NHWC).
    :param invert: If True, convert depth into disparity first.
    :param vmax: None -> per-item 95th percentile of positive values.
    :return: (*, h, w, 3) float RGB.
    """
    disp = np.asarray(disp, np.float32)
    n = disp.ndim
    if n == 2:
        disp = disp[None]
    if disp.ndim == 4:
        disp = disp[..., 0]

    if invert:
        disp = (disp > 0) / np.maximum(disp, np.finfo(np.float32).tiny)

    if vmax is None:
        vmax = [_get_percentile(d[d > 0], 95) for d in disp]
    elif isinstance(vmax, (int, float)):
        vmax = [vmax] * disp.shape[0]
    elif len(vmax) != disp.shape[0]:
        raise ValueError(f'Non-matching vmax and disp. ({len(vmax)} vs. {disp.shape[0]})')

    rgb = np.stack([apply_cmap(d, cmap=cmap, vmin=vmin, vmax=v)
                    for d, v in zip(disp, vmax)])
    return rgb[0] if n == 2 else rgb
