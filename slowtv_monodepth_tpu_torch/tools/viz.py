"""Visualization helpers for disparity maps and dense features.

Parity with `src/tools/viz.py:19-74`: turbo-colormapped disparity with a
95th-percentile vmax default, and batch-PCA feature RGB. Host-side numpy
(NHWC), numpy-SVD PCA (no sklearn dependency). Copy of
`slowtv_monodepth_tpu/tools/viz.py`, except that the 'turbo' map (the only
one the image logger uses) is looked up in the package's own copy of
matplotlib's table (`turbo.npy`, 256 RGB rows), as matplotlib's
`ListedColormap` looks it up: the card's machine has no matplotlib. Other
maps go through matplotlib, imported when asked for.
"""
from __future__ import annotations

from functools import cache
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ['apply_cmap', 'rgb_from_disp', 'rgb_from_feat']


@cache
def _turbo() -> np.ndarray:
    """matplotlib's 'turbo' lookup table as `ListedColormap` holds it: the 256
    RGB rows, then under (the first), over (the last) and bad (black)."""
    rgb = np.load(Path(__file__).with_name('turbo.npy'))
    return np.concatenate([rgb, rgb[:1], rgb[-1:], np.zeros((1, 3))])


def _lookup(xn: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """`matplotlib.colors.Colormap.__call__` on floats, RGB only."""
    n = len(lut) - 3
    xa = np.array(xn, copy=True)
    xa *= n
    xa[xa == n] = n - 1  # 1.0 is the last colour, not "over"
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid='ignore'):
        xa = xa.astype(int)
    xa[under], xa[over], xa[bad] = n, n + 1, n + 2
    return lut.take(xa, axis=0, mode='clip')


def _get_percentile(x: np.ndarray, p: int) -> float:
    """Safe percentile handling empty/NaN inputs (ref `viz.py:14-17`)."""
    try:
        return float(np.percentile(x, p))
    except IndexError:
        return 0.0


def apply_cmap(x: np.ndarray, cmap: str = 'turbo', vmin: float = 0,
               vmax: Optional[float] = None) -> np.ndarray:
    """(h, w) scalar map -> (h, w, 3) float RGB via a matplotlib colormap."""
    x = np.asarray(x, np.float32)
    vmax = vmax if vmax is not None else (x.max() or 1.0)
    denom = (vmax - vmin) or 1.0
    xn = np.clip((x - vmin) / denom, 0, 1)
    if cmap == 'turbo':
        return _lookup(xn, _turbo()).astype(np.float32)
    import matplotlib
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


def rgb_from_feat(feat: np.ndarray) -> np.ndarray:
    """Batch-PCA dense features to RGB (ref `viz.py:53-74`).

    NOTE: PCA is fit on ALL features in the batch, so colors are
    batch-dependent (matching the reference).

    :param feat: (b, h, w, c) | (h, w, c) dense features (NHWC).
    :return: (*, h, w, 3) float RGB in [0, 1].
    """
    feat = np.asarray(feat, np.float32)
    n = feat.ndim
    if n == 3:
        feat = feat[None]
    b, h, w, c = feat.shape
    flat = feat.reshape(-1, c)

    mu = flat.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(flat - mu, full_matrices=False)
    proj = (flat - mu) @ vt[:3].T  # (n, 3)

    proj -= proj.min(0)
    proj /= np.where(proj.max(0) == 0, 1, proj.max(0))
    proj = proj.reshape(b, h, w, 3)
    return proj[0] if n == 3 else proj
