"""Depth-edge extraction (host-side numpy/scipy).

Copy of `slowtv_monodepth_tpu/eval/edges.py`: the reference's `extract_edges`
(`src/tools/geometry.py:23-59`) without scikit-image: a Canny detector
(gaussian smoothing with masked normalization, Sobel gradients, interpolated
non-maximum suppression, hysteresis with skimage's default absolute thresholds
low=0.1/high=0.2) plus the Sobel fallback used when `use_canny=False`. The
fallback's `cv2.GaussianBlur` (3x3, float32) and `cv2.Sobel` (5x5, float64)
are separable `scipy.ndimage` correlations with OpenCV's kernels and its
default border, BORDER_REFLECT_101 (scipy's 'mirror'): the card's machine
has no cv2. scipy is imported inside the functions that use it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ['canny', 'extract_edges']


def _smooth_with_mask(image: np.ndarray, sigma: float, mask: np.ndarray):
    """Gaussian smoothing that avoids bleeding values across the mask edge."""
    from scipy import ndimage as ndi
    masked = image * mask
    smoothed = ndi.gaussian_filter(masked, sigma, mode='constant')
    norm = ndi.gaussian_filter(mask.astype(image.dtype), sigma, mode='constant')
    norm = np.where(norm == 0, 1.0, norm)
    smoothed /= norm
    # Erode the mask so NMS never reads garbage across its border.
    s = ndi.generate_binary_structure(2, 2)
    eroded = ndi.binary_erosion(mask, s, border_value=0)
    return smoothed, eroded


def canny(image: np.ndarray,
          sigma: float = 1.0,
          low_threshold: float = 0.1,
          high_threshold: float = 0.2,
          mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Canny edge detection on a float image.

    :param image: (h, w) Float image.
    :param sigma: Gaussian smoothing sigma.
    :param low_threshold: Hysteresis low threshold on gradient magnitude.
    :param high_threshold: Hysteresis high threshold on gradient magnitude.
    :param mask: (h, w) Optional bool mask of valid pixels.
    :return: (h, w) Boolean edge map.
    """
    from scipy import ndimage as ndi
    image = np.asarray(image, dtype=np.float64)
    if mask is None:
        mask = np.ones(image.shape, dtype=bool)

    smoothed, eroded_mask = _smooth_with_mask(image, sigma, mask)

    gy = ndi.sobel(smoothed, axis=0)
    gx = ndi.sobel(smoothed, axis=1)
    magnitude = np.hypot(gx, gy)

    # Interpolated non-maximum suppression along the gradient direction.
    abs_x, abs_y = np.abs(gx), np.abs(gy)
    eroded_mask = eroded_mask & (magnitude > 0)

    # Interpolated NMS: for each of 4 direction cases, the neighbor magnitude
    # is w*diag + (1-w)*axis with w = min/max slope ratio.
    def _shift(a, dy, dx):
        out = np.zeros_like(a)
        h, w = a.shape
        ys = slice(max(dy, 0), h + min(dy, 0))
        xs = slice(max(dx, 0), w + min(dx, 0))
        ys_src = slice(max(-dy, 0), h + min(-dy, 0))
        xs_src = slice(max(-dx, 0), w + min(-dx, 0))
        out[ys, xs] = a[ys_src, xs_src]
        return out

    m_e = _shift(magnitude, 0, 1)
    m_w = _shift(magnitude, 0, -1)
    m_n = _shift(magnitude, -1, 0)
    m_s = _shift(magnitude, 1, 0)
    m_ne = _shift(magnitude, -1, 1)
    m_nw = _shift(magnitude, -1, -1)
    m_se = _shift(magnitude, 1, 1)
    m_sw = _shift(magnitude, 1, -1)

    with np.errstate(divide='ignore', invalid='ignore'):
        # Case 1: gradient mostly horizontal, same signs -> SE/NW diagonal.
        horiz = abs_x >= abs_y
        vert = ~horiz
        same = (gx * gy) >= 0
        w_h = np.where(abs_x > 0, abs_y / np.maximum(abs_x, 1e-30), 0.0)
        w_v = np.where(abs_y > 0, abs_x / np.maximum(abs_y, 1e-30), 0.0)

        # same sign, |gx|>=|gy|: neighbors (E,SE) and (W,NW)
        n1 = w_h * m_se + (1 - w_h) * m_e
        n2 = w_h * m_nw + (1 - w_h) * m_w
        c1 = horiz & same & (magnitude >= n1) & (magnitude >= n2)

        # same sign, |gy|>|gx|: neighbors (S,SE) and (N,NW)
        n1 = w_v * m_se + (1 - w_v) * m_s
        n2 = w_v * m_nw + (1 - w_v) * m_n
        c2 = vert & same & (magnitude >= n1) & (magnitude >= n2)

        # opposite sign, |gx|>=|gy|: neighbors (E,NE) and (W,SW)
        n1 = w_h * m_ne + (1 - w_h) * m_e
        n2 = w_h * m_sw + (1 - w_h) * m_w
        c3 = horiz & ~same & (magnitude >= n1) & (magnitude >= n2)

        # opposite sign, |gy|>|gx|: neighbors (N,NE) and (S,SW)
        n1 = w_v * m_ne + (1 - w_v) * m_n
        n2 = w_v * m_sw + (1 - w_v) * m_s
        c4 = vert & ~same & (magnitude >= n1) & (magnitude >= n2)

    local_maxima = (c1 | c2 | c3 | c4) & eroded_mask

    # Hysteresis thresholding.
    high = local_maxima & (magnitude >= high_threshold)
    low = local_maxima & (magnitude >= low_threshold)
    labels, n = ndi.label(low, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros(image.shape, bool)
    keep = np.zeros(n + 1, bool)
    keep[np.unique(labels[high])] = True
    keep[0] = False
    return keep[labels]


# OpenCV's 5-tap Sobel: the derivative and the smoothing kernel (getDerivKernels, ksize=5).
_SOBEL5_D = np.array([-1, -2, 0, 2, 1], np.float64)
_SOBEL5_S = np.array([1, 4, 6, 4, 1], np.float64)


def _gaussian_kernel3(sigma: float) -> np.ndarray:
    """OpenCV's `getGaussianKernel(3, sigma, CV_32F)`: exp(-x^2 / (2 sigma^2)) for
    x = -1, 0, 1 in double, normalized, rounded to float32."""
    k = np.exp(-0.5 / (sigma * sigma) * np.array([1.0, 0.0, 1.0]))
    return (k / k.sum()).astype(np.float32)


def _gaussian_blur3(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (3, 3), sigma, sigma)` on float32, with OpenCV's
    rounding: rows, then columns; each a symmetric 3-tap sum with one fused
    multiply-add (a product of two float32 is exact in double)."""
    k0, k1 = (float(v) for v in _gaussian_kernel3(sigma)[:2])
    f32 = np.float32

    def taps(a, axis):
        n = a.shape[axis]
        a = np.concatenate([np.take(a, [1], axis), a, np.take(a, [n - 2], axis)], axis)
        return (np.take(a, range(0, n), axis), np.take(a, range(1, n + 1), axis),
                np.take(a, range(2, n + 2), axis))

    s0, s1, s2 = taps(img.astype(f32), axis=1)  # fma(s1, k1, (s0 + s2) k0)
    rows = (s1.astype(np.float64) * k1 + f32((s0 + s2) * f32(k0))).astype(f32)
    s0, s1, s2 = taps(rows, axis=0)             # fma(s0 + s2, k0, s1 k1)
    return ((s0 + s2).astype(np.float64) * k0 + f32(s1 * f32(k1))).astype(f32)


def _sobel5(img: np.ndarray, axis: int) -> np.ndarray:
    """`cv2.Sobel(img, cv2.CV_64F, ksize=5)` along `axis` (1: dx, 0: dy)."""
    from scipy import ndimage as ndi
    img = img.astype(np.float64)
    out = ndi.correlate1d(img, _SOBEL5_D, axis=axis, mode='mirror')
    return ndi.correlate1d(out, _SOBEL5_S, axis=1 - axis, mode='mirror')


def extract_edges(depth: np.ndarray,
                  preprocess: Optional[str] = None,
                  sigma: float = 1,
                  mask: Optional[np.ndarray] = None,
                  use_canny: bool = True) -> np.ndarray:
    """Detect edges in a dense depth map (ref `geometry.py:23-59`).

    :param depth: (h, w[, 1]) Dense depth map.
    :param preprocess: Depth preprocessing {'log', 'inv', 'none', None}.
    :param sigma: Gaussian blurring sigma.
    :param mask: Optional bool mask of valid pixels.
    :param use_canny: If True use Canny, else thresholded Sobel magnitude.
    :return: (h, w) Boolean edge map.
    """
    if preprocess not in {'log', 'inv', 'none', None}:
        raise ValueError(f'Invalid depth preprocessing. ({preprocess})')

    depth = np.squeeze(np.asarray(depth)).astype(np.float64)
    if preprocess == 'log':
        d = np.where(depth > 0, np.clip(depth, np.finfo(np.float64).eps, None), 1.0)
        depth = np.where(depth > 0, np.log(d), 0.0)
    elif preprocess == 'inv':
        d = np.where(depth > 0, np.clip(depth, np.finfo(np.float64).eps, None), 1.0)
        depth = np.where(depth > 0, 1.0 / d, 0.0)
        depth -= depth.min()
        depth /= max(depth.max(), np.finfo(np.float64).eps)

    if use_canny:
        return canny(depth, sigma=sigma, mask=mask)

    blurred = _gaussian_blur3(depth.astype(np.float32), sigma)
    dx = _sobel5(blurred, axis=1)
    dy = _sobel5(blurred, axis=0)
    edges = np.sqrt(dx**2 + dy**2)
    edges = edges > edges.mean()
    if mask is not None:
        edges &= mask
    return edges
