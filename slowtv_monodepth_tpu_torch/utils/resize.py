"""2-D float32 resizing with OpenCV's `cv2.resize` semantics, in numpy.

The evaluator upsamples each prediction to its target's shape, and the
published numbers were made with `cv2.resize` (`INTER_NEAREST`,
`INTER_LINEAR`, `INTER_CUBIC`). Neither `torch.nn.functional.interpolate` nor
the port's `ops.resize` compute the same source coordinates and weights, and
the card's machine has no cv2, so this restates what OpenCV computes for a
float32 image:

- nearest: source index `floor(d * (1 / (dst / src)))` in double, clamped to
  the last pixel; bitwise OpenCV's;
- bilinear and bicubic: source coordinate `(d + 0.5) * scale - 0.5` with
  `scale = 1 / (dst / src)`, in double; its floor is the first tap and the
  fraction `t` the weight; the horizontal pass first, on every source row,
  then the vertical pass;
- bilinear: `a + (b - a) * t` per pass, `b - a` and `t` in float32 and one
  fused multiply-add, a coordinate outside the image clamped to the border
  pixel (bitwise OpenCV's on the shapes the tests hold it to);
- bicubic: Keys' cubic with A = -0.75 in double, each of the four taps
  clamped to the image, each pass summed in double and rounded to float32
  (within 3 float32 ulps of the source's largest value of OpenCV's: its
  sums are not restated to the bit).
"""
from __future__ import annotations

import numpy as np

__all__ = ['resize', 'nearest_index']

_A = -0.75


def nearest_index(src: int, dst: int) -> np.ndarray:
    """(dst,) source indices of OpenCV's `INTER_NEAREST` along one axis."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst, dtype=np.float64) * inv).astype(np.int64), src - 1)


def _coords(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(first tap, fraction) per output index, in double."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
    s = np.floor(f)
    return s.astype(np.int64), f - s


def _linear_pass(img: np.ndarray, src: int, dst: int, axis: int) -> np.ndarray:
    s, t = _coords(src, dst)
    out = (s < 0) | (s >= src - 1)
    t[out] = 0
    s = np.clip(s, 0, src - 1)
    a = np.take(img, s, axis=axis)
    b = np.take(img, np.minimum(s + 1, src - 1), axis=axis)
    t = t.astype(np.float32).astype(np.float64)
    if axis == 0:
        t = t[:, None]
    # fma(b - a, t, a): the float32 product is exact in double
    return (a.astype(np.float64) + (b - a).astype(np.float64) * t).astype(np.float32)


def _cubic_pass(img: np.ndarray, src: int, dst: int, axis: int) -> np.ndarray:
    s, x = _coords(src, dst)
    w0 = ((_A * (x + 1) - 5 * _A) * (x + 1) + 8 * _A) * (x + 1) - 4 * _A
    w1 = ((_A + 2) * x - (_A + 3)) * x * x + 1
    w2 = ((_A + 2) * (1 - x) - (_A + 3)) * (1 - x) * (1 - x) + 1
    w = np.stack([w0, w1, w2, 1 - w0 - w1 - w2], axis=1)
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, src - 1)
    out = 0.0
    for k in range(4):
        wk = w[:, k] if axis == 1 else w[:, k, None]
        out = out + np.take(img, idx[:, k], axis=axis).astype(np.float64) * wk
    return out.astype(np.float32)


def resize(img: np.ndarray, shape: tuple, mode: str = 'bilinear') -> np.ndarray:
    """(h, w) float image -> (H, W) float32, as `cv2.resize(img, (W, H),
    interpolation=...)` computes it. `mode` is 'nearest', 'bilinear' or 'bicubic'."""
    img = np.asarray(img)
    (h, w), (H, W) = img.shape[:2], tuple(int(s) for s in shape)
    if mode == 'nearest':
        return img[nearest_index(h, H)[:, None], nearest_index(w, W)[None, :]]
    step = {'bilinear': _linear_pass, 'bicubic': _cubic_pass}[mode]
    rows = step(img.astype(np.float32, copy=False), w, W, axis=1)  # every source row
    return step(rows, h, H, axis=0)
