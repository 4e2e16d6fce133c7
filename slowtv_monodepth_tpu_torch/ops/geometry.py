"""Camera geometry (PyTorch): depth conversions, pose and intrinsics math,
view synthesis.

Counterpart of `slowtv_monodepth_tpu/ops/geometry.py`: `to_scaled`,
`to_inv`, `blend_stereo` (serving), and `T_from_AAt`, `resize_K` and the
folded `view_synth` (training). View synthesis works on NHWC images and
depths, as in the JAX package, and samples through `ops.grid_sample` (the
warp kernel on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from .ops import clip, eps
from .sample import grid_sample

__all__ = ['to_scaled', 'to_inv', 'blend_stereo', 'T_from_AAt', 'resize_K',
           'view_synth']


def to_scaled(disp: torch.Tensor, min: float = 0.01,  # noqa: A002
              max: Optional[float] = 100):  # noqa: A002
    """Sigmoid disparity [0, 1] -> (scaled disparity, scaled depth).

    disp' = (1/min - 1/max) * disp + 1/max.
    """
    if min <= 0:
        raise ValueError(f'Min depth must be greater than 0. ({min})')
    if max and (max < min):
        raise ValueError(f'Max depth must be greater than min. ({max} vs. {min})')
    i_max, i_min = 1.0 / min, (1.0 / max) if max else 0.0
    disp = (i_max - i_min) * disp + i_min
    return disp, to_inv(disp)


def to_inv(depth: torch.Tensor) -> torch.Tensor:
    """Linear depth -> disparity, zeroed where depth <= 0."""
    eps = torch.finfo(depth.dtype).eps
    return (depth > 0) / depth.clamp(min=eps)


def blend_stereo(disp_l: torch.Tensor, disp_r: torch.Tensor) -> torch.Tensor:
    """Monodepth stereo blending of (*, h, w) maps (width last, NCHW).

    The 5% leftmost columns come from the right disparity, the 5% rightmost
    from the left one, with a linear ramp and the mean in between.
    """
    if disp_l.shape != disp_r.shape:
        raise ValueError(f'Non-matching shapes. ({disp_l.shape} vs. {disp_r.shape})')
    w = disp_l.shape[-1]
    x = torch.linspace(0.0, 1.0, w, dtype=disp_l.dtype, device=disp_l.device)
    mask_l = (20 * (x - 0.05)).clamp(0.0, 1.0)
    mask_r = mask_l.flip(0)
    mask_mu = 1.0 - mask_l - mask_r
    disp_mu = (disp_l + disp_r) / 2
    return mask_r * disp_l + mask_l * disp_r + mask_mu * disp_mu


def T_from_AAt(aa: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Axis-angle (*, 3) + translation (*, 3) -> (*, 4, 4) by Rodrigues."""
    if aa.shape[-1] != 3 or aa.shape != t.shape:
        raise ValueError(f'Incorrect shapes. ({aa.shape}, {t.shape} vs. (*, 3))')
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    axis = aa / clip(angle, lo=eps(angle))
    x, y, z = axis.unbind(-1)
    zr = torch.zeros_like(x)
    W = torch.stack([torch.stack([zr, -z, y], -1),
                     torch.stack([z, zr, -x], -1),
                     torch.stack([-y, x, zr], -1)], -2)  # (*, 3, 3) skew-symmetric
    angle = angle[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    R = eye + W * torch.sin(angle) + (W @ W) * (1 - torch.cos(angle))
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=aa.dtype,
                          device=aa.device).expand(aa.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


def resize_K(K: torch.Tensor, new_shape, shape=None) -> torch.Tensor:
    """Scale (*, 4, 4) intrinsics rows for a resize; shapes are (h, w)."""
    shape = shape or (1, 1)
    s = K.new_tensor([new_shape[1] / shape[1], new_shape[0] / shape[0], 1.0, 1.0])
    return K * s[:, None]


def view_synth(img: torch.Tensor, depth: torch.Tensor, T: torch.Tensor,
               K: torch.Tensor, K_inv: Optional[torch.Tensor] = None,
               kernels: bool = True):
    """Warp a support frame to the target frame given depth and pose.

    Backproject -> rigid transform -> project -> bilinear border sample, with
    the chain folded into per-batch 3x3 matrices (`ops/geometry.py:228`):
    for a pixel p = (x, y, 1), A = R K^-1, B = K A, u = K t,
    z = d A[2] p + t[2] and the projected pixel is (d B p + u) / max(z, 0.1).

    :param img: (b, h, w, c) support image (NHWC).
    :param depth: (b, h, w, 1) target-frame depth.
    :param T: (b, 4, 4) target -> support transform.
    :param K: (b, 4, 4) support intrinsics.
    :param K_inv: (b, 4, 4) target inverse intrinsics (default `inv(K)`).
    :param kernels: passed to `grid_sample`.
    :return: (warped (b, h, w, c), depth_warp (b, h, w, 1), valid (b, h, w, 1) bool).
    """
    if K_inv is None:
        K_inv = torch.linalg.inv(K)
    b, h, w = depth.shape[:3]
    A = T[:, :3, :3] @ K_inv[:, :3, :3]
    t = T[:, :3, 3]
    Bm = K[:, :3, :3] @ A
    u = (K[:, :3, :3] @ t[..., None])[..., 0]

    ys, xs = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device),
                            indexing='ij')
    d = depth[..., 0]

    def plane(M, row):  # a per-batch row of M, broadcast over (h, w)
        return (M[:, row, 0, None, None] * xs + M[:, row, 1, None, None] * ys
                + M[:, row, 2, None, None])

    z = d * plane(A, 2) + t[:, 2, None, None]
    depth_warp = clip(z, lo=eps(depth))
    cz = clip(z, lo=0.1)
    px = (d * plane(Bm, 0) + u[:, 0, None, None]) / cz
    py = (d * plane(Bm, 1) + u[:, 1, None, None]) / cz
    grid = torch.stack([(px / (w - 1) - 0.5) * 2, (py / (h - 1) - 0.5) * 2], -1)
    valid = (grid.abs() < 1).all(-1, keepdim=True)
    warped = grid_sample(img, grid, padding_mode='border', kernels=kernels)
    return warped, depth_warp[..., None], valid
