"""Differentiable bilinear grid sampling, NHWC (the `F.grid_sample` equivalent).

Counterpart of `slowtv_monodepth_tpu/ops/sample.py:grid_sample`, with its
semantics (`F.grid_sample(mode='bilinear', align_corners=False)`):
- `grid` holds normalized (x, y) coords in [-1, 1], shape (b, gh, gw, 2);
  pixel coord `p = ((g + 1) * size - 1) / 2`;
- border mode clamps the continuous coords to [0, size - 1] first, with
  `jnp.clip`'s VJP: half the gradient at a coordinate exactly on the bound
  (an identity warp puts coords exactly at 0 and w - 1), none outside;
- zeros mode drops the corners outside the image.

Border mode is the training hot path. It runs the warp as a
`torch.autograd.Function` that mirrors the JAX package's `custom_vjp`
(`sample.py:88-131`):
- forward: `warp_bilinear`, which returns the sample and its derivatives
  ddx, ddy w.r.t. the pixel coords in float32: the hand-written Hopper kernels
  of `csrc/warp.cu` on a CUDA tensor (TPU kernel 5 for a float32 source, the
  packed kernel 6 for a bfloat16 source), the plain version
  `warp_bilinear_plain` on a CPU tensor; any other dtype raises;
- backward: the coords' gradient is `(g * ddx).sum(-1)`, `(g * ddy).sum(-1)`;
  the image's is the 4-corner scatter-add (`index_add_`) in float32, cast to
  the image's dtype, computed only when the image requires grad (the
  photometric loss warps data, so never there).
Zeros mode is PyTorch's own `F.grid_sample` (the JAX package has no kernel
for it).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .. import _build
from .ops import clip

__all__ = ['border_coords', 'grid_sample', 'warp_bilinear', 'warp_bilinear_packed',
           'warp_bilinear_plain']


def _corners(h: int, w: int, fx: torch.Tensor, fy: torch.Tensor):
    """Flat corner indices (b, n) x 4 into an (h, w) image, fractional
    offsets (b, n, 1) x 2."""
    b = fx.shape[0]
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0f).reshape(b, -1, 1)
    wy = (fy - y0f).reshape(b, -1, 1)
    x0 = x0f.long().clamp(0, w - 1).reshape(b, -1)
    y0 = y0f.long().clamp(0, h - 1).reshape(b, -1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    return (y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1), wx, wy


def warp_bilinear_plain(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """Plain PyTorch version of `warp_bilinear` (gathers). A bfloat16 source
    widens (exactly) to the coords' dtype first, as in the packed kernel."""
    b, h, w, c = img.shape
    img = img.to(fx.dtype)
    flat = img.reshape(b, h * w, c)
    idx, wx, wy = _corners(h, w, fx, fy)
    v00, v01, v10, v11 = (torch.gather(flat, 1, i[..., None].expand(-1, -1, c))
                          for i in idx)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    ddx = (v01 - v00) * (1 - wy) + (v11 - v10) * wy
    ddy = bot - top
    shape = fx.shape + (c,)
    return out.reshape(shape), ddx.reshape(shape), ddy.reshape(shape)


def _check(img, fx, fy) -> None:
    if img.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'warp_bilinear runs on cpu or cuda, not {img.device}')
    if img.dim() != 4 or fx.dim() != 3 or fx.shape != fy.shape or fx.shape[0] != img.shape[0]:
        raise ValueError(f'img must be (b, h, w, c) and fx, fy (b, ho, wo), got '
                         f'{tuple(img.shape)}, {tuple(fx.shape)}, {tuple(fy.shape)}')
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'warp_bilinear takes a float32 or bfloat16 image, got {img.dtype}')
    for t in (img, fx, fy):
        if t is not img and t.dtype != torch.float32:
            raise TypeError(f'warp_bilinear takes float32 coords, got {t.dtype}')
        if t.device != img.device:
            raise ValueError(f'all tensors must be on {img.device}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('warp_bilinear takes contiguous tensors')


def warp_bilinear(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """Bilinear border sample and its derivatives w.r.t. the pixel coords.

    :param img: (b, h, w, c) float32 or bfloat16 source images, contiguous.
    :param fx, fy: (b, ho, wo) float32 continuous pixel coords, already
        clamped to [0, w-1] and [0, h-1].
    :return: (out, ddx, ddy), each (b, ho, wo, c) float32.

    On a CUDA tensor: kernel 5 for float32 (`csrc/warp.cu`), counted by
    `warp_bilinear.launches`, and the packed kernel 6 for bfloat16
    (`warp_bilinear_packed`, counted by `warp_bilinear_packed.launches`); on a
    CPU tensor: `warp_bilinear_plain`.
    """
    _check(img, fx, fy)
    if img.device.type == 'cpu':
        return warp_bilinear_plain(img, fx, fy)
    if img.dtype == torch.bfloat16:
        return warp_bilinear_packed(img, fx, fy)
    b, h, w, c = img.shape
    ho, wo = fx.shape[1:]
    out, ddx, ddy = (torch.empty((b, ho, wo, c), dtype=img.dtype, device=img.device)
                     for _ in range(3))
    if out.numel() == 0:
        return out, ddx, ddy
    err = _build.load().slowtv_warp_bilinear_f32(
        *(t.data_ptr() for t in (img, fx, fy, out, ddx, ddy)),
        b, h, w, c, ho, wo, img.device.index,
        torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(err, 'warp kernel')
    warp_bilinear.launches += 1
    return out, ddx, ddy


warp_bilinear.launches = 0


def warp_bilinear_packed(img: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """`warp_bilinear` on a bfloat16 CUDA source: kernel 6.

    The kernel (kernel 5's body on 16-bit source values) reads the source as
    it is, at any address, with no copy; it widens each value exactly and
    blends in float32.
    """
    _check(img, fx, fy)
    if img.device.type != 'cuda' or img.dtype != torch.bfloat16:
        raise TypeError(f'warp_bilinear_packed takes a bfloat16 CUDA image, got '
                        f'{img.dtype} on {img.device}')
    b, h, w, c = img.shape
    ho, wo = fx.shape[1:]
    out, ddx, ddy = (torch.empty((b, ho, wo, c), dtype=torch.float32, device=img.device)
                     for _ in range(3))
    if out.numel() == 0:
        return out, ddx, ddy
    err = _build.load().slowtv_warp_bilinear_packed_bf16(
        *(t.data_ptr() for t in (img, fx, fy, out, ddx, ddy)),
        b, h, w, c, ho, wo, img.device.index,
        torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(err, 'packed warp kernel')
    warp_bilinear_packed.launches += 1
    return out, ddx, ddy


warp_bilinear_packed.launches = 0


class _Warp(torch.autograd.Function):
    """`sample.py:_warp_pallas_core` with its custom VJP."""

    @staticmethod
    def forward(ctx, img, fx, fy, impl: Callable):
        out, ddx, ddy = impl(img, fx, fy)
        ctx.save_for_backward(fx, fy, ddx, ddy)
        ctx.img_shape, ctx.img_dtype = img.shape, img.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        fx, fy, ddx, ddy = ctx.saved_tensors
        gimg = None
        if ctx.needs_input_grad[0]:
            b, h, w, c = ctx.img_shape
            (i00, i01, i10, i11), wx, wy = _corners(h, w, fx, fy)
            gf = g.reshape(b, -1, c)
            base = (torch.arange(b, device=g.device) * (h * w))[:, None]
            flat = torch.zeros((b * h * w, c), dtype=g.dtype, device=g.device)
            for idx, wt in ((i00, (1 - wx) * (1 - wy)), (i01, wx * (1 - wy)),
                            (i10, (1 - wx) * wy), (i11, wx * wy)):
                flat.index_add_(0, (idx + base).reshape(-1), (gf * wt).reshape(-1, c))
            gimg = flat.reshape(ctx.img_shape).to(ctx.img_dtype)
        gfx = (g * ddx).sum(-1) if ctx.needs_input_grad[1] else None
        gfy = (g * ddy).sum(-1) if ctx.needs_input_grad[2] else None
        return gimg, gfx, gfy, None


def _unnormalize(g: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coords, align_corners=False convention."""
    return ((g + 1.0) * size - 1.0) / 2.0


def border_coords(grid: torch.Tensor, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized `grid` (b, gh, gw, 2) -> the contiguous pixel coords (fx, fy), each
    (b, gh, gw), clamped into an (h, w) image, that border mode hands to `warp_bilinear`."""
    fx = clip(_unnormalize(grid[..., 0], w), 0.0, w - 1.0).contiguous()
    fy = clip(_unnormalize(grid[..., 1], h), 0.0, h - 1.0).contiguous()
    return fx, fy


def grid_sample(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = 'border',
                kernels: bool = True) -> torch.Tensor:
    """Sample `img` (b, h, w, c) at `grid` (b, gh, gw, 2) -> (b, gh, gw, c).

    :param padding_mode: {'border', 'zeros'} out-of-image behaviour.
    :param kernels: border mode through `warp_bilinear` (the kernel on the
        card). False runs `warp_bilinear_plain` on any device: only for
        timing the plain path on the card.
    """
    if padding_mode not in ('border', 'zeros'):
        raise ValueError(f'Invalid padding_mode: {padding_mode}')
    h, w = img.shape[1:3]
    if padding_mode == 'zeros':
        out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode='bilinear',
                            padding_mode='zeros', align_corners=False)
        return out.permute(0, 2, 3, 1)
    fx, fy = border_coords(grid, h, w)
    return _Warp.apply(img.contiguous(), fx, fy,
                       warp_bilinear if kernels else warp_bilinear_plain)
