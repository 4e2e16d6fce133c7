"""Fused SSIM + L1 photometric error with its analytic VJP, NHWC.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_photo.py:photo_err_ssim`:
per pixel, `mean_c(w_ssim * S + (1 - w_ssim) * |x - y|)`, with S the SSIM
error `clip((1 - N / D) / 2, 0, 1)` over 3x3 reflect-padded mean pools
(c1 = 0.01^2, c2 = 0.03^2), as `losses/photometric.py:PhotoError` computes
it.

`photo_err_ssim` is a `torch.autograd.Function` over two wrappers:
- `photo_fwd`: the error map. On a CUDA tensor the hand-written Hopper
  kernel of `csrc/photo.cu` (TPU kernel 7: one launch, tiles of 6 rows x 128
  columns x all channels, at most 4, each window's statistics computed once);
  on a CPU tensor its plain version `photo_fwd_plain`.
- `photo_bwd`: the VJP (dx, dy) for a cotangent of the map. On a CUDA
  tensor the kernel of `csrc/photo_bwd.cu` (TPU kernel 8: one launch, tiles
  of `bwd_plan`'s height x 62 columns x all channels, at most 4, each pooled
  position's statistics computed once); on a CPU tensor `photo_bwd_plain`,
  which differentiates `photo_fwd_plain`.
The clip's VJP is `jnp.clip`'s: 0.5 at an exact tie (x == y over a 3x3
patch gives S == 0 exactly), as the TPU kernel's mask; the L1 term's is
sign(x - y), 0 at a tie.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from .. import _build
from .dwconv import _sm_count
from .ops import clip

__all__ = ['avg_pool3x3_reflect', 'ssim_error', 'photo_err_ssim', 'photo_fwd',
           'photo_bwd', 'photo_fwd_plain', 'photo_bwd_plain', 'bwd_plan', 'bwd_tiles']

C1 = 0.01 ** 2
C2 = 0.03 ** 2

# Kernel 8's tiles (csrc/photo_bwd.cu): 62 output columns (64 pooled with the
# halo) x all channels, `bwd_plan`'s rows; 64 C threads, one a pooled float
# column, so at most 4 channels; the adjoint's vertical sums kept 2 rows at
# a time (its kChunk).
BWD_TILE_W = 62
BWD_ROWS = (16, 4)
BWD_CHUNK = 2
MAX_CHANNELS = 4


def avg_pool3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean pool with reflect padding, NHWC."""
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode='reflect')
    return F.avg_pool2d(x, 3, stride=1).permute(0, 2, 3, 1)


def ssim_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-channel SSIM error (b, h, w, c), `losses/photometric.py:SSIMError`."""
    mu_x, mu_y = avg_pool3x3_reflect(x), avg_pool3x3_reflect(y)
    sig_x = avg_pool3x3_reflect(x * x) - mu_x * mu_x
    sig_y = avg_pool3x3_reflect(y * y) - mu_y * mu_y
    sig_xy = avg_pool3x3_reflect(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sig_xy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sig_x + sig_y + C2)
    return clip((1 - num / den) / 2, 0.0, 1.0)


def photo_fwd_plain(x: torch.Tensor, y: torch.Tensor, w_ssim: float) -> torch.Tensor:
    """Plain PyTorch version of `photo_fwd`: (m, h, w, c) x 2 -> (m, h, w)."""
    err = w_ssim * ssim_error(x, y) + (1 - w_ssim) * (x - y).abs()
    return err.mean(-1)


def photo_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    w_ssim: float):
    """Plain PyTorch version of `photo_bwd`: autograd through `photo_fwd_plain`."""
    with torch.enable_grad():
        x, y = x.detach().requires_grad_(), y.detach().requires_grad_()
        return torch.autograd.grad(photo_fwd_plain(x, y, w_ssim), (x, y), g)


def smem_bytes(rows: int, c: int) -> int:
    """Shared memory of one kernel-8 block, a tile `rows` high of c channels:
    x and y staged with a 2-pixel halo (66 c floats a row, 16-byte aligned, +3
    for the shift), a chunk of the adjoint's four vertical sums (up to
    `BWD_CHUNK` rows x 64 c) and g on the 1-pixel halo
    (`slowtv_photo_bwd_smem_bytes`)."""
    row = (66 * c + 6) // 4 * 4
    chunk = min(rows, BWD_CHUNK)
    return 4 * (2 * (rows + 4) * row + 4 * chunk * 64 * c + (rows + 2) * 64)


def bwd_tiles(m: int, h: int, w: int, rows: int) -> tuple[int, int, int]:
    """(row tiles, column tiles, blocks) of kernel 8 on (m, h, w) images."""
    rt, ct = -(-h // rows), -(-w // BWD_TILE_W)
    return rt, ct, m * rt * ct


def _check_channels(c: int, what: str) -> None:
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f'{what} takes 1 to {MAX_CHANNELS} channels on the card, got {c}')


@functools.lru_cache(maxsize=256)
def bwd_plan(m: int, h: int, w: int, c: int, sms: int) -> int:
    """Kernel 8's tile height on a card of `sms` SMs: 16 rows where that gives
    every SM five blocks (as many as fit it; a taller tile recomputes less of
    its 2-row halo), else 4."""
    _check_channels(c, 'photo_bwd')
    return next((r for r in BWD_ROWS if bwd_tiles(m, h, w, r)[2] >= 5 * sms), BWD_ROWS[-1])


def _check(*ts: torch.Tensor) -> None:
    x = ts[0]
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'photo kernels run on cpu or cuda, not {x.device}')
    if x.dim() != 4 or ts[1].shape != x.shape:
        raise ValueError(f'x and y must be one (m, h, w, c) shape, got '
                         f'{tuple(x.shape)}, {tuple(ts[1].shape)}')
    m, h, w, _ = x.shape
    if h < 2 or w < 2 or m > 65535:
        raise ValueError(f'reflect padding needs h, w >= 2 (and m <= 65535), got '
                         f'{tuple(x.shape)}')
    if len(ts) > 2 and ts[2].shape != x.shape[:3]:
        raise ValueError(f'g must be {tuple(x.shape[:3])}, got {tuple(ts[2].shape)}')
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f'photo kernels take float32, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'all tensors must be on {x.device}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('photo kernels take contiguous NHWC tensors')


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def photo_fwd(x: torch.Tensor, y: torch.Tensor, w_ssim: float) -> torch.Tensor:
    """Photometric error map (m, h, w) of (m, h, w, c) float32 x, y.

    Kernel 7 on a CUDA tensor (1 to 4 channels), counted by
    `photo_fwd.launches`; `photo_fwd_plain` on a CPU tensor.
    """
    _check(x, y)
    if x.device.type == 'cpu':
        return photo_fwd_plain(x, y, w_ssim)
    m, h, w, c = x.shape
    _check_channels(c, 'photo_fwd')
    out = torch.empty((m, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.load().slowtv_photo_fwd_f32(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), m, h, w, c,
        float(w_ssim), float(1 - w_ssim), x.device.index, _stream(x))
    _build.check(err, 'photo forward kernel')
    photo_fwd.launches += 1
    return out


photo_fwd.launches = 0


def photo_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, w_ssim: float):
    """VJP of `photo_fwd` for a cotangent g (m, h, w) -> (dx, dy), (m, h, w, c).

    Kernel 8 on a CUDA tensor (tiles of `bwd_plan`; 1 to 4 channels),
    counted by `photo_bwd.launches`; `photo_bwd_plain` on a CPU tensor.
    """
    _check(x, y, g)
    if x.device.type == 'cpu':
        return photo_bwd_plain(x, y, g, w_ssim)
    m, h, w, c = x.shape
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    if x.numel() == 0:
        return dx, dy
    rows = bwd_plan(m, h, w, c, _sm_count(x.device.index))
    err = _build.load().slowtv_photo_bwd_f32(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        m, h, w, c, float(w_ssim / c), float((1 - w_ssim) / c), rows, x.device.index,
        _stream(x))
    _build.check(err, 'photo backward kernel')
    photo_bwd.launches += 1
    return dx, dy


photo_bwd.launches = 0


class _Photo(torch.autograd.Function):
    """`pallas_photo.py:_photo_core` with its custom VJP."""

    @staticmethod
    def forward(ctx, x, y, w_ssim: float, fwd: Callable, bwd: Callable):
        ctx.save_for_backward(x, y)
        ctx.w_ssim, ctx.bwd = w_ssim, bwd
        return fwd(x, y, w_ssim)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx, dy = ctx.bwd(x, y, g.contiguous(), ctx.w_ssim)
        return dx, dy, None, None, None


def photo_err_ssim(pred: torch.Tensor, target: torch.Tensor, w_ssim: float = 0.85,
                   kernels: bool = True) -> torch.Tensor:
    """Fused per-pixel photometric error (w_ssim * SSIM + (1 - w_ssim) * L1).

    :param pred: (m, h, w, c) float32 warped support frames.
    :param target: (m, h, w, c) float32 target images.
    :param kernels: through `photo_fwd` / `photo_bwd` (the kernels on the
        card). False runs the plain versions on any device: only for timing
        the plain path on the card.
    :return: (m, h, w, 1) channel-mean photometric error.
    """
    impl = (photo_fwd, photo_bwd) if kernels else (photo_fwd_plain, photo_bwd_plain)
    out = _Photo.apply(pred.contiguous(), target.contiguous(), float(w_ssim), *impl)
    return out[..., None]
