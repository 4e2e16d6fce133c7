"""Depthwise KxK convolution (stride 1, zero 'SAME' padding), NHWC, with its VJP.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_dwconv.py:depthwise_conv` and
its `custom_vjp` (`_dwconv_core_bwd`). `depthwise_conv` is a
`torch.autograd.Function`:
- forward: on a CUDA tensor the hand-written Hopper kernel `csrc/dwconv.cu`
  (bias fused); on a CPU tensor the plain PyTorch version
  `depthwise_conv_plain`, which the tests compare with the JAX package;
- backward: `dx` is the same forward run on the cotangent with the taps
  flipped and no bias; `dw` is `dwconv_dw` (the tap-gradient kernel on the
  card, `dwconv_dw_plain` on the CPU); `db = g.sum((0, 1, 2))`, which the
  JAX package also leaves to the compiler.
There is no other path: any other device, or a tensor a kernel does not
take, raises.

Activations are NHWC, as in the JAX package (`x.permute(0, 2, 3, 1)` of a
channels-last NCHW tensor is a free, contiguous view); the taps keep
PyTorch's `nn.Conv2d(groups=C)` layout (C, 1, K, K).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ['depthwise_conv', 'depthwise_conv_plain', 'dwconv_dw', 'dwconv_dw_plain']

_LANES = 32      # channels per block (csrc/dwconv.cu kLanes)
_DW_COLS = 20    # tap-gradient tile width (kDwCols)
_DW_ROWS = 12    # tallest tap-gradient tile, in output rows
_DW_MAX_CLUSTER = 8  # blocks per cluster at most (kDwMaxCluster)
_DW_PARTIALS = 0.1   # partial bytes at most ~this share of x's and g's


def _check(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> int:
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'depthwise_conv runs on cpu or cuda, not {x.device}')
    if x.dim() != 4:
        raise ValueError(f'x must be (b, h, w, c), got {tuple(x.shape)}')
    c = x.shape[-1]
    k = weight.shape[-1]
    if weight.shape != (c, 1, k, k):
        raise ValueError(f'weight must be ({c}, 1, k, k), got {tuple(weight.shape)}')
    if k % 2 != 1 or k > 9:
        raise ValueError(f'kernel size must be odd and <= 9, got {k}')
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if bias is not None and bias.shape != (c,):
        raise ValueError(f'bias must be ({c},), got {tuple(bias.shape)}')
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'depthwise_conv takes float32, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'all tensors must be on {x.device}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('depthwise_conv takes contiguous tensors '
                             '(x as NHWC, weight as (C, 1, K, K))')
    return k


def depthwise_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: a grouped `F.conv2d` on the NCHW view."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                   padding=weight.shape[-1] // 2, groups=x.shape[-1])
    return out.permute(0, 2, 3, 1).contiguous()


def _forward(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel 1 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == 'cpu':
        return depthwise_conv_plain(x, weight, bias)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    err = _build.load().slowtv_dwconv_fwd_f32(
        x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, h, w, c, weight.shape[-1], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'dwconv kernel')
    depthwise_conv.launches += 1
    return out


class _DepthwiseConv(torch.autograd.Function):
    """`pallas_dwconv.py:_dwconv_core` with its custom VJP, plus the bias."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return _forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _forward(g, weight.flip((-2, -1)).contiguous(), None)
        if ctx.needs_input_grad[1]:
            dw = dwconv_dw(x, g, weight.shape[-1])
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dw, db


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 'SAME' depthwise conv, differentiable in x, weight and bias.

    :param x: (b, h, w, c) float32 NHWC, contiguous.
    :param weight: (c, 1, k, k) taps, odd k <= 9.
    :param bias: optional (c,).
    :return: (b, h, w, c) contiguous.

    `depthwise_conv.launches` counts the launches of the forward kernel on
    the card: one per forward, one more per input gradient.
    """
    _check(x, weight, bias)
    return _DepthwiseConv.apply(x, weight, bias)


depthwise_conv.launches = 0


def dwconv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the tap gradient: (b, h, w, c) x 2 -> (c, 1, k, k)."""
    c = x.shape[-1]
    return torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (c, 1, k, k),
                                       g.permute(0, 3, 1, 2), padding=k // 2, groups=c)


def dw_split(b: int, h: int, w: int, c: int, k: int, rows: int,
             sms: int) -> tuple[int, int]:
    """Blocks per 32-channel group and blocks per cluster for tiles of `rows`
    rows: see `dw_plan`."""
    tiles = b * -(-h // rows) * -(-w // _DW_COLS)
    per_block = -(-tiles * -(-c // _LANES) // sms)
    splits = -(-tiles // per_block)
    parts = max(1, int(2 * _DW_PARTIALS * b * h * w / (k * k)))
    sizes = [d for d in range(1, _DW_MAX_CLUSTER + 1) if splits % d == 0]
    return splits, next((d for d in sizes if splits // d <= parts), sizes[-1])


@functools.lru_cache(maxsize=256)
def dw_plan(b: int, h: int, w: int, c: int, k: int, sms: int) -> tuple[int, int, int]:
    """The tap gradient's plan on a card of `sms` SMs: (rows per tile, blocks
    per 32-channel group, blocks per cluster).

    Tiles are bands of equal height (at most `_DW_ROWS`) by `_DW_COLS`
    columns of one image; a block walks a run of them down its strips. The
    blocks fill one wave of one block per SM (a block of 8 warps at 12 rows
    takes 181 KB of shared memory), each taking the same whole number of
    tiles, or one fewer. A cluster's blocks add their sums into one partial;
    the cluster is the smallest (up to 8 blocks) that keeps the partials at
    or under `_DW_PARTIALS` of the bytes of x and g (one partial of C*k*k
    floats per cluster, against 2*b*h*w*C), or the largest that divides the
    blocks when none does.
    """
    rows = -(-h // -(-h // _DW_ROWS))
    return (rows, *dw_split(b, h, w, c, k, rows, sms))


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dwconv_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Tap gradient dw[c, 0, ky, kx] = sum_{b,y,x} xpad[b, y+ky, x+kx, c] g[b, y, x, c].

    :param x: (b, h, w, c) float32 NHWC forward input, contiguous.
    :param g: (b, h, w, c) cotangent of the output, contiguous.
    :param k: odd kernel size <= 9.
    :return: (c, 1, k, k), PyTorch's depthwise `weight` layout.

    On a CUDA tensor: the tap-gradient kernel of `csrc/dwconv.cu` on the
    plan of `dw_plan` for its card (one CUDA launch, or two where clusters leave several
    partials per channel group), counted by `dwconv_dw.launches` (one per
    call); on a CPU tensor: `dwconv_dw_plain`.
    """
    if x.device.type not in ('cpu', 'cuda') or x.dim() != 4:
        raise ValueError(f'dwconv_dw takes (b, h, w, c) on cpu or cuda, got '
                         f'{tuple(x.shape)} on {x.device}')
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f'g must match x {tuple(x.shape)} on {x.device}, '
                         f'got {tuple(g.shape)} on {g.device}')
    if k % 2 != 1 or k > 9:
        raise ValueError(f'kernel size must be odd and <= 9, got {k}')
    for t in (x, g):
        if t.dtype != torch.float32:
            raise TypeError(f'dwconv_dw takes float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError('dwconv_dw takes contiguous NHWC tensors')
    if x.device.type == 'cpu':
        return dwconv_dw_plain(x, g, k)
    b, h, w, c = x.shape
    dw = torch.empty((c, 1, k, k), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    rows, splits, cluster = dw_plan(b, h, w, c, k, _sm_count(x.device.index))
    partial = (torch.empty((splits // cluster, c, k * k), dtype=x.dtype, device=x.device)
               if splits > cluster else None)
    err = _build.load().slowtv_dwconv_dw_f32(
        x.data_ptr(), g.data_ptr(), None if partial is None else partial.data_ptr(),
        dw.data_ptr(), b, h, w, c, k, rows, splits, cluster, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'dwconv tap-gradient kernel')
    dwconv_dw.launches += 1
    return dw


dwconv_dw.launches = 0
