"""Depthwise KxK convolution (stride 1, zero 'SAME' padding), NHWC, forward.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_dwconv.py:depthwise_conv`.
On a CUDA tensor `depthwise_conv` launches the hand-written Hopper kernel
`csrc/dwconv.cu` (bias fused); on a CPU tensor it runs the plain PyTorch
version `depthwise_conv_plain`, which the tests compare with the JAX package.
There is no other path: any other device, or a tensor the kernel does not
take, raises.

Activations are NHWC, as in the JAX package (`x.permute(0, 2, 3, 1)` of a
channels-last NCHW tensor is a free, contiguous view); the taps keep
PyTorch's `nn.Conv2d(groups=C)` layout (C, 1, K, K).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ['depthwise_conv', 'depthwise_conv_plain']


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


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 'SAME' depthwise conv.

    :param x: (b, h, w, c) float32 NHWC, contiguous.
    :param weight: (c, 1, k, k) taps, odd k <= 9.
    :param bias: optional (c,).
    :return: (b, h, w, c) contiguous.

    `depthwise_conv.launches` counts the kernel launches (CUDA tensors only).
    """
    k = _check(x, weight, bias)
    if x.device.type == 'cpu':
        return depthwise_conv_plain(x, weight, bias)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    err = _build.load().slowtv_dwconv_fwd_f32(
        x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, h, w, c, k, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'dwconv kernel')
    depthwise_conv.launches += 1
    return out


depthwise_conv.launches = 0
