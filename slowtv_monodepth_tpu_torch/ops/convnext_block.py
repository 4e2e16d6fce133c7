"""Fused ConvNeXt block, forward, NHWC: one launch per block.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_convnext.py:fused_convnext_block`:

    y = x + gamma * fc2(gelu(fc1(LN(dwconv7x7(x) + b_dw))))

with a stride-1 zero-'SAME' 7x7 depthwise conv, a LayerNorm over the channels
(biased variance, eps 1e-6), fc1: C -> 4C, GELU (erf, or tanh when
`approximate`), fc2: 4C -> C, a per-channel layer scale and the residual.

On a CUDA tensor `fused_convnext_block` launches the hand-written Hopper kernel
`csrc/convnext_block.cu` (both matrix products, the taps, the LayerNorm and the
GELU in one kernel; the (pixels, 4C) hidden activation never reaches device
memory; with few pixels a cluster of thread blocks shares each pixel tile, see
`tile_pixels`). On a CPU tensor it runs the plain PyTorch version
`fused_convnext_block_plain`, which autograd differentiates and the tests hold
against the JAX package. Any other device, or a tensor the kernel does not
take, raises.

The JAX function has a custom VJP (its backward kernel). That kernel is not
ported yet (ROADMAP.md B, kernel 10), so on the card the wrapper raises when a
gradient is asked for: serving runs, training through the fused block does not.

Activations are NHWC as in the JAX package; the parameters keep PyTorch's
layouts (`nn.Conv2d(groups=C)`: (C, 1, 7, 7); `nn.Linear`: (out, in)), which the
kernel reads as they are: no transposed copy per call. The TPU kernel's
128-lane channel padding (`c_real`) and its `h >= 6`, `Th | H` tiling limits do
not exist here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .dwconv import depthwise_conv_plain

__all__ = ['fused_convnext_block', 'fused_convnext_block_plain', 'tile_pixels',
           'MAX_CHANNELS', 'LN_EPS']

LN_EPS = 1e-6         # the block's LayerNorm epsilon (csrc/convnext_block.cu kEps)
MAX_CHANNELS = 2048   # the smallest pixel tile's shared memory fits up to here
_K = 7
_TILES = (32, 16, 8)  # pixels per tile the kernel is built for
_SMEM = 232448        # bytes of shared memory one block can use on Hopper
_MIN_BLOCKS = 99      # 3/4 of an H100's 132 SMs: with fewer tiles, clusters share them
_MAX_CLUSTER = 8      # thread blocks per cluster (the portable limit)


def _smem_bytes(m: int, c: int) -> int:
    """Shared memory of one block: LN output (m, c + 4), fc2 sum (m, c), one
    hidden chunk (m, 260), one weight tile (256, 36); float32."""
    return 4 * (m * (2 * c + 4) + 260 * m + 256 * 36)


def tile_pixels(pixels: int, c: int) -> tuple[int, int]:
    """(pixels per tile, thread blocks per tile): the largest tile that fits
    shared memory; while its tiles would leave more than a quarter of the SMs
    idle, twice the blocks share each tile (a cluster, which splits the
    tile's pixels for the taps and its 256-column hidden chunks for the MLP)."""
    m = next((m for m in _TILES if _smem_bytes(m, c) <= _SMEM), None)
    if m is None:
        raise ValueError(f'no pixel tile fits {c} channels')  # excluded by MAX_CHANNELS
    tiles, chunks = -(-pixels // m), -(-4 * c // 256)
    s = 1
    while s < _MAX_CLUSTER and tiles * s < _MIN_BLOCKS and 2 * s <= chunks:
        s *= 2
    return m, s


def _check(x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias,
           fc2_weight, fc2_bias, gamma) -> None:
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_convnext_block runs on cpu or cuda, not {x.device}')
    if x.dim() != 4:
        raise ValueError(f'x must be (b, h, w, c), got {tuple(x.shape)}')
    c = x.shape[-1]
    if c % 4 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f'the kernel takes a channel count that is a multiple of 4 and '
                         f'at most {MAX_CHANNELS}, got {c}')
    want = {'dw_weight': (c, 1, _K, _K), 'dw_bias': (c,), 'ln_weight': (c,), 'ln_bias': (c,),
            'fc1_weight': (4 * c, c), 'fc1_bias': (4 * c,), 'fc2_weight': (c, 4 * c),
            'fc2_bias': (c,), 'gamma': (c,)}
    tensors = (dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
               fc2_bias, gamma)
    for (name, shape), t in zip(want.items(), tensors):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got {tuple(t.shape)}')
    for t in (x, *tensors):
        if t.dtype != torch.float32:
            raise TypeError(f'fused_convnext_block takes float32, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'all tensors must be on {x.device}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('fused_convnext_block takes contiguous tensors (x as NHWC, '
                             'parameters in their nn.Conv2d / nn.Linear layouts)')


def fused_convnext_block_plain(x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight,
                               fc1_bias, fc2_weight, fc2_bias, gamma,
                               approximate: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the unfused block, differentiable in all ten inputs."""
    u = depthwise_conv_plain(x, dw_weight, dw_bias)
    u = F.layer_norm(u, (x.shape[-1],), ln_weight, ln_bias, LN_EPS)
    h = F.gelu(F.linear(u, fc1_weight, fc1_bias), approximate='tanh' if approximate else 'none')
    return x + gamma * F.linear(h, fc2_weight, fc2_bias)


def fused_convnext_block(x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias,
                         fc2_weight, fc2_bias, gamma, approximate: bool = False) -> torch.Tensor:
    """One ConvNeXt block.

    :param x: (b, h, w, c) float32 NHWC, contiguous; c a multiple of 4, <= 2048.
    :param dw_weight: (c, 1, 7, 7) depthwise taps; dw_bias (c,).
    :param ln_weight, ln_bias: (c,) LayerNorm scale and bias.
    :param fc1_weight: (4c, c); fc1_bias (4c,). fc2_weight: (c, 4c); fc2_bias (c,).
    :param gamma: (c,) layer scale.
    :param approximate: tanh GELU instead of the exact erf one.
    :return: (b, h, w, c) contiguous, a new tensor (never in place).

    `fused_convnext_block.launches` counts the kernel launches on the card
    (one per call). Under grad on the card it raises: the backward kernel is
    not ported yet.
    """
    args = (x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, gamma)
    _check(*args)
    if x.device.type == 'cpu':
        return fused_convnext_block_plain(*args, approximate=approximate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            'fused_convnext_block has no backward on the card yet: the fused block\'s '
            'backward kernel (kernel 10, pallas_convnext.py:_block_bwd_jit) is open in '
            'ROADMAP.md B. Run under torch.no_grad(), or build the net with '
            'fused_blocks=False to train.')
    if fc1_weight.data_ptr() % 16 or fc2_weight.data_ptr() % 16:
        raise ValueError('fc1_weight and fc2_weight must start on a 16-byte boundary')
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    err = _build.load().slowtv_convnext_block_fwd_f32(
        *(t.data_ptr() for t in args), out.data_ptr(), b, h, w, c,
        *tile_pixels(b * h * w, c), int(bool(approximate)), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'convnext-block kernel')
    fused_convnext_block.launches += 1
    return out


fused_convnext_block.launches = 0
