"""Fused ConvNeXt block, NHWC: one launch per block forward, one per block backward.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_convnext.py:fused_convnext_block`
and its custom VJP:

    y = x + gamma * fc2(gelu(fc1(LN(dwconv7x7(x) + b_dw))))

with a stride-1 zero-'SAME' 7x7 depthwise conv, a LayerNorm over the channels
(biased variance, eps 1e-6), fc1: C -> 4C, GELU (erf, or tanh when
`approximate`), fc2: 4C -> C, a per-channel layer scale and the residual.

On a CUDA tensor `fused_convnext_block` is a `torch.autograd.Function`:
- forward: the hand-written Hopper kernel `csrc/convnext_block.cu` (kernel 9:
  one C entry, three CUDA launches: the taps and the LayerNorm, then the two
  matrix products as 128 x 128 register-tiled float32 tiles with the GELU and
  the residual in their epilogues; with few pixels the blocks of a cluster
  split a tile's K, see `fwd_plan`). It saves x and the parameters only;
- backward: `fused_convnext_block_bwd`, which recomputes the forward as the
  JAX VJP does: `csrc/convnext_block_bwd.cu` (kernel 10: du, the cotangent
  before the depthwise conv, and the gradients of b_dw, the LayerNorm, fc1,
  fc2 and gamma), then kernel 1 with flipped taps (dx = dy + dwconv(du)) and
  kernel 2 (the taps' gradient), through their launchers, as
  `_block_core_bwd` finishes with `pallas_dwconv`'s two kernels.
On a CPU tensor it runs the plain PyTorch version `fused_convnext_block_plain`
under autograd, which the tests hold against the JAX package; the plain
backward is `fused_convnext_block_bwd_plain`. Any other device, or a tensor a
kernel does not take, raises.

Activations are NHWC as in the JAX package; the parameters keep PyTorch's
layouts (`nn.Conv2d(groups=C)`: (C, 1, 7, 7); `nn.Linear`: (out, in)), which the
kernels read as they are: no transposed copy per call. The TPU kernel's
128-lane channel padding (`c_real`) and its `h >= 6`, `Th | H` tiling limits do
not exist here.
"""
from __future__ import annotations

import functools
import heapq

import torch
import torch.nn.functional as F

from .. import _build
from .dwconv import _forward as _dwconv_forward
from .dwconv import _sm_count, depthwise_conv_plain, dwconv_dw

__all__ = ['fused_convnext_block', 'fused_convnext_block_plain', 'fused_convnext_block_bwd',
           'fused_convnext_block_bwd_plain', 'fwd_plan', 'bwd_plan', 'MAX_CHANNELS', 'LN_EPS']

LN_EPS = 1e-6         # the block's LayerNorm epsilon (csrc/convnext_common.cuh kEps)
MAX_CHANNELS = 2048   # the widest block the kernels take
_K = 7
_TILES = (32, 16, 8)  # pixels per tile of the per-pixel launches
_SMEM = 232448        # bytes of shared memory one block can use on Hopper
# The product core of kernels 9 and 10 (csrc/convnext_common.cuh) and their
# plans, `fwd_plan` and `bwd_plan`:
_TILE = 128           # product tile, rows and columns (kBM, kBN)
_SLAB_K = 32          # K per staged slab (kBK)
BWD_GROUP = 256       # K per float32 chain of the products, at most (kMaxGroup)
_FWD_SPLITS = tuple(range(1, 9))  # blocks of a cluster splitting a forward product's K
_BWD_SPLITS_W = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
_BWD_SPLITS_X = (1, 2, 4)
_SLAB_BYTES = 8e6     # bytes the card moves while an SM takes one slab of a tile (~2.4 us)


def _bwd_row_smem(m: int, c: int) -> int:
    """Shared memory of one block of the backward's per-pixel launches: one
    (m, c + 4) row block and two floats a pixel; float32 (`row_smem` in
    csrc/convnext_block_bwd.cu computes the same)."""
    return 4 * (m * (c + 4) + 2 * m)


def _split_len(n: int, splits: int) -> int:
    """Rows of K per split: ceil(n / splits) rounded up to the 32-deep slab
    (`split_len` in csrc/convnext_block_bwd.cu)."""
    return -(-(-(-n // splits)) // _SLAB_K) * _SLAB_K


def _makespan(blocks: list, sms: int) -> float:
    """`blocks` (their lengths, in launch order), each to the first SM that is
    free, one at a time per SM -> when the last ends."""
    free = [0.0] * sms
    for length in blocks:
        heapq.heapreplace(free, free[0] + length)
    return max(free)


def _pixel_tile(p: int, c: int, sms: int) -> int:
    """Pixels per tile of the per-pixel launches (kernel 9's prep, kernel 10's
    prep and ln): the largest of 32, 16 and 8 whose shared memory fits and
    that leaves a tile for every SM, else the smallest that fits."""
    fits = [m for m in _TILES if _bwd_row_smem(m, c) <= _SMEM]  # 16 and 8 up to MAX_CHANNELS
    return next((m for m in fits if -(-p // m) >= sms), fits[-1])


def _fwd_split(tiles: int, k: int, slots: tuple) -> int:
    """Blocks of a cluster splitting the K of each of a forward product's
    `tiles` 128 x 128 tiles: the split of `_FWD_SPLITS` that leaves no split
    empty and minimises the launch's makespan, `slots[i]` blocks running at
    once in clusters of `_FWD_SPLITS[i]`, a block taking its 32-deep slabs
    plus two for the pipeline's start and its epilogue, plus one more for
    the cluster's sum when split."""
    best = None
    for s, n in zip(_FWD_SPLITS, slots):
        length = _split_len(k, s)
        if s > 1 and (s - 1) * length >= k:  # a split without K
            continue
        cost = _makespan([-(-length // _SLAB_K) + 2 + (s > 1)] * (tiles * s), n)
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


@functools.lru_cache(maxsize=64)
def fwd_plan(b: int, h: int, w: int, c: int, sms: int,
             cluster_blocks: tuple | None = None) -> tuple[int, int, int]:
    """Kernel 9's plan on a card of `sms` SMs -> (pixels per tile of its prep
    launch, blocks per cluster splitting fc1's K = c, and fc2's K = 4c).

    `cluster_blocks`: for each split of `_FWD_SPLITS`, the blocks of the
    product launches the card runs at once in clusters of that size (a
    cluster's blocks share a GPC, so large clusters leave SMs out;
    `_cluster_blocks` asks the card); `sms` for every split when not given.
    """
    p = b * h * w
    mtiles = -(-p // _TILE)
    slots = cluster_blocks or (sms,) * len(_FWD_SPLITS)
    return (_pixel_tile(p, c, sms), _fwd_split(mtiles * -(-4 * c // _TILE), c, slots),
            _fwd_split(mtiles * -(-c // _TILE), 4 * c, slots))


@functools.lru_cache(maxsize=8)
def _cluster_blocks(device: int) -> tuple:
    """`fwd_plan`'s `cluster_blocks` for this card, from the CUDA runtime's
    occupancy of the product launches."""
    lib = _build.load()
    out = tuple(lib.slowtv_convnext_block_fwd_cluster_blocks(s, device) for s in _FWD_SPLITS)
    if not all(out):
        raise RuntimeError(f'the CUDA runtime gave no cluster occupancy for kernel 9: {out}')
    return out


@functools.lru_cache(maxsize=64)
def bwd_plan(b: int, h: int, w: int, c: int, sms: int) -> tuple[int, int, int, int]:
    """Kernel 10's plan on a card of `sms` SMs -> (pixels per tile of its
    per-pixel launches, K per float32 chain of the products launch, pixel
    splits of the weight gradients, K splits of dxln).

    The per-pixel tile is the largest of 32, 16 and 8 whose shared memory
    fits and that leaves a tile for every SM (else the smallest that fits).
    The chains are `BWD_GROUP` long. The splits minimise a model of the
    products launch (one block per SM): its blocks in launch order (the
    weight-gradient tiles' splits, then dxln's tiles' splits), each to the
    first SM that is free, each as long as its 32-deep slabs plus two and a
    quarter more per chain it adds in double, plus the partials' bytes,
    written and read, at `_SLAB_BYTES` a slab.
    """
    p, hidden = b * h * w, 4 * c
    m = _pixel_tile(p, c, sms)
    tiles_c, tiles_h, mtiles = -(-c // _TILE), -(-hidden // _TILE), -(-p // _TILE)
    best = None
    for sw in _BWD_SPLITS_W:
        lw = _split_len(p, sw)
        if sw > 1 and (sw - 1) * lw >= p:  # a split without pixels
            continue
        w_block = -(-lw // _SLAB_K) + 2 + -(-lw // BWD_GROUP) / 4
        for sx in _BWD_SPLITS_X:
            lx = _split_len(hidden, sx)
            if sx > 1 and (sx - 1) * lx >= hidden:
                continue
            x_block = -(-lx // _SLAB_K) + 2 + -(-lx // BWD_GROUP) / 4
            blocks = [w_block] * (2 * tiles_c * tiles_h * sw) + [x_block] * (mtiles * tiles_c * sx)
            partials = 8 * (2 * sw * c * hidden + (sx - 1) * p * c)  # bytes, written and read
            cost = _makespan(blocks, sms) + partials / _SLAB_BYTES
            if best is None or cost < best[0]:
                best = (cost, sw, sx)
    return m, BWD_GROUP, best[1], best[2]


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


def _forward(x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
             fc2_bias, gamma, approximate: bool) -> torch.Tensor:
    """Kernel 9 on CUDA tensors `fused_convnext_block` has checked; the plain
    version on CPU ones, which reach `_FusedBlock` only when it is applied
    directly (the tests of its CPU path: `fused_convnext_block` itself runs the
    plain version under autograd there)."""
    args = (x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, gamma)
    if x.device.type == 'cpu':
        return fused_convnext_block_plain(*args, approximate=approximate)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    lib = _build.load()
    scratch = torch.empty(lib.slowtv_convnext_block_fwd_scratch_floats(b, h, w, c),
                          dtype=torch.float32, device=x.device)
    err = lib.slowtv_convnext_block_fwd_f32(
        *(t.data_ptr() for t in args), out.data_ptr(), scratch.data_ptr(), b, h, w, c,
        *fwd_plan(b, h, w, c, _sm_count(x.device.index), _cluster_blocks(x.device.index)),
        int(bool(approximate)),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'convnext-block kernel')
    fused_convnext_block.launches += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """`pallas_convnext.py:_block_core` with its custom VJP: kernel 9 forward,
    `fused_convnext_block_bwd` backward. Saves x and the parameters only."""

    @staticmethod
    def forward(ctx, x, *params_and_flag):
        *params, approximate = params_and_flag
        ctx.approximate = approximate
        ctx.save_for_backward(x, *params)
        return _forward(x, *params, approximate)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        grads = fused_convnext_block_bwd(x, dy.contiguous(), *params, approximate=ctx.approximate)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def fused_convnext_block(x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias,
                         fc2_weight, fc2_bias, gamma, approximate: bool = False) -> torch.Tensor:
    """One ConvNeXt block, differentiable in all ten inputs.

    :param x: (b, h, w, c) float32 NHWC, contiguous; c a multiple of 4, <= 2048.
    :param dw_weight: (c, 1, 7, 7) depthwise taps; dw_bias (c,).
    :param ln_weight, ln_bias: (c,) LayerNorm scale and bias.
    :param fc1_weight: (4c, c); fc1_bias (4c,). fc2_weight: (c, 4c); fc2_bias (c,).
    :param gamma: (c,) layer scale.
    :param approximate: tanh GELU instead of the exact erf one.
    :return: (b, h, w, c) contiguous, a new tensor (never in place).

    `fused_convnext_block.launches` counts the forward kernel's calls on the
    card (one per call, however many CUDA launches kernel 9 makes inside);
    `fused_convnext_block_bwd.launches` the backward's (one per block
    backward).
    """
    args = (x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, gamma)
    _check(*args)
    if x.device.type == 'cpu':
        return fused_convnext_block_plain(*args, approximate=approximate)
    return _FusedBlock.apply(*args, bool(approximate))


fused_convnext_block.launches = 0


def fused_convnext_block_bwd_plain(x, dy, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight,
                                   fc1_bias, fc2_weight, fc2_bias, gamma,
                                   approximate: bool = False) -> tuple:
    """Plain PyTorch version of the block's backward: the forward recomputed
    under autograd -> the gradients of x and the nine parameters, in their
    layouts (what `pallas_convnext.py:_block_core_bwd` returns)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (
            x, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
            fc2_bias, gamma)]
        y = fused_convnext_block_plain(*leaves, approximate=approximate)
        return torch.autograd.grad(y, leaves, dy)


def fused_convnext_block_bwd(x, dy, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight,
                             fc1_bias, fc2_weight, fc2_bias, gamma,
                             approximate: bool = False) -> tuple:
    """The block's backward -> (dx, d dw_weight, d dw_bias, d ln_weight,
    d ln_bias, d fc1_weight, d fc1_bias, d fc2_weight, d fc2_bias, d gamma).

    :param x: the forward's input; dy: the cotangent of y, (b, h, w, c) float32
        contiguous; the parameters as `fused_convnext_block` takes them.

    On a CUDA tensor: kernel 10 (`csrc/convnext_block_bwd.cu`), then kernel 1
    on du with the taps flipped and kernel 2, counted by
    `fused_convnext_block_bwd.launches` (one per call, however many CUDA
    launches kernel 10 makes inside) and by the two dwconv counters; it raises
    for a shape the kernel does not take. On a CPU tensor:
    `fused_convnext_block_bwd_plain`.
    """
    params = (dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
              fc2_bias, gamma)
    _check(x, *params)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f'dy must be a contiguous {tuple(x.shape)} {x.dtype} tensor on '
                         f'{x.device}, got {tuple(dy.shape)} {dy.dtype} on {dy.device}')
    if x.device.type == 'cpu':
        return fused_convnext_block_bwd_plain(x, dy, *params, approximate=approximate)
    du, *grads = block_bwd_kernel(x, dy, *params, approximate=approximate)
    dx = dy + _dwconv_forward(du, dw_weight.flip((-2, -1)).contiguous(), None)
    return (dx, dwconv_dw(x, du, _K), *grads)


def block_bwd_kernel(x, dy, dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias,
                     fc2_weight, fc2_bias, gamma, approximate: bool = False) -> tuple:
    """Kernel 10 alone, on CUDA tensors `fused_convnext_block_bwd` has checked
    -> (du, d dw_bias, d ln_weight, d ln_bias, d fc1_weight, d fc1_bias,
    d fc2_weight, d fc2_bias, d gamma); du is the cotangent of the depthwise
    conv's output. Counted by `fused_convnext_block_bwd.launches`."""
    params = (dw_weight, dw_bias, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
              fc2_bias, gamma)
    if any(t.data_ptr() % 16 for t in (dy, fc1_weight, fc2_weight)):
        raise ValueError('dy, fc1_weight and fc2_weight must start on a 16-byte boundary')
    b, h, w, c = x.shape
    du = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in params[1:]]  # b_dw, LN, fc1, fc2, gamma
    if x.numel() == 0:
        return (du, *(g.zero_() for g in grads))
    m, group, splits_w, splits_x = bwd_plan(b, h, w, c, _sm_count(x.device.index))
    lib = _build.load()
    scratch = torch.empty(
        lib.slowtv_convnext_block_bwd_scratch_floats(b, h, w, c, m, splits_w, splits_x),
        dtype=torch.float32, device=x.device)
    err = lib.slowtv_convnext_block_bwd_f32(
        *(t.data_ptr() for t in (x, dy, *params, du, *grads, scratch)), b, h, w, c, m, group,
        splits_w, splits_x, int(bool(approximate)), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'convnext-block backward kernel')
    fused_convnext_block_bwd.launches += 1
    return (du, *grads)


fused_convnext_block_bwd.launches = 0
