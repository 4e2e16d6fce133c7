"""One skip-less Monodepth decoder stage, fused, NHWC, forward.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_decoder.py:fused_upconv_stage`:

    ha   = ELU(conv3x3_reflect(x, wa) + ba)
    u    = upsample2x_nearest(ha)
    feat = ELU(conv3x3_reflect(u, wb) + bb)
    disp = sigmoid(conv3x3_reflect(feat, wo) + bo)

On a CUDA tensor `fused_upconv_stage` runs the hand-written Hopper kernel
`csrc/decoder_stage.cu` (three launches of one direct-conv kernel; `u` is
never stored); on a CPU tensor it runs the plain PyTorch version
`fused_upconv_stage_plain`. Any other device, or a tensor the kernel does not
take, raises.

Forward only on the card: the stage's backward is TPU kernel 4
(`pallas_decoder.py:_stage_bwd_jit`), not ported yet (ROADMAP queue B). On
a CUDA tensor the wrapper raises when grad mode is on and an input requires
grad, rather than return outputs that autograd would silently cut off.
Training builds its decoder with the stages unfused
(`MonodepthDecoder(fused_stages=False)`).

Activations are NHWC as in the JAX package; weights keep PyTorch's OIHW
`nn.Conv2d` layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ['fused_upconv_stage', 'fused_upconv_stage_plain', 'MAX_CHANNELS']

# The kernel keeps a [9 * ci][16] weight tile in shared memory (227 KB per
# block on Hopper): 400 input channels fit.
MAX_CHANNELS = 400


def _check(x, wa, ba, wb, bb, wo, bo) -> None:
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_upconv_stage runs on cpu or cuda, not {x.device}')
    if x.dim() != 4:
        raise ValueError(f'x must be (b, h, w, ci), got {tuple(x.shape)}')
    b, h, w, ci = x.shape
    cd = wa.shape[0]
    if h < 2 or w < 2:
        raise ValueError(f'reflect padding needs h, w >= 2, got {(h, w)}')
    if max(ci, cd) > MAX_CHANNELS:
        raise ValueError(f'at most {MAX_CHANNELS} channels, got ci={ci} cd={cd}')
    want = {'wa': (cd, ci, 3, 3), 'ba': (cd,), 'wb': (cd, cd, 3, 3),
            'bb': (cd,), 'wo': (1, cd, 3, 3), 'bo': (1,)}
    for (name, shape), t in zip(want.items(), (wa, ba, wb, bb, wo, bo)):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got {tuple(t.shape)}')
    for t in (x, wa, ba, wb, bb, wo, bo):
        if t.dtype != torch.float32:
            raise TypeError(f'fused_upconv_stage takes float32, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'all tensors must be on {x.device}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('fused_upconv_stage takes contiguous tensors '
                             '(x as NHWC, weights as OIHW)')


def _conv_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode='reflect'), w, b)


def fused_upconv_stage_plain(x, wa, ba, wb, bb, wo, bo):
    """Plain PyTorch version (NCHW inside, NHWC at the boundary)."""
    ha = F.elu(_conv_reflect(x.permute(0, 3, 1, 2), wa, ba))
    u = F.interpolate(ha, scale_factor=2, mode='nearest')
    feat = F.elu(_conv_reflect(u, wb, bb))
    disp = torch.sigmoid(_conv_reflect(feat, wo, bo))
    return (feat.permute(0, 2, 3, 1).contiguous(),
            disp.permute(0, 2, 3, 1).contiguous())


def fused_upconv_stage(x, wa, ba, wb, bb, wo, bo):
    """One skip-less stage.

    :param x: (b, h, w, ci) float32 NHWC, contiguous, h and w >= 2.
    :param wa: (cd, ci, 3, 3) `upconv_i_0` weight; ba (cd,) its bias.
    :param wb: (cd, cd, 3, 3) `upconv_i_1` weight; bb (cd,) its bias.
    :param wo: (1, cd, 3, 3) `outconv_i` weight; bo (1,) its bias.
    :return: (feat (b, 2h, 2w, cd), disp (b, 2h, 2w, 1)), contiguous.

    `fused_upconv_stage.launches` counts the stages run on the card (each is
    three kernel launches on the current stream).
    """
    _check(x, wa, ba, wb, bb, wo, bo)
    if x.device.type == 'cpu':
        return fused_upconv_stage_plain(x, wa, ba, wb, bb, wo, bo)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wa, ba, wb, bb, wo, bo)):
        raise NotImplementedError(
            'fused_upconv_stage on the card is forward only: its backward is TPU '
            'kernel 4 (pallas_decoder.py:_stage_bwd_jit), not ported yet (ROADMAP '
            'queue B). Build the decoder with fused_stages=False to train, or run '
            'under torch.no_grad().')
    b, h, w, ci = x.shape
    cd = wa.shape[0]
    ha = torch.empty((b, h, w, cd), dtype=x.dtype, device=x.device)
    feat = torch.empty((b, 2 * h, 2 * w, cd), dtype=x.dtype, device=x.device)
    disp = torch.empty((b, 2 * h, 2 * w, 1), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return feat, disp
    err = _build.load().slowtv_decoder_stage_fwd_f32(
        *(t.data_ptr() for t in (x, wa, ba, wb, bb, wo, bo, ha, feat, disp)),
        b, h, w, ci, cd, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'decoder-stage kernel')
    fused_upconv_stage.launches += 1
    return feat, disp


fused_upconv_stage.launches = 0
