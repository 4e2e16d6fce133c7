"""One skip-less Monodepth decoder stage, fused, NHWC, forward and backward.

Counterpart of `slowtv_monodepth_tpu/ops/pallas_decoder.py:fused_upconv_stage`:

    ha   = ELU(conv3x3_reflect(x, wa) + ba)
    u    = upsample2x_nearest(ha)
    feat = ELU(conv3x3_reflect(u, wb) + bb)
    disp = sigmoid(conv3x3_reflect(feat, wo) + bo)

On a CUDA tensor `fused_upconv_stage` is a `torch.autograd.Function` over the
hand-written Hopper kernels: forward `csrc/decoder_stage.cu` (three launches
of one direct-conv kernel; `u` is never stored; TPU kernel 3), backward
`csrc/decoder_stage_bwd.cu` (`fused_upconv_stage_bwd`, TPU kernel 4: the
stage's seven gradients from the stored `ha`, `feat` and `disp`, nothing
recomputed). On a CPU tensor it runs the plain PyTorch version
`fused_upconv_stage_plain`, which autograd differentiates
(`fused_upconv_stage_bwd_plain`). Any other device, or a tensor the kernels
do not take, raises.

Activations are NHWC as in the JAX package; weights keep PyTorch's OIHW
`nn.Conv2d` layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ['fused_upconv_stage', 'fused_upconv_stage_plain', 'fused_upconv_stage_bwd',
           'fused_upconv_stage_bwd_plain', 'MAX_CHANNELS']

# The kernels keep a [9 * ci][16] weight tile in shared memory (227 KB per
# block on Hopper): 400 channels fit, forward and backward.
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


def fused_upconv_stage_bwd_plain(x, wa, ba, wb, bb, wo, bo, g_feat, g_disp):
    """Plain version of the stage's backward: autograd through
    `fused_upconv_stage_plain`. A cotangent may be None (taken as zeros).

    :return: (dx, dwa, dba, dwb, dbb, dwo, dbo), shaped as the inputs.
    """
    args = [t.detach().requires_grad_() for t in (x, wa, ba, wb, bb, wo, bo)]
    with torch.enable_grad():
        outs = fused_upconv_stage_plain(*args)
    pairs = [(o, g) for o, g in zip(outs, (g_feat, g_disp)) if g is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], args, [g for _, g in pairs],
                                allow_unused=True)
    return tuple(torch.zeros_like(a) if g is None else g for a, g in zip(args, grads))


def _launch_fwd(x, wa, ba, wb, bb, wo, bo):
    """The forward kernel on checked CUDA tensors -> (ha, feat, disp)."""
    b, h, w, ci = x.shape
    cd = wa.shape[0]
    ha = torch.empty((b, h, w, cd), dtype=x.dtype, device=x.device)
    feat = torch.empty((b, 2 * h, 2 * w, cd), dtype=x.dtype, device=x.device)
    disp = torch.empty((b, 2 * h, 2 * w, 1), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return ha, feat, disp
    err = _build.load().slowtv_decoder_stage_fwd_f32(
        *(t.data_ptr() for t in (x, wa, ba, wb, bb, wo, bo, ha, feat, disp)),
        b, h, w, ci, cd, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'decoder-stage kernel')
    fused_upconv_stage.launches += 1
    return ha, feat, disp


def fused_upconv_stage_bwd(x, wa, ba, wb, bb, wo, bo, ha, feat, disp, g_feat, g_disp,
                           need=(True, True, True, True)):
    """The stage's vector-Jacobian product.

    :param x ... bo: the stage's inputs (see `fused_upconv_stage`).
    :param ha, feat, disp: the forward's ELU(conv_a) (b, h, w, cd), and its
        outputs; not read on the CPU, where the plain version recomputes them.
    :param g_feat, g_disp: cotangents of feat and disp; either may be None.
    :param need: which gradients to compute: (dx, dwa and dba, dwb and dbb,
        dwo and dbo).
    :return: (dx, dwa, dba, dwb, dbb, dwo, dbo), None where not needed.

    On CUDA tensors: kernel 4 (`csrc/decoder_stage_bwd.cu`), counted by
    `fused_upconv_stage_bwd.launches`; on CPU tensors: `fused_upconv_stage_bwd_plain`.
    """
    _check(x, wa, ba, wb, bb, wo, bo)
    b, h, w, ci = x.shape
    cd = wa.shape[0]
    want = {'ha': (b, h, w, cd), 'feat': (b, 2 * h, 2 * w, cd), 'disp': (b, 2 * h, 2 * w, 1),
            'g_feat': (b, 2 * h, 2 * w, cd), 'g_disp': (b, 2 * h, 2 * w, 1)}
    for (name, shape), t in zip(want.items(), (ha, feat, disp, g_feat, g_disp)):
        if t is None and name.startswith('g_'):
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f'{name} must be float32 {shape} on {x.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    need4 = tuple(bool(n) for n in need)
    need7 = (need4[0], need4[1], need4[1], need4[2], need4[2], need4[3], need4[3])
    if x.device.type == 'cpu':
        grads = fused_upconv_stage_bwd_plain(x, wa, ba, wb, bb, wo, bo, g_feat, g_disp)
        return tuple(g if n else None for g, n in zip(grads, need7))
    # Cotangents may arrive as views or as nothing at all (an unused output).
    g_feat = torch.zeros_like(feat) if g_feat is None else g_feat.contiguous()
    g_disp = torch.zeros_like(disp) if g_disp is None else g_disp.contiguous()
    ha, feat, disp = ha.contiguous(), feat.contiguous(), disp.contiguous()
    outs = [torch.empty_like(t) if n else None
            for t, n in zip((x, wa, ba, wb, bb, wo, bo), need7)]
    if x.numel() == 0 or not any(need4):
        return tuple(None if o is None else o.zero_() for o in outs)
    lib = _build.load()
    scratch = torch.empty(lib.slowtv_decoder_stage_bwd_scratch_floats(b, h, w, ci, cd),
                          dtype=torch.float32, device=x.device)
    mask = sum(bit for bit, n in zip((1, 2, 4, 8), need4) if n)
    err = lib.slowtv_decoder_stage_bwd_f32(
        *(t.data_ptr() for t in (x, wa, wb, wo, ha, feat, disp, g_feat, g_disp, scratch)),
        *(None if o is None else o.data_ptr() for o in outs),
        b, h, w, ci, cd, mask, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, 'decoder-stage backward kernel')
    fused_upconv_stage_bwd.launches += 1
    return tuple(outs)


fused_upconv_stage_bwd.launches = 0


class _Stage(torch.autograd.Function):
    """The stage on the card: `pallas_decoder.py:_stage_core` with its custom
    VJP. The outputs are written through raw pointers, which autograd cannot
    see, so the Function is what ties them to the inputs."""

    @staticmethod
    def forward(ctx, x, wa, ba, wb, bb, wo, bo):
        ha, feat, disp = _launch_fwd(x, wa, ba, wb, bb, wo, bo)
        ctx.save_for_backward(x, wa, ba, wb, bb, wo, bo, ha, feat, disp)
        return feat, disp

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_feat, g_disp):
        n = ctx.needs_input_grad
        need = (n[0], n[1] or n[2], n[3] or n[4], n[5] or n[6])
        grads = fused_upconv_stage_bwd(*ctx.saved_tensors, g_feat, g_disp, need=need)
        return tuple(g if k else None for g, k in zip(grads, n))


def fused_upconv_stage(x, wa, ba, wb, bb, wo, bo):
    """One skip-less stage, differentiable in all seven inputs.

    :param x: (b, h, w, ci) float32 NHWC, contiguous, h and w >= 2.
    :param wa: (cd, ci, 3, 3) `upconv_i_0` weight; ba (cd,) its bias.
    :param wb: (cd, cd, 3, 3) `upconv_i_1` weight; bb (cd,) its bias.
    :param wo: (1, cd, 3, 3) `outconv_i` weight; bo (1,) its bias.
    :return: (feat (b, 2h, 2w, cd), disp (b, 2h, 2w, 1)), contiguous.

    `fused_upconv_stage.launches` counts the stages run forward on the card
    (each is three kernel launches on the current stream),
    `fused_upconv_stage_bwd.launches` their backward passes.
    """
    _check(x, wa, ba, wb, bb, wo, bo)
    if x.device.type == 'cpu':
        return fused_upconv_stage_plain(x, wa, ba, wb, bb, wo, bo)
    return _Stage.apply(x, wa, ba, wb, bb, wo, bo)


fused_upconv_stage.launches = 0
