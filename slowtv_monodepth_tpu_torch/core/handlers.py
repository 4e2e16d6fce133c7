"""Per-loss handlers of the training step (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/core/handlers.py` for the KBR losses:
`image_recon` and `disp_smooth`, with the JAX package's batching. All
upsampled scales share the full (h, w) resolution, so they are stacked on
the batch axis and `image_recon` makes ONE batched `view_synth` call over
(supports x scales x batch): one warp launch per step on the card.

Shapes: depths {s: (b, h, w, 1)}, imgs (b, h, w, 3), supp_imgs
(n, b, h, w, 3), Ts (n, b, 4, 4), Ks (b, 4, 4).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import resize_like, view_synth

__all__ = ['image_recon', 'disp_smooth', 'rigid_inverse']


def _stack_scales(d: dict) -> torch.Tensor:
    """{s: (b, ...)} -> (s*b, ...) in ascending scale order."""
    return torch.cat([d[k] for k in sorted(d)])


def _tile_scales(x: torch.Tensor, n_sc: int) -> torch.Tensor:
    """(b, ...) -> (s*b, ...) repeated per scale."""
    return torch.cat([x] * n_sc)


def _batched_synth(supp_imgs: torch.Tensor, depths: torch.Tensor, Ts: torch.Tensor,
                   Ks: torch.Tensor, kernels: bool = True,
                   warp_bf16: bool = False) -> torch.Tensor:
    """One view synthesis over the (n, m) flattened support/scale batches.

    :param supp_imgs: (n, m, h, w, c); depths (m, h, w, 1) and Ks (m, 4, 4)
        shared across n; Ts (n, m, 4, 4).
    :param warp_bf16: quantize the warp SOURCES to bfloat16 (finer than the
        8-bit video frames): the warp then runs the packed kernel 6. The
        warped frames and the whole loss chain stay float32.
    :return: (n, m, h, w, c) warped support frames.
    """
    n, m, h, w, c = supp_imgs.shape
    src = supp_imgs.reshape(n * m, h, w, c)
    if warp_bf16:
        src = src.to(torch.bfloat16)
    depth_f = depths.expand((n,) + depths.shape).reshape(n * m, h, w, 1)
    Ks_f = Ks.expand((n,) + Ks.shape).reshape(n * m, 4, 4)
    warped, _, _ = view_synth(src, depth_f,
                              Ts.reshape(n * m, 4, 4), Ks_f, kernels=kernels)
    return warped.reshape(n, m, h, w, c)


def image_recon(crit, depths: dict, imgs: torch.Tensor, supp_imgs: torch.Tensor,
                Ts: torch.Tensor, Ks: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, kernels: bool = True,
                warp_bf16: bool = False):
    """Photometric reconstruction loss over all scales.

    The automask's static error takes the UNTILED support frames (it does
    not depend on the scale); its tie-break noise has the tiled shape
    (s*b, h, w, 1). `loss_dict` holds scale 0 only. (The JAX handler's
    predicted-mask argument belongs to other recipes, ROADMAP A9.)
    """
    n, b = supp_imgs.shape[:2]
    n_sc = len(depths)
    depths_s = _stack_scales(depths)
    imgs_s = _tile_scales(imgs, n_sc)
    supp_s = torch.cat([supp_imgs] * n_sc, dim=1)
    Ts_s = torch.cat([Ts] * n_sc, dim=1)
    Ks_s = _tile_scales(Ks, n_sc)

    warped = _batched_synth(supp_s, depths_s, Ts_s, Ks_s, kernels=kernels,
                            warp_bf16=warp_bf16)
    loss, ld = crit(warped, imgs_s, source=supp_imgs, generator=generator, noise=noise)
    ld = {k: v[:b] for k, v in ld.items()}
    ld['supp_imgs_warp'] = warped[:, :b]
    return loss, ld


def disp_smooth(crit, disps: dict, imgs: torch.Tensor):
    """Smoothness on the raw (not upsampled) disparities, each scale weighted
    by 1 / 2**s, averaged."""
    ls = {s: crit(disp, resize_like(imgs, disp)) for s, disp in disps.items()}
    loss = torch.stack([v[0] / 2 ** s for s, v in ls.items()]).mean()
    return loss, ls[min(ls)][1]


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid (*, 4, 4) transform: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T[..., :3, 3:]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)
