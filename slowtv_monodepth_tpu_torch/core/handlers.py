"""Per-loss handlers of the training step (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/core/handlers.py`, with the JAX
package's batching: `image_recon`, `stereo_const`, `depth_regr`,
`disp_smooth`, `disp_occ` and `disp_mask`. All upsampled scales share the
full (h, w) resolution, so they are stacked on the batch axis and each
handler makes ONE batched `view_synth` call over (supports x scales x
batch): one warp launch per handler call on the card (`depth_regr`'s hint
automask: two).

Shapes: depths {s: (b, h, w, 1)}, masks {s: (b, h, w, n)}, imgs
(b, h, w, 3), supp_imgs (n, b, h, w, 3), Ts (n, b, 4, 4), Ks (b, 4, 4).
The feature handlers (`feat_recon`, `autoenc_recon`, `feat_smooth`) belong
to ROADMAP queue A item 9b.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import resize_like, view_synth

__all__ = ['image_recon', 'stereo_const', 'depth_regr', 'disp_smooth', 'disp_occ', 'disp_mask',
           'rigid_inverse']


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
                warp_bf16: bool = False, masks: Optional[dict] = None):
    """Photometric reconstruction loss over all scales.

    Without masks the automask's static error takes the UNTILED support
    frames (it does not depend on the scale). Predicted masks {s: (b, h, w,
    n)} differ per scale, so with them it takes the tiled source. The
    tie-break noise has the tiled shape (s*b, h, w, 1). `loss_dict` holds
    scale 0 only.
    """
    n, b = supp_imgs.shape[:2]
    n_sc = len(depths)
    depths_s = _stack_scales(depths)
    masks_s = None if masks is None else _stack_scales(masks)
    imgs_s = _tile_scales(imgs, n_sc)
    supp_s = torch.cat([supp_imgs] * n_sc, dim=1)
    Ts_s = torch.cat([Ts] * n_sc, dim=1)
    Ks_s = _tile_scales(Ks, n_sc)

    warped = _batched_synth(supp_s, depths_s, Ts_s, Ks_s, kernels=kernels,
                            warp_bf16=warp_bf16)
    src = supp_imgs if masks_s is None else supp_s
    loss, ld = crit(warped, imgs_s, source=src, mask=masks_s, generator=generator, noise=noise)
    ld = {k: v[:b] for k, v in ld.items()}
    ld['supp_imgs_warp'] = warped[:, :b]
    return loss, ld


def stereo_const(crit, disps: dict, depths: dict, disps_stereo: dict, depths_stereo: dict,
                 T_stereo: torch.Tensor, K: torch.Tensor, kernels: bool = True):
    """Virtual-stereo disparity consistency: ONE warp of the disparities
    [stereo, mono] into the other view, by [T, T^-1], each regressed onto the
    disparity of its own view.

    The warped sources are disparities with a gradient of their own, so the
    warp's image cotangent runs here (`ops.sample._Warp`), on C = 1.
    """
    n_sc = len(disps)
    b = T_stereo.shape[0]
    disps_s = _stack_scales(disps)
    depths_s = _stack_scales(depths)
    disps_st_s = _stack_scales(disps_stereo)
    depths_st_s = _stack_scales(depths_stereo)

    T_s = _tile_scales(T_stereo, n_sc)
    T_inv_s = _tile_scales(rigid_inverse(T_stereo), n_sc)
    K_s = torch.cat([_tile_scales(K, n_sc)] * 2)
    all_disps = torch.cat([disps_st_s, disps_s])
    all_warp, _, _ = view_synth(all_disps, torch.cat([depths_s, depths_st_s]),
                                torch.cat([T_s, T_inv_s]), K_s, kernels=kernels)
    loss, _ = crit(all_disps, all_warp)
    m = n_sc * b
    return loss, {'disps_warp': all_warp[m:m + b], 'stereo_disps_warp': all_warp[:b]}


def depth_regr(crit, photo, depths: dict, targets: torch.Tensor, imgs: torch.Tensor,
               supp_imgs: torch.Tensor, Ts: torch.Tensor, Ks: torch.Tensor,
               kernels: bool = True):
    """Proxy-depth (hint) regression on the valid hints (`targets > 0`), with
    the Depth-Hints automask when the loss asks for it: a hint counts only
    where warping the supports by it reconstructs the target better than
    warping them by the prediction.

    :param photo: the image reconstruction loss's `compute_photo`.

    The automask is a comparison, so no gradient flows through it: its two
    warps and two photometric errors run under `torch.no_grad()`.
    """
    n_sc = len(depths)
    b = imgs.shape[0]
    imgs_s = _tile_scales(imgs, n_sc)
    depths_s = _stack_scales(depths)
    targets_s = _tile_scales(targets, n_sc)
    masks = targets_s > 0

    ld_extra = {}
    if crit.use_automask:
        with torch.no_grad():
            supp_s = torch.cat([supp_imgs] * n_sc, dim=1)
            Ts_s = torch.cat([Ts] * n_sc, dim=1)
            Ks_s = _tile_scales(Ks, n_sc)
            supp_hints_warp = _batched_synth(supp_s, targets_s, Ts_s, Ks_s, kernels=kernels)
            supp_imgs_warp = _batched_synth(supp_s, depths_s, Ts_s, Ks_s, kernels=kernels)
            automask = photo(supp_imgs_warp, imgs_s) > photo(supp_hints_warp, imgs_s)
        ld_extra['automask_hints'] = automask[:b]
        masks = masks & automask

    loss, ld = crit(depths_s, targets_s, masks)
    return loss, {'mask_regr': ld['mask_regr'][:b], **ld_extra}


def disp_smooth(crit, disps: dict, imgs: torch.Tensor):
    """Smoothness on the raw (not upsampled) disparities, each scale weighted
    by 1 / 2**s, averaged."""
    ls = {s: crit(disp, resize_like(imgs, disp)) for s, disp in disps.items()}
    loss = torch.stack([v[0] / 2 ** s for s, v in ls.items()]).mean()
    return loss, ls[min(ls)][1]


def disp_occ(crit, disps: dict):
    """Occlusion regularization on the raw disparities, averaged over scales."""
    ls = {s: crit(d) for s, d in disps.items()}
    return torch.stack([v[0] for v in ls.values()]).mean(), ls[min(ls)][1]


def disp_mask(crit, masks: dict):
    """Predicted-mask regularization, averaged over scales."""
    ls = {s: crit(m) for s, m in masks.items()}
    return torch.stack([v[0] for v in ls.values()]).mean(), ls[min(ls)][1]


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid (*, 4, 4) transform: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T[..., :3, 3:]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)
