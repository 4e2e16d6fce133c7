"""Per-loss handlers of the training step (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/core/handlers.py`, with the JAX
package's batching: `image_recon`, `feat_recon`, `autoenc_recon`,
`stereo_const`, `depth_regr`, `disp_smooth`, `feat_smooth`, `disp_occ` and
`disp_mask`. All upsampled scales share the
full (h, w) resolution, so they are stacked on the batch axis and each
handler makes ONE batched `view_synth` call over (supports x scales x
batch): one warp launch per handler call on the card (`depth_regr`'s hint
automask: two).

Shapes: depths {s: (b, h, w, 1)}, masks {s: (b, h, w, n)}, imgs
(b, h, w, 3), supp_imgs (n, b, h, w, 3), Ts (n, b, 4, 4), Ks (b, 4, 4);
features per encoder stage [(b, h/r, w/r, c)] and their supports'
[(n, b, h/r, w/r, c)].
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import resize_like, view_synth

__all__ = ['image_recon', 'feat_recon', 'autoenc_recon', 'stereo_const', 'depth_regr',
           'disp_smooth', 'feat_smooth', 'disp_occ', 'disp_mask', 'rigid_inverse']


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
    # One scale (`feat_recon`): the supports as they are, not a copy of 1 GB of features.
    supp_s = supp_imgs if n_sc == 1 else torch.cat([supp_imgs] * n_sc, dim=1)
    Ts_s = torch.cat([Ts] * n_sc, dim=1)
    Ks_s = _tile_scales(Ks, n_sc)

    warped = _batched_synth(supp_s, depths_s, Ts_s, Ks_s, kernels=kernels,
                            warp_bf16=warp_bf16)
    src = supp_imgs if masks_s is None else supp_s
    loss, ld = crit(warped, imgs_s, source=src, mask=masks_s, generator=generator, noise=noise)
    ld = {k: v[:b] for k, v in ld.items()}
    ld['supp_imgs_warp'] = warped[:, :b]
    return loss, ld


def feat_recon(crit, depths: dict, feats, supp_feats, Ts: torch.Tensor, Ks: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, kernels: bool = True,
               masks: Optional[dict] = None):
    """Feature reconstruction at scale 0 only: the stride-4 features (`feats[-4]`
    of a pyramid) of the target and its supports, their gradients stopped, resized
    bilinearly (no antialias) to scale 0's depth and warped by it as
    `image_recon` warps images (kernel 5 at C = the features' channels on the
    card). No gradient reaches the features, so the warp's backward runs the
    coordinates' part only.

    :param noise: the automask tie-break noise, (b, h, w, 1).
    :return: (loss, {'supp_feats_warp': (n, b, h, w, c)}).
    """
    if isinstance(feats, (list, tuple)):
        feats, supp_feats = feats[-4], supp_feats[-4]
    depth0 = depths[0]
    feats = resize_like(feats.detach(), depth0)
    supp_feats = resize_like(supp_feats.detach().flatten(0, 1), depth0).unflatten(
        0, supp_feats.shape[:2])
    masks0 = None if masks is None else {0: masks[0]}
    loss, ld = image_recon(crit, {0: depth0}, feats, supp_feats, Ts, Ks, generator=generator,
                           noise=noise, kernels=kernels, masks=masks0)
    return loss, {'supp_feats_warp': ld['supp_imgs_warp']}


def autoenc_recon(crit, preds: dict, targets: torch.Tensor, supp_preds: dict,
                  supp_targets: torch.Tensor):
    """The autoencoder's image reconstruction: every scale's (upsampled) target and
    support images against the inputs, as ONE stack (s * (b + n * b) images).

    :param preds: {s: (b, h, w, 3)}; supp_preds {s: (n, b, h, w, 3)}.
    """
    n_sc = len(preds)
    preds_s = _stack_scales(preds)
    supp_preds_s = torch.cat([supp_preds[k].flatten(0, 1) for k in sorted(supp_preds)])
    targets_s = _tile_scales(targets, n_sc)
    supp_targets_s = _tile_scales(supp_targets.flatten(0, 1), n_sc)
    loss, _ = crit(torch.cat([preds_s, supp_preds_s]), torch.cat([targets_s, supp_targets_s]))
    return loss, {}


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


def feat_smooth(crit, feats, imgs: torch.Tensor, supp_feats, supp_imgs: torch.Tensor):
    """Feature peakiness or smoothness over the encoder stages, stage s weighted by
    1 / 2**s, averaged; the same over the supports' features, added."""
    ls = [crit(f, resize_like(imgs, f))[0] / 2 ** s for s, f in enumerate(feats)]
    loss = torch.stack(ls).mean()
    supp_imgs_f = supp_imgs.flatten(0, 1)
    ls = [crit(f.flatten(0, 1), resize_like(supp_imgs_f, f[0]))[0] / 2 ** s
          for s, f in enumerate(supp_feats)]
    return loss + torch.stack(ls).mean(), {}


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
