"""End-of-epoch image logging (PyTorch port).

Counterpart of `slowtv_monodepth_tpu/core/heavy_logger.py`: re-runs the
forward and loss on the epoch's last training batch and writes image grids
(inputs, disparities, warped supports, automasks, gradients, PCA'd features)
plus the batch's metadata text to the writer (tensorboardX interface:
`add_images` NCHW + `add_text`), with the JAX package's tags and text.

The rerun goes through the step's own `MonoDepthTrainer.loss_fn`, in eval
mode under `no_grad`, with the automask noise drawn from a generator seeded
by the epoch (the JAX package draws it from `PRNGKey(epoch)`). What it logs
comes to the host once; the grids are host numpy (NHWC, as the port's
batches are), so this file is the JAX one's numpy code.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.base_mde import IMAGENET_MEAN, IMAGENET_STD
from ..tools import rgb_from_disp, rgb_from_feat

__all__ = ['HeavyLogger', 'make_grid']


def make_grid(imgs: np.ndarray, n: int = 6, n_cols: int = 2) -> np.ndarray:
    """(b, h, w, c) -> (1, c, H, W) NCHW grid (torchvision.make_grid role)."""
    imgs = np.asarray(imgs)[:n]
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    if imgs.shape[-1] == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
    b, h, w, c = imgs.shape
    n_rows = (b + n_cols - 1) // n_cols
    grid = np.zeros((n_rows * h, n_cols * w, c), imgs.dtype)
    for i in range(b):
        r, col = divmod(i, n_cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return np.clip(grid, 0, 1).transpose(2, 0, 1)[None]


def _unstandardize(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x) * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def _host(tree):
    """Tensors of a nested dict/list -> numpy (NHWC as the port keeps them)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


class HeavyLogger:
    """:param n_imgs: Max images per grid. :param n_cols: Grid columns."""

    def __init__(self, n_imgs: int = 6, n_cols: int = 2):
        self.n = n_imgs
        self.n_cols = n_cols
        self.mode = 'train'
        self.step = 0
        self.writer = None

    def _grid(self, x) -> np.ndarray:
        return make_grid(np.asarray(x), self.n, self.n_cols)

    def write_images(self, d: dict) -> None:
        for k, v in d.items():
            self.writer.add_images(f'{self.mode}_{k}', v, global_step=self.step)

    def write_text(self, d: dict) -> None:
        for k, v in d.items():
            self.writer.add_text(f'{self.mode}_{k}', v, global_step=self.step)

    # ------------------------------------------------------------------ entry
    def log_step(self, trainer, batch, supp_idxs: tuple, writer, epoch: int,
                 mode: str = 'train', noise: Optional[torch.Tensor] = None) -> None:
        """Re-run the loss on `batch` (x, y, m: device tensors, host metadata)
        and log all artifacts.

        :param noise: the automask tie-break noise, (n_scales * b, h, w, 1);
            by default drawn from a generator seeded by `epoch`.
        """
        if writer is None or not hasattr(writer, 'add_images'):
            return
        self.mode, self.step, self.writer = mode, epoch, writer

        x, y, m = batch
        gen = None if noise is not None else \
            torch.Generator(device=x['imgs'].device).manual_seed(epoch)
        training = trainer.nets.training
        trainer.nets.eval()
        try:
            with torch.no_grad():
                _, (loss_dict, fwd) = trainer.loss_fn(x, y, tuple(supp_idxs), gen, noise)
        finally:
            trainer.nets.train(training)
        fwd = {k: fwd[k] for k in ('disp', 'disp_stereo', 'mask', 'depth_feats') if k in fwd}
        fwd['depth_feats'] = [f.permute(0, 2, 3, 1) for f in fwd.get('depth_feats', [])]
        x, y, fwd, loss_dict = _host((x, y, fwd, loss_dict))

        self.log_batch((x, y, m), supp_idxs)
        self.log_fwd(fwd, supp_idxs)
        self.log_loss(loss_dict, supp_idxs)

    # ------------------------------------------------------------------ parts
    def log_batch(self, batch, supp_idxs) -> None:
        """Input grids + metadata text."""
        x, y, m = batch
        if self.mode == 'train':
            self.write_images({
                'imgs_aug/target': self._grid(_unstandardize(x['imgs'])),
                **{f'imgs_aug/supp_{i}': self._grid(_unstandardize(im))
                   for i, im in zip(supp_idxs, np.asarray(x['supp_imgs']))},
            })
        self.write_images({
            'imgs/target': self._grid(y['imgs']),
            **{f'imgs/supp_{i}': self._grid(im)
               for i, im in zip(supp_idxs, np.asarray(y['supp_imgs']))},
        })
        if (depth := y.get('depth')) is not None:
            self.write_images({'depth/lidar': self._grid(
                rgb_from_disp(np.asarray(depth)[..., 0], invert=True))})
        if (depth := y.get('depth_hints')) is not None:
            self.write_images({'depth/hints': self._grid(
                rgb_from_disp(np.asarray(depth)[..., 0], invert=True))})

        txt = {}
        for key in ('items', 'items_original', 'supp', 'errors', 'augs'):
            vals = m.get(key)
            if vals is not None and any(str(v) for v in np.atleast_1d(vals)):
                txt[key] = ' - '.join(str(v) for v in np.atleast_1d(vals))
        if txt:
            self.write_text(txt)

    def log_fwd(self, fwd: dict, supp_idxs) -> None:
        """Network outputs: disparities, the virtual-stereo disparity, the
        predicted masks and features (the autoencoder's images are ROADMAP A9b)."""
        imgs = {}
        if 'disp' in fwd:
            imgs['pred/disp'] = self._grid(rgb_from_disp(fwd['disp'][0][..., 0]))
        if 'disp_stereo' in fwd:
            imgs['pred/disp_stereo'] = self._grid(rgb_from_disp(fwd['disp_stereo'][0][..., 0]))
        if 'mask' in fwd:
            for j, i in enumerate(supp_idxs):
                if fwd['mask'][0].shape[-1] > j:
                    imgs[f'pred/mask_{i}'] = self._grid(fwd['mask'][0][..., j:j + 1])
        if fwd.get('depth_feats'):
            imgs['pred/feats'] = self._grid(rgb_from_feat(fwd['depth_feats'][0]))
        self.write_images(imgs)

    def log_loss(self, ld: dict, supp_idxs) -> None:
        """Loss artifacts: warps, automasks (the hints' too), gradients."""
        imgs = {}
        if 'supp_imgs_warp' in ld:
            for i, w in zip(supp_idxs, ld['supp_imgs_warp']):
                imgs[f'loss/warp_{i}'] = self._grid(w)
        if 'automask' in ld:
            imgs['loss/automask'] = self._grid(np.asarray(ld['automask'], np.float32))
        if 'automask_hints' in ld:
            imgs['loss/automask_hints'] = self._grid(
                np.asarray(ld['automask_hints'], np.float32))
        if 'disp_grad' in ld:
            imgs['loss/disp_grad'] = self._grid(rgb_from_disp(ld['disp_grad'][..., 0]))
        if 'image_grad' in ld:
            imgs['loss/image_grad'] = self._grid(rgb_from_disp(ld['image_grad'][..., 0]))
        self.write_images(imgs)
