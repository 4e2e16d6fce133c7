"""View-synthesis reconstruction loss: min-reprojection and automasking (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/reconstruction.py`:
- min (or mean) over the support views;
- the static-pixel automask against the identity reprojection, with an
  eps-scaled Gaussian tie-break on the static error. The JAX package draws
  it from a PRNG key; here it comes from an explicit `torch.Generator`, or
  is handed in as a `noise` tensor (the tests pass JAX's own draw).
Multiple support predictions are stacked on a leading axis (n, b, h, w, c).
The predicted weighting masks (explainability, uncertainty) and the l2
error belong to other recipes (ROADMAP queue A item 9).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import eps
from .photometric import DenseL1Error, PhotoError

__all__ = ['ReconstructionLoss']


class ReconstructionLoss:
    """:param loss_name: Photometric error {ssim, l1}.
    :param use_min: Reduce over views with min instead of mean.
    :param use_automask: Mask static pixels via the identity reprojection.
    :param mask_name: None only (weighting masks: ROADMAP A9).
    :param kernels: passed to `PhotoError`.
    """

    def __init__(self, loss_name: str = 'ssim', use_min: bool = False,
                 use_automask: bool = False, mask_name: Optional[str] = None,
                 kernels: bool = True):
        if loss_name not in ('ssim', 'l1') or mask_name is not None:
            raise NotImplementedError(
                f'Photometric error "{loss_name}" with mask "{mask_name}" is not ported '
                'yet (have ssim and l1, no mask); ROADMAP queue A item 9.')
        self.loss_name = loss_name
        self.use_min = use_min
        self.use_automask = use_automask
        self._photo = PhotoError(0.85, kernels=kernels) if loss_name == 'ssim' else DenseL1Error()

    def _reduce(self, err: torch.Tensor) -> torch.Tensor:
        """(b, h, w, n) -> (b, h, w, 1) over views. `amin` splits the gradient
        between tied views, as `jnp.min` does."""
        return err.amin(-1, keepdim=True) if self.use_min else err.mean(-1, keepdim=True)

    def compute_photo(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """(n, b, h, w, c) or (b, h, w, c) against (b, h, w, c) -> (b, h, w, 1)."""
        err = self._photo(pred, target)
        if pred.dim() == 5:
            err = err[..., 0].permute(1, 2, 3, 0)  # (b, h, w, n)
        return self._reduce(err)

    def apply_automask(self, err: torch.Tensor, source: torch.Tensor, target: torch.Tensor,
                       noise: torch.Tensor):
        """Monodepth2 static-pixel automask.

        The static error depends only on the images, so with a scale-tiled
        batch (m = n_sc * b) it is computed once on the untiled source and
        tiled; the tie-break noise has the tiled shape (m, h, w, 1).
        """
        m, b = err.shape[0], source.shape[1]
        if m % b:
            raise ValueError(f'Tiled batch {m} is not a multiple of the source batch {b}')
        err_static = self.compute_photo(source, target[:b])
        err_static = torch.cat([err_static] * (m // b)) + eps(err_static) * noise
        automask = err < err_static
        return torch.minimum(err, err_static), automask

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 source: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        """:param pred: (n, b, h, w, c) warped support frames (or (b, h, w, c)).
        :param target: (b, h, w, c) target images.
        :param source: (n, b', h, w, c) unwarped support frames (automask).
        :param generator: draws the automask tie-break noise N(0, 1).
        :param noise: or the noise itself, (b, h, w, 1) like the loss map.
        :return: (loss scalar, {'automask': (b, h, w, 1) bool} when automasking).
        """
        ld = {}
        err = self.compute_photo(pred, target)
        if self.use_automask:
            if source is None:
                raise ValueError("Must provide the original 'source' images when automasking...")
            if noise is None:
                if generator is None:
                    raise ValueError('Automasking needs a torch.Generator or the noise.')
                noise = torch.randn(err.shape, generator=generator, dtype=err.dtype,
                                    device=err.device)
            err, ld['automask'] = self.apply_automask(err, source, target, noise)
        return err.mean(), ld
