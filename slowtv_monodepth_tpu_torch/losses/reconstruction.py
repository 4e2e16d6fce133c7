"""View-synthesis reconstruction loss: min-reprojection, automasking and
predicted weighting masks (PyTorch, NHWC).

Counterpart of `slowtv_monodepth_tpu/losses/reconstruction.py`:
- the photometric error {ssim, l1, l2}, min (or mean) over the support views;
- the explainability (err * m) and uncertainty (err * e^{-m} + m) masks,
  one channel per support view, applied before that reduction;
- the static-pixel automask against the identity reprojection, with an
  eps-scaled Gaussian tie-break on the static error. The JAX package draws
  it from a PRNG key; here it comes from an explicit `torch.Generator`, or
  is handed in as a `noise` tensor (the tests pass JAX's own draw).
Multiple support predictions are stacked on a leading axis (n, b, h, w, c).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import eps
from .photometric import DenseL1Error, DenseL2Error, PhotoError

__all__ = ['ReconstructionLoss']


class ReconstructionLoss:
    """:param loss_name: Photometric error {ssim, l1, l2}.
    :param use_min: Reduce over views with min instead of mean.
    :param use_automask: Mask static pixels via the identity reprojection.
    :param mask_name: Weighting mask {explainability, uncertainty, None}.
    :param kernels: passed to `PhotoError`.
    """

    def __init__(self, loss_name: str = 'ssim', use_min: bool = False,
                 use_automask: bool = False, mask_name: Optional[str] = None,
                 kernels: bool = True):
        if mask_name not in {'explainability', 'uncertainty', None}:
            raise ValueError(f'Invalid mask type: {mask_name}')
        self.loss_name = loss_name
        self.use_min = use_min
        self.use_automask = use_automask
        self.mask_name = mask_name
        self._photo = {'ssim': lambda: PhotoError(0.85, kernels=kernels),
                       'l1': DenseL1Error, 'l2': DenseL2Error}[loss_name]()

    def _reduce(self, err: torch.Tensor) -> torch.Tensor:
        """(b, h, w, n) -> (b, h, w, 1) over views. `amin` splits the gradient
        between tied views, as `jnp.min` does."""
        return err.amin(-1, keepdim=True) if self.use_min else err.mean(-1, keepdim=True)

    def apply_mask(self, err: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Weight the per-view error (b, h, w, n) by the predicted mask."""
        if self.mask_name and mask is None:
            raise ValueError("Must provide a 'mask' when masking...")
        if self.mask_name == 'explainability':
            err = err * mask
        elif self.mask_name == 'uncertainty':
            err = err * torch.exp(-mask) + mask
        return err

    def compute_photo(self, pred: torch.Tensor, target: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, b, h, w, c) or (b, h, w, c) against (b, h, w, c), weighted by
        `mask` (b, h, w, n) -> (b, h, w, 1)."""
        err = self._photo(pred, target)
        if pred.dim() == 5:
            err = err[..., 0].permute(1, 2, 3, 0)  # (b, h, w, n)
        return self._reduce(self.apply_mask(err, mask))

    def apply_automask(self, err: torch.Tensor, source: torch.Tensor, target: torch.Tensor,
                       mask: Optional[torch.Tensor], noise: torch.Tensor):
        """Monodepth2 static-pixel automask.

        The static error depends only on the images, so with a scale-tiled
        batch (m = n_sc * b) and no mask it is computed once on the untiled
        source and tiled. A predicted mask differs per scale: then the
        handler passes the tiled source (m == b) and the static error takes
        `mask[:b]`, all of it. The tie-break noise has the tiled shape
        (m, h, w, 1).
        """
        m, b = err.shape[0], source.shape[1]
        if m % b:
            raise ValueError(f'Tiled batch {m} is not a multiple of the source batch {b}')
        if mask is not None and m != b:
            raise ValueError(f'A masked automask takes the tiled source ({m} vs. {b})')
        err_static = self.compute_photo(source, target[:b],
                                        mask=None if mask is None else mask[:b])
        err_static = torch.cat([err_static] * (m // b)) + eps(err_static) * noise
        automask = err < err_static
        return torch.minimum(err, err_static), automask

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 source: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        """:param pred: (n, b, h, w, c) warped support frames (or (b, h, w, c)).
        :param target: (b, h, w, c) target images.
        :param source: (n, b', h, w, c) unwarped support frames (automask).
        :param mask: (b, h, w, n) predicted weighting mask.
        :param generator: draws the automask tie-break noise N(0, 1).
        :param noise: or the noise itself, (b, h, w, 1) like the loss map.
        :return: (loss scalar, {'automask': (b, h, w, 1) bool} when automasking).
        """
        ld = {}
        err = self.compute_photo(pred, target, mask)
        if self.use_automask:
            if source is None:
                raise ValueError("Must provide the original 'source' images when automasking...")
            if noise is None:
                if generator is None:
                    raise ValueError('Automasking needs a torch.Generator or the noise.')
                noise = torch.randn(err.shape, generator=generator, dtype=err.dtype,
                                    device=err.device)
            err, ld['automask'] = self.apply_automask(err, source, target, mask, noise)
        return err.mean(), ld
