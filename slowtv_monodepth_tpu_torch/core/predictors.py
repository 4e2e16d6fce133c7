"""Dataset-level depth predictors (PyTorch).

Counterpart of `slowtv_monodepth_tpu/core/predictors.py`, single device (no
mesh; the mesh paths are ROADMAP A11): preprocess -> forward -> postprocess ->
(optional flip-blend) per batch, the per-dataset input-shape table, `apply`
for per-batch consumers, the 4-D and all-zero prediction checks, and the
predictor registry (`registry.PRED_REG`: 'ours'; 'midas' and 'newcrfs' are
registered, but their networks are not ported). Batches arrive as NHWC
numpy arrays (the data loaders' layout) and leave as NHWC numpy arrays; the
network runs on NCHW tensors on `device`.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable

import numpy as np
import torch

from ..models import DepthNet
from ..ops import blend_stereo, to_scaled
from ..registry import register
from .checkpoint import load_checkpoint, net_state_dict

__all__ = ['MonoDepthPredictor', 'BenchmarkPredictor', 'MidasPredictor', 'NewcrfsPredictor']


class MonoDepthPredictor(ABC):
    """Base predictor: preprocess -> forward -> postprocess over a loader."""

    def __init__(self, device='cuda'):
        self.device = torch.device(device)

    @abstractmethod
    def load_model(self, *args, **kwargs) -> Callable:
        """Load a pretrained model; returns a callable imgs -> raw prediction."""

    @staticmethod
    def get_img_shape(data_type: str):
        """Per-dataset input shape (None = native)."""
        return None

    def preprocess(self, imgs: np.ndarray) -> np.ndarray:
        return imgs

    def forward(self, net: Callable, imgs: torch.Tensor) -> torch.Tensor:
        return net(imgs)

    def postprocess(self, pred: torch.Tensor, imgs: np.ndarray) -> torch.Tensor:
        return pred

    @torch.no_grad()
    def forward_batch(self, x: dict, net: Callable,
                      use_stereo_blend: bool = False) -> np.ndarray:
        """{'imgs': (b, h, w, 3) standardized numpy} -> (b, h, w, 1) numpy."""
        imgs = self.preprocess(x['imgs'])
        t = torch.from_numpy(np.ascontiguousarray(imgs, np.float32))
        t = t.to(self.device).permute(0, 3, 1, 2)
        pred = self.forward(net, t)
        if use_stereo_blend:
            pred = blend_stereo(pred, self.forward(net, t.flip(-1)).flip(-1))
        pred = self.postprocess(pred, x['imgs'])
        return pred.permute(0, 2, 3, 1).cpu().numpy()

    def apply(self, net: Callable, dl, func: Callable,
              use_stereo_blend: bool = False, *args, **kwargs) -> None:
        """Run over the loader, applying `func(batch, pred, ...)` per batch
        (ref `predictors.py:88-114`)."""
        for batch in dl:
            pred = self.forward_batch(batch[0], net, use_stereo_blend)
            if pred.ndim != 4:
                raise ValueError(f'Prediction must be 4-D, got {pred.shape}!')
            func(batch, pred, *args, **kwargs)

    def __call__(self, net: Callable, dl, use_stereo_blend: bool = False) -> np.ndarray:
        """Predict the whole dataset -> (n, h, w) array."""
        ds = dl.dataset
        preds = np.zeros((len(ds), ds.h, ds.w, 1), np.float32)
        i = 0
        for x, *_ in dl:
            pred = self.forward_batch(x, net, use_stereo_blend)
            if pred.ndim != 4:
                raise ValueError(f'Prediction must be 4-D, got {pred.shape}!')
            preds[i:i + len(pred)] = pred
            i += len(pred)
        sanity = preds.reshape(len(preds), -1).sum(1)
        if len(idxs := np.nonzero(sanity == 0)[0]):
            raise ValueError(f"Found empty predictions at indices '{idxs}'!")
        return preds.squeeze(-1)


@register('ours', type='pred')
class BenchmarkPredictor(MonoDepthPredictor):
    """Predictor for this framework's (and the reference's) checkpoints."""

    @staticmethod
    def get_img_shape(data_type: str) -> tuple:
        """Fixed width 640 (mapfree portrait 384), height per dataset."""
        return {
            'ddad': (416, 640),
            'diode': (480, 640),
            'kitti': (192, 640),
            'kitti_lmdb': (192, 640),
            'mannequin': (384, 640),
            'mannequin_lmdb': (384, 640),
            'mapfree': (512, 384),
            'nyud': (480, 640),
            'sintel': (288, 640),
            'syns_patches': (192, 640),
            'tum': (480, 640),
        }[data_type]

    def load_model(self, ckpt_file, cfg_files=None) -> DepthNet:
        """Rebuild the depth net from a checkpoint's embedded cfg, on
        `self.device` in eval mode; calling it maps imgs -> {disp, ...}."""
        sd, cfg = load_checkpoint(ckpt_file)
        if cfg_files:
            from ..config import load_merge_yaml
            cfg = load_merge_yaml(*cfg_files)
        tcfg = cfg.get('trainer', {})
        self.min_depth = tcfg.get('min_depth')
        self.max_depth = tcfg.get('max_depth')

        net = DepthNet(**cfg['net']['depth'])
        net.load_state_dict(net_state_dict(sd, 'depth'))
        return net.to(self.device).eval()

    def forward(self, net: Callable, imgs: torch.Tensor) -> torch.Tensor:
        return net(imgs)['disp'][0]

    def postprocess(self, pred: torch.Tensor, imgs: np.ndarray) -> torch.Tensor:
        if self.min_depth or self.max_depth:
            pred = to_scaled(pred, min=0.1, max=100)[0]
        return pred


@register('midas', type='pred')
class MidasPredictor(MonoDepthPredictor):
    """The MiDaS/DPT baseline (ref `:254-284`): its network is ROADMAP A10."""

    def load_model(self, name: str) -> Callable:
        raise NotImplementedError(f'MiDaS "{name}" is not ported yet; ROADMAP queue A item 10.')


@register('newcrfs', type='pred')
class NewcrfsPredictor(MonoDepthPredictor):
    """The NeWCRFs baseline (ref `:212-249`): its network is ROADMAP A10."""

    def load_model(self, scene_type: str) -> Callable:
        raise NotImplementedError(f'NeWCRFs "{scene_type}" is not ported yet; '
                                  'ROADMAP queue A item 10.')
