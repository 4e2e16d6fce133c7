"""Full training entry point (PyTorch port).

Counterpart of `api/train/train.py` on one device: merged YAML cfg chain,
optional tensorboard/wandb logging (scalars, and the image logger's grids
and text at each epoch's end), best/last checkpoints with monitor-based
selection, run markers, resume/warm-start.

Usage:
    slowtv-train-torch -c cfg/kbr/default.yaml cfg/kbr/base.yaml -n kbr/base -v 42
    python -m slowtv_monodepth_tpu_torch.train -c ... -n ...
"""
from __future__ import annotations

import random
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np

from . import LOGGER
from .config import load_merge_yaml
from .core.heavy_logger import HeavyLogger
from .core.loop import MonoDepthLoop
from .paths import MODEL_ROOTS


class WandbWriter:
    """SummaryWriter-shaped adapter over `wandb.log`: the `add_scalar` the loop
    drives, `add_images` (NCHW grids) and `add_text` the image logger drives."""

    def __init__(self, log_dir: Path, project: str = 'slowtv_monodepth_torch',
                 name: Optional[str] = None):
        import wandb
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, dir=str(log_dir), resume=None)

    def add_scalar(self, tag, value, global_step=None):
        self._wandb.log({tag: float(value)}, step=global_step)

    def add_images(self, tag, imgs, global_step=None):
        imgs = np.asarray(imgs)  # (b, c, h, w) -> HWC wandb Images
        ims = [self._wandb.Image(np.transpose(im, (1, 2, 0))) for im in imgs]
        self._wandb.log({tag: ims}, step=global_step)

    def add_text(self, tag, text, global_step=None):
        self._wandb.log({tag: str(text)}, step=global_step)

    def close(self):
        self._wandb.finish()


def make_writer(kind: Optional[str], log_dir: Path, name: Optional[str] = None):
    """The scalar writer of `trainer.logger`: {tensorboard, wandb, none}. Either
    package is imported here, when asked for; without wandb installed, 'wandb'
    warns and writes to tensorboard, as the JAX package's entry point does."""
    if kind in (None, 'none'):
        return None
    if kind == 'wandb':
        try:
            import wandb  # noqa: F401
        except ImportError:
            LOGGER.warning('wandb unavailable; falling back to tensorboard.')
            kind = 'tensorboard'
    if kind == 'tensorboard':
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(str(log_dir))
    if kind == 'wandb':
        log_dir.mkdir(parents=True, exist_ok=True)
        return WandbWriter(log_dir, name=name)
    raise ValueError(f'Logger "{kind}" not supported. ({{tensorboard, wandb, none}})')


def main(argv=None) -> None:
    parser = ArgumentParser(description='Monocular depth trainer (PyTorch).')
    parser.add_argument('--cfg-files', '-c', type=Path, nargs='*', required=True,
                        help='YAML config chain (default, override1, ...).')
    parser.add_argument('--ckpt-dir', '-o', default=MODEL_ROOTS[-1], type=Path)
    parser.add_argument('--name', '-n', required=True, type=str)
    parser.add_argument('--version', '-v', default=0, type=int)
    parser.add_argument('--seed', '-s', default=42, type=int)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    LOGGER.info(f'Creating config from {[f.name for f in args.cfg_files]}...')
    cfg = load_merge_yaml(*args.cfg_files)
    cfg['seed'] = args.seed
    cfg.setdefault('loader', {})['seed'] = args.seed
    random.seed(args.seed)
    np.random.seed(args.seed)

    version = f'{args.version:03}'
    save_dir = Path(args.ckpt_dir) / args.name / version
    save_dir.mkdir(parents=True, exist_ok=True)

    writer = make_writer(cfg.get('trainer', {}).get('logger', 'tensorboard'),
                         save_dir / 'logs', name=f'{args.name}_{version}')
    loop = MonoDepthLoop(cfg, ckpt_dir=save_dir / 'models', device=args.device, writer=writer,
                         heavy_logger=HeavyLogger(n_imgs=6, n_cols=2))
    loop.fit()


if __name__ == '__main__':
    main()
