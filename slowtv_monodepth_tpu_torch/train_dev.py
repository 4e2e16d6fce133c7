"""Debug training variant (PyTorch port).

Counterpart of `api/train/train_dev.py`: trains into a fresh temporary
directory with tight limits (10 epochs x 10 batches by default), the loss
read back and printed at every step, and a non-finite loss raising
`ValueError` at the step that made it. The quick inner loop for iterating on
losses and networks without touching real run directories.

Usage:
    slowtv-train-dev-torch -c cfg/kbr/default.yaml [overrides...] [--device cpu]
    python -m slowtv_monodepth_tpu_torch.train_dev -c ...
"""
from __future__ import annotations

import math
import tempfile
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from . import LOGGER
from .config import load_merge_yaml
from .core.loop import MonoDepthLoop


class DevLoop(MonoDepthLoop):
    """Loop variant with a per-epoch batch limit and a loss check every step."""

    def __init__(self, *args, limit_batches: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        self.limit_batches = limit_batches

    def train_epoch(self, epoch: int) -> None:
        self.train_dl.set_epoch(epoch)
        rng = np.random.default_rng(epoch)
        for i, (x, y, m) in enumerate(self.train_dl):
            if i >= self.limit_batches:
                break
            supp_idxs = tuple(int(v) for v in x.get('supp_idxs', ()))
            xb, yb = self._place(x, y)
            xb, yb, m = self.ar_aug((xb, yb, m))
            step = self._step_fn(supp_idxs, train=True)
            scalars = step(xb, yb, **self.step_randomness(int(rng.integers(2 ** 31))))
            loss = float(scalars['loss'])  # a host sync every step: dev mode
            self.global_step += 1
            LOGGER.info(f'epoch {epoch} step {i}: loss={loss:.5f}')
            if not math.isfinite(loss):
                raise ValueError(f'Detected NaN/Infinite loss: "{loss}"')


def main(argv=None) -> None:
    parser = ArgumentParser(description='Debug monocular depth trainer (PyTorch).')
    parser.add_argument('--cfg-files', '-c', type=Path, nargs='*', required=True)
    parser.add_argument('--epochs', default=10, type=int)
    parser.add_argument('--batches', default=10, type=int)
    parser.add_argument('--seed', '-s', default=42, type=int)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    cfg = load_merge_yaml(*args.cfg_files)
    cfg['seed'] = args.seed
    cfg.setdefault('trainer', {})['max_epochs'] = args.epochs
    cfg['trainer']['resume_training'] = False

    ckpt_dir = Path(tempfile.mkdtemp(prefix='slowtv_dev_'))
    LOGGER.info(f'Dev checkpoints -> {ckpt_dir}')
    loop = DevLoop(cfg, ckpt_dir=ckpt_dir, device=args.device, use_markers=False,
                   limit_batches=args.batches)
    loop.fit()


if __name__ == '__main__':
    main()
