"""Export a checkpoint's predictions on an evaluation dataset -> compressed NPZ
(PyTorch port).

Counterpart of `api/eval/export_preds.py` on one device: the predictor by
name (`midas.<name>`, `newcrfs.<name>`, else 'ours': a checkpoint file or a
name under a model root), the per-dataset input shape, the `finished`-marker
guard on unfinished training runs, batches of 12, and
`np.savez_compressed(file, pred=preds)`. The mesh options of the JAX script
(`--devices`, `--model-shards`, `--spatial-shards` above 1) are ROADMAP A11.
The network runs on `--device` (default `cuda`; there is no fallback: pass
`--device cpu` to run on the CPU).

Usage:
    slowtv-export-preds-torch --cfg-file cfg/eval/syns_test.yaml \
        --ckpt models/kbr/base/42/models/last.ckpt --save-file preds/syns_test.npz
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import LOGGER, parsers
from .config import load_yaml
from .data import DataLoader
from .paths import find_model_file
from .registry import PRED_REG, trigger_preds

__all__ = ['save_preds', 'load_predictor', 'make_dataset', 'predict', 'compute_preds', 'main']


def save_preds(file: Path, preds: np.ndarray) -> None:
    file.parent.mkdir(parents=True, exist_ok=True)
    LOGGER.info(f"Saving network predictions to '{file}'...")
    np.savez_compressed(file, pred=preds)


def load_predictor(ckpt: str, cfg_model=None, overwrite: bool = False, device='cuda'):
    """-> (predictor, network) for `ckpt`: a checkpoint of this framework (refused
    while its run has no `finished` marker, unless `overwrite`) or an external
    model's name."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('No CUDA device: pass `--device cpu` to predict on the CPU.')
    trigger_preds()
    model_type = str(ckpt).split('.', maxsplit=1)[0]
    model_type = model_type if model_type in PRED_REG else 'ours'
    predictor = PRED_REG[model_type](device=device)
    if model_type != 'ours':
        return predictor, predictor.load_model(str(ckpt).split('.', maxsplit=1)[1])

    ckpt_path = Path(ckpt) if Path(ckpt).exists() else find_model_file(str(ckpt))
    if not (ckpt_path.parent / 'finished').is_file() and not overwrite:
        LOGGER.error(f"Training for '{ckpt_path}' has not finished... "
                     'Set `--overwrite 1` to evaluate anyway.')
        raise SystemExit(1)
    return predictor, predictor.load_model(ckpt_path, cfg_model)


def make_dataset(cfg: dict, predictor):
    """The eval cfg's `dataset` section at the predictor's input shape."""
    cfg = dict(cfg)
    cfg.pop('target_stem', None)
    ds_type = cfg.pop('type')
    cfg.update({'shape': predictor.get_img_shape(ds_type), 'use_aug': False, 'log_time': False})
    return next(iter(parsers.get_ds({ds_type: cfg}).values()))


def predict(predictor, net, ds, batch_size: int = 12, num_workers: int = 8) -> np.ndarray:
    """Every item of `ds` in order, in batches of `batch_size` -> (n, h, w)."""
    dl = DataLoader(ds, batch_size=batch_size, num_workers=num_workers,
                    shuffle=False, drop_last=False)
    LOGGER.info('Computing predictions...')
    return predictor(net, dl, use_stereo_blend=False)


def compute_preds(cfg: Optional[dict], ckpt: str, cfg_model=None, overwrite: bool = False,
                  batch_size: int = 12, num_workers: int = 8, devices: int = 1,
                  model_shards: int = 1, spatial_shards: int = 1, device='cuda',
                  ds=None) -> np.ndarray:
    """Predictions for an eval dataset cfg (or a dataset object `ds`, which then
    stands in for `cfg`) and a checkpoint or external model name."""
    for name, n in (('devices', devices), ('model_shards', model_shards),
                    ('spatial_shards', spatial_shards)):
        if n and n > 1:
            raise NotImplementedError(f'`{name}={n}`: predicting over a mesh is not ported '
                                      'yet; ROADMAP queue A item 11.')
    predictor, net = load_predictor(ckpt, cfg_model, overwrite, device)
    if ds is None:
        ds = make_dataset(cfg, predictor)
    return predict(predictor, net, ds, batch_size, num_workers)


def main() -> None:
    parser = ArgumentParser(description='Export network predictions on a target dataset.')
    parser.add_argument('--cfg-file', required=True, type=Path)
    parser.add_argument('--ckpt', required=True, type=str)
    parser.add_argument('--cfg-model', default=None, nargs='*', type=Path)
    parser.add_argument('--save-file', default=None, type=Path)
    parser.add_argument('--overwrite', default=0, type=int)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--devices', default=1, type=int, help='> 1: ROADMAP A11.')
    parser.add_argument('--model-shards', default=1, type=int, help='> 1: ROADMAP A11.')
    parser.add_argument('--spatial-shards', default=1, type=int, help='> 1: ROADMAP A11.')
    args = parser.parse_args()

    if args.save_file and args.save_file.is_file() and not args.overwrite:
        LOGGER.error(f"Prediction file already exists '{args.save_file}'... "
                     'Set `--overwrite 1` to export anyway.')
        raise SystemExit(1)

    cfg = load_yaml(args.cfg_file)['dataset']
    preds = compute_preds(cfg, args.ckpt, args.cfg_model, args.overwrite,
                          devices=args.devices, model_shards=args.model_shards,
                          spatial_shards=args.spatial_shards, device=args.device)
    if args.save_file:
        save_preds(args.save_file, preds)


if __name__ == '__main__':
    main()
