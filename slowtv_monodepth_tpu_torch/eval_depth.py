"""Evaluate predictions (a file, or computed from a checkpoint) against exported
targets (PyTorch port).

Counterpart of `api/eval/eval_depth.py`: loads the exported
`targets_<mode>.npz` next to the dataset's split file, runs
`eval.MonoDepthEvaluator` with the eval cfg's `args` (the align mode set on
the command line: 'median', 'lsqr' or a float, a fixed metric scale), and
saves the mean metrics as the YAML `generate_tables` reads. With `--ckpt`
the predictions are computed first, on `--device` (default `cuda`).

Usage:
    slowtv-eval-depth-torch --cfg-file cfg/eval/syns_test.yaml \
        --pred-file preds/syns_test.npz --save-file results/syns_test_last_lsqr.yaml
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from . import LOGGER, parsers
from .config import load_yaml, save_yaml
from .eval import MonoDepthEvaluator
from .export_preds import compute_preds

__all__ = ['save_metrics', 'evaluate', 'compute_eval_metrics', 'main']


def save_metrics(file: Path, metrics: dict) -> None:
    LOGGER.info(f'Saving results to "{file}"...')
    save_yaml(file, metrics)


def evaluate(preds: np.ndarray, data: dict, args: dict, align_mode=None,
             nproc=None, max_items=None):
    """Predictions + targets {depth, [K], [edge], [cat], [subcat]} under an eval
    cfg's `args` (`align_mode` replaces its align mode, a string or a float) ->
    (mean metrics, per-item metrics)."""
    args = dict(args)
    if align_mode is not None:
        try:
            args['align_mode'] = float(align_mode)
        except (ValueError, TypeError):
            args['align_mode'] = align_mode
    return MonoDepthEvaluator(**args).run(preds, data, nproc=nproc, max_items=max_items)


def compute_eval_metrics(preds: np.ndarray, cfg_file: Path, align_mode,
                         nproc=None, max_items=None):
    """Targets npz of an eval cfg + predictions -> (mean metrics, per-item metrics)."""
    cfg = load_yaml(cfg_file)
    cfg_ds = dict(cfg['dataset'])
    target_stem = cfg_ds.pop('target_stem', f"targets_{cfg.get('mode', 'test')}")
    ds = next(iter(parsers.get_ds({cfg_ds.pop('type'): cfg_ds}).values()))
    target_file = ds.split_file.parent / f'{target_stem}.npz'

    LOGGER.info(f'Loading targets from "{target_file}"...')
    data = dict(np.load(target_file, allow_pickle=True))
    return evaluate(preds, data, cfg['args'], align_mode, nproc, max_items)


def main() -> None:
    parser = ArgumentParser()
    parser.add_argument('--align-mode', default='lsqr', type=str)
    parser.add_argument('--cfg-file', required=True, type=Path)
    parser.add_argument('--pred-file', default=None, type=Path)
    parser.add_argument('--ckpt', default=None, type=str)
    parser.add_argument('--cfg-model', default=None, nargs='*', type=Path)
    parser.add_argument('--save-file', default=None, type=Path)
    parser.add_argument('--overwrite', default=0, type=int)
    parser.add_argument('--nproc', default=None, type=int)
    parser.add_argument('--max-items', default=None, type=int)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args()

    if args.save_file and args.save_file.is_file() and not args.overwrite:
        LOGGER.error(f"Evaluation file already exists '{args.save_file}'... "
                     'Set `--overwrite 1` to evaluate anyway.')
        raise SystemExit(1)

    if args.pred_file:
        LOGGER.info(f"Loading predictions from '{args.pred_file}'...")
        preds = np.load(args.pred_file)['pred']
    else:
        if not args.ckpt:
            raise ValueError('Must provide either `--pred-file` or `--ckpt`!')
        cfg = load_yaml(args.cfg_file)['dataset']
        preds = compute_preds(cfg, args.ckpt, args.cfg_model, args.overwrite, device=args.device)

    mean_metrics, _ = compute_eval_metrics(preds, args.cfg_file, args.align_mode,
                                           args.nproc, args.max_items)
    if args.save_file:
        save_metrics(args.save_file, mean_metrics)


if __name__ == '__main__':
    main()
