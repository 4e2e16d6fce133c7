"""Generate MapFreeReloc depth predictions in the challenge's format (PyTorch port).

Counterpart of the JAX package's `api/mapfree/generate_preds.py`: predict
scaleless disparity per frame on `--device` (default `cuda`), in batches of
`BATCH_SIZE` (16), then per item on the host: upsample to the target's shape
(`utils.resize`, bitwise `cv2.INTER_LINEAR`), least-squares align in
disparity space against the DPT metric baseline depth
(`MonoDepthEvaluator._align_lsqr`), and write the depth as a uint16 PNG in
millimetres (`utils.png`; `(depth * 1000).astype(np.uint16)` as the JAX
script writes it, truncated and wrapped above 65.535 m alike) next to each
frame, as `<stem>.<name>.png`. `api/mapfree/evaluate.sh` reads those files.

The writes run in a forked Pool, so the per-item path stays numpy only. A
write that fails raises here: the JAX script never reads its `map_async`
results, so a failed item is lost without a word. Predicting over several
devices (`--devices` above 1) is ROADMAP A11.

Usage:
    slowtv-mapfree-preds-torch --ckpt models/kbr/base/42/models/last.ckpt \\
        --name kbr --mode val --depth-src dptkitti
"""
from __future__ import annotations

import multiprocessing
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np

from . import LOGGER
from .data import DataLoader
from .data.devkits import mapfreereloc as mfr
from .eval.evaluator import MonoDepthEvaluator, _to_inv
from .export_preds import load_predictor, make_dataset
from .utils.png import write_png16
from .utils.resize import resize

__all__ = ['process_single_pred', 'upsample', 'align', 'save_depth_image',
           'process_batch_preds', 'compute_preds', 'main']

BATCH_SIZE = 16  # frames per forward, as the JAX script predicts them


def process_single_pred(args) -> None:
    target, pred, file = args
    pred = upsample(pred, target)
    pred = align(pred, target)
    save_depth_image(file, pred)


def upsample(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    if pred.shape == target.shape:
        return pred
    return resize(pred, target.shape, 'bilinear')


def align(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """LSQR-align disparity against the metric baseline, convert to depth."""
    mask = (target > 0) & (target < 100)
    scale, shift = MonoDepthEvaluator._align_lsqr(pred[mask], _to_inv(target[mask]))
    return _to_inv(scale * pred + shift)


def save_depth_image(path, depth: np.ndarray) -> None:
    write_png16(path, (depth * 1000).astype(np.uint16))


def process_batch_preds(batch, preds: np.ndarray, name: str, pool, results: list) -> None:
    """Queue a batch's writes on `pool`; their `AsyncResult`s go to `results`."""
    m = batch[2]
    files = [mfr.Item(*items).get_depth_file(name)
             for items in zip(m['mode'], m['scene'], m['seq'], m['stem'])]
    targets = np.asarray(batch[1]['depth'])[..., 0]
    results.append(pool.map_async(process_single_pred, zip(targets, preds[..., 0], files)))


def compute_preds(name: str, cfg: Optional[dict], ckpt: str, cfg_model=None,
                  overwrite: bool = False, devices: int = 1, device='cuda',
                  num_workers: int = 8, ds=None) -> int:
    """Predict and write every item of the `mapfree` dataset cfg (or of the
    dataset `ds`, which then stands in for `cfg`) -> the number of files
    written. Raises if any write failed."""
    if devices and devices > 1:
        raise NotImplementedError(f'`devices={devices}`: predicting over a mesh is not ported '
                                  'yet; ROADMAP queue A item 11.')
    predictor, net = load_predictor(ckpt, cfg_model, overwrite, device)
    if ds is None:
        ds = make_dataset(cfg, predictor)
    dl = DataLoader(ds, batch_size=BATCH_SIZE, num_workers=num_workers, shuffle=False,
                    drop_last=False)

    LOGGER.info('Computing predictions...')
    results = []
    with multiprocessing.get_context('fork').Pool() as pool:
        predictor.apply(net, dl, func=process_batch_preds, name=name, pool=pool,
                        results=results)
        n = sum(len(r.get()) for r in results)  # re-raises a failed write
        pool.close()
        pool.join()
    return n


def main() -> None:
    parser = ArgumentParser(description='Generate MapFreeReloc depth predictions.')
    parser.add_argument('--ckpt', required=True, type=str)
    parser.add_argument('--name', type=str, required=True)
    parser.add_argument('--mode', type=str, default='val')
    parser.add_argument('--depth-src', type=str, default='dptkitti',
                        choices={'dptkitti', 'dptnyud'})
    parser.add_argument('--cfg-model', default=None, nargs='*', type=Path)
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--devices', default=1, type=int, help='> 1: ROADMAP A11.')
    args = parser.parse_args()

    cfg = dict(type='mapfree', mode=args.mode, depth_src=args.depth_src, datum='image depth')
    n = compute_preds(args.name, cfg, args.ckpt, cfg_model=args.cfg_model,
                      devices=args.devices, device=args.device)
    LOGGER.info(f'Wrote {n} predictions.')


if __name__ == '__main__':
    main()
