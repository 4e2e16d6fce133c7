"""Visual smoke-test CLI for any registered dataset.

Copy of `slowtv_monodepth_tpu/data/play.py`. The reference eyeballs each
dataset through per-file `__main__` blocks that instantiate it and call
`.play()` (e.g. `src/datasets/kitti_raw.py:201-207`); this exposes the same
capability once, for every registry entry:

    python -m slowtv_monodepth_tpu_torch.data.play kitti --mode train \\
        --kw "{shape: [192, 640], supp_idxs: [-1, 1]}" --fps 2

Any dataset-constructor field rides in through `--kw` (YAML dict). Requires
yaml, matplotlib and the dataset's data root (`PATHS.yaml` / env, `paths.py`).
"""
from __future__ import annotations

from argparse import ArgumentParser


def main():
    import yaml

    from ..registry import DATA_REG, trigger_datasets

    trigger_datasets()
    ap = ArgumentParser(description='Iterate a dataset and display items.')
    ap.add_argument('type', help='Registered dataset type.')
    ap.add_argument('--mode', default='train', help='Split mode (train/val/test).')
    ap.add_argument('--kw', default='{}', type=yaml.safe_load,
                    help='YAML dict of extra dataset-constructor args.')
    ap.add_argument('--fps', default=1.0, type=float)
    ap.add_argument('--skip', default=1, type=int)
    ap.add_argument('--reverse', action='store_true')
    args = ap.parse_args()

    if args.type not in DATA_REG:
        raise SystemExit(f'Unknown dataset "{args.type}". ({sorted(DATA_REG)})')
    ds = DATA_REG[args.type](mode=args.mode, **(args.kw or {}))
    print(f'{type(ds).__name__}: {len(ds)} items')
    ds.play(fps=args.fps, skip=args.skip, reverse=args.reverse)


if __name__ == '__main__':
    main()
