"""Export ground-truth evaluation targets -> `targets_<mode>.npz` (PyTorch port).

Counterpart of `api/data/export_gt/from_dataset.py` (any registered dataset:
{depth, [K], [edge], [cat], [subcat]} next to its split file) and
`api/data/export_gt/kitti.py` (KITTI: the Eigen split takes the raw velodyne
depth, legacy on purpose as the published numbers do; the other splits the
corrected benchmark depth; depths as an object array, because image sizes
differ between drives). These are the files `eval_depth` reads.

One repair of the JAX script, which reads every item's `K` and so cannot
export DIODE, NYUD-v2 or TUM-RGBD (their datasets have no intrinsics): `K`
is written when the dataset gives it (the evaluator needs it only for the
pointcloud metrics, which those cfgs do not ask for), and DIODE's valid
mask, where exported (`--datum "image depth mask"`), zeroes the depth it
marks invalid.

Usage:
    slowtv-export-gt-torch --type syns_patches --mode test --datum "image depth edge K"
    slowtv-export-gt-kitti-torch --split eigen
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np

from . import parsers

__all__ = ['export', 'export_kitti', 'main', 'main_kitti']


def _save_file(split_file: Path, save_stem: str, overwrite: bool) -> Path:
    save_file = split_file.parent / f'{save_stem}.npz'
    if not overwrite and save_file.is_file():
        raise FileExistsError(f'Target file "{save_file}" exists. Use `--overwrite 1`.')
    return save_file


def export(ds_type: str, mode: str, datum: str, save_stem: str,
           overwrite: bool = False, **kw) -> Path:
    """A registered dataset's `mode` split -> its targets npz; returns the file."""
    ds = next(iter(parsers.get_ds(
        {ds_type: {'mode': mode, 'datum': datum, 'use_aug': False,
                   'log_time': False, **kw}}).values()))
    save_file = _save_file(ds.split_file, save_stem, overwrite)

    depths, Ks, edges, cats, subcats = [], [], [], [], []
    for i in range(len(ds)):
        _, y, m = ds[i]
        depth = y['depth'][..., 0]
        if 'mask' in y:
            depth = np.where(y['mask'][..., 0], depth, np.float32(0))
        depths.append(depth)
        if 'K' in y:
            Ks.append(y['K'])
        if 'edges' in y:
            edges.append(y['edges'][..., 0])
        if 'cat' in m:
            cats.append(m['cat'])
            subcats.append(m.get('subcat', ''))

    arrs = {'depth': np.array(depths) if len({d.shape for d in depths}) == 1
            else np.array(depths, dtype=object)}
    if Ks:
        arrs['K'] = np.array(Ks)
    if edges:
        arrs['edge'] = np.array(edges)
    if cats:
        arrs['cat'] = np.array(cats)
        arrs['subcat'] = np.array(subcats)

    print(f'-> Saving {len(depths)} targets to "{save_file}"...')
    np.savez_compressed(save_file, **arrs)
    return save_file


def export_kitti(depth_split: str, mode: str = 'test', use_velo_depth: Optional[bool] = None,
                 save_stem: Optional[str] = None, overwrite: bool = False) -> Path:
    """KITTI's `depth_split` -> its targets npz; returns the file. The split's
    test list is read whatever `mode` names the file, as the JAX script does."""
    from .data.devkits import kitti_raw as kr
    if use_velo_depth is None:
        use_velo_depth = depth_split == 'eigen'
    print(f'\n-> Exporting ground truth depths for KITTI "{depth_split}/{mode}"...')
    split_file = kr.get_split_file(depth_split, mode='test')
    save_file = _save_file(split_file, save_stem or f'targets_{mode}', overwrite)
    items = [{'seq': line[0], 'cam': 2 if line[2] == 'l' else 3, 'stem': int(line[1])}
             for line in (line.split() for line in kr.load_split(split_file))]

    depths, Ks = [], []
    for d in items:
        cam2cam, _, velo2cam = kr.load_calib(d['seq'].split('/')[0])
        if use_velo_depth:
            file = kr.get_velodyne_file(d['seq'], d['stem'])
            depth = kr.load_depth_velodyne(file, velo2cam, cam2cam, cam=d['cam'],
                                           use_velo_depth=use_velo_depth)
        else:
            depth = kr.load_depth(kr.get_depth_file(d['seq'], f'image_0{d["cam"]}', d['stem']))
        depths.append(depth)
        Ks.append(cam2cam[f'K_0{d["cam"]}'])

    print(f'\n-> Saving to "{save_file}"...')
    np.savez_compressed(save_file, depth=np.array(depths, dtype=object), K=np.array(Ks))
    return save_file


def main() -> None:
    parser = ArgumentParser('Export GT evaluation targets from a dataset.')
    parser.add_argument('--type', required=True, help='Registered dataset key.')
    parser.add_argument('--mode', default='test')
    parser.add_argument('--datum', default='image depth K')
    parser.add_argument('--save-stem', default=None)
    parser.add_argument('--overwrite', default=0, type=int)
    parser.add_argument('--kw', action='append', default=[],
                        help='Extra dataset kwargs as key=value (e.g. --kw scene=indoors).')
    args = parser.parse_args()
    kw = dict(item.split('=', 1) for item in args.kw)
    export(args.type, args.mode, args.datum, args.save_stem or f'targets_{args.mode}',
           args.overwrite, **kw)


def main_kitti() -> None:
    parser = ArgumentParser('Export KITTI target depths as npz.')
    parser.add_argument('--split', required=True,
                        choices={'eigen', 'eigen_benchmark', 'eigen_zhou'})
    parser.add_argument('--mode', default='test', choices={'train', 'val', 'test'})
    parser.add_argument('--use-velo-depth', default=None, type=int)
    parser.add_argument('--save-stem', default=None)
    parser.add_argument('--overwrite', default=0, type=int)
    args = parser.parse_args()
    export_kitti(args.split, args.mode,
                 None if args.use_velo_depth is None else bool(args.use_velo_depth),
                 args.save_stem, args.overwrite)


if __name__ == '__main__':
    main()
