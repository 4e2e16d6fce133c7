"""SlowTV devkit: paths, splits, categories, COLMAP intrinsics.

Copy of `slowtv_monodepth_tpu/data/devkits/slow_tv.py`; parity with
`src/devkits/slow_tv.py:14-97` (path building + loading). The
dataset-creation half of the reference devkit (ffmpeg frame extraction,
decimation, split generation, COLMAP estimation, `slow_tv.py:100-243`) lives
in `api/data` tooling.
"""
from __future__ import annotations

from collections import namedtuple
from pathlib import Path
from typing import Union

import numpy as np

from . import PATHS

__all__ = ['Item', 'get_url_file', 'get_category_file', 'get_vid_files',
           'get_split_file', 'get_seqs', 'get_intrinsics_file', 'get_img_file',
           'load_categories', 'load_split', 'load_intrinsics']

Item = namedtuple('SlowTvItem', 'seq stem')


def get_url_file() -> Path:
    return PATHS['slow_tv'] / 'splits' / 'urls.txt'


def get_category_file() -> Path:
    return PATHS['slow_tv'] / 'splits' / 'categories.txt'


def get_vid_files() -> list:
    return sorted(f for f in (PATHS['slow_tv'] / 'videos').iterdir() if f.suffix == '.mp4')


def get_split_file(mode: str, split: str) -> Path:
    return PATHS['slow_tv'] / 'splits' / f'{split}' / f'{mode}_files.txt'


def get_seqs() -> tuple:
    root = PATHS['slow_tv']
    dirs = sorted(d.stem for d in root.iterdir()
                  if d.is_dir() and d.stem not in {'splits', 'videos', 'colmap'})
    return tuple(dirs)


def get_intrinsics_file(seq: str) -> Path:
    return PATHS['slow_tv'] / seq / 'intrinsics.txt'


def get_img_file(seq: str, stem: Union[str, int]) -> Path:
    return PATHS['slow_tv'] / seq / f'{int(stem):010}.png'


def load_categories(subcats: bool = True) -> list:
    with open(get_category_file()) as f:
        lines = [line.lower() for line in f.read().splitlines()]
    if not subcats:
        lines = [line.split('-')[0] for line in lines]
    return lines


def load_split(mode: str, split: str):
    file = get_split_file(mode, split)
    with open(file) as f:
        items = [Item(*line.split()) for line in f.read().splitlines()]
    return file, items


def load_intrinsics(seq: str) -> np.ndarray:
    """COLMAP-estimated intrinsics as a (4, 4) txt matrix."""
    return np.loadtxt(get_intrinsics_file(seq), dtype=np.float32)
