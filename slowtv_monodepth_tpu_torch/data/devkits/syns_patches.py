"""SYNS-Patches devkit (ref `src/devkits/syns_patches.py:14-129`).

Paths + scene info/category parsing + the virtual KITTI-FOV intrinsics.
Copy of `slowtv_monodepth_tpu/data/devkits/syns_patches.py`.
"""
from __future__ import annotations

from collections import namedtuple
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = [
    'Item', 'SUBDIRS', 'KITTI_FOV', 'KITTI_SHAPE',
    'get_split_file', 'get_scenes', 'get_scene_files', 'get_info_file',
    'get_image_file', 'get_depth_file', 'get_edges_file',
    'load_info', 'load_category', 'load_split', 'load_intrinsics',
]

Item = namedtuple('SynsItem', 'seq stem')

SUBDIRS = [
    'images', 'masks', 'depths', 'edges',
    'edges_01', 'edges_01_log', 'edges_01_inv',
    'edges_02', 'edges_02_log', 'edges_02_inv',
    'edges_03', 'edges_03_log', 'edges_03_inv',
]

KITTI_FOV = (25.46, 84.10)
KITTI_SHAPE = (376, 1242)


def get_split_file(mode: str) -> Path:
    return PATHS['syns_patches'] / 'splits' / f'{mode}_files.txt'


def get_scenes() -> list:
    return sorted(p for p in PATHS['syns_patches'].iterdir()
                  if p.is_dir() and p.stem != 'splits')


def get_scene_files(scene_dir: Path) -> dict:
    return {key: sorted((scene_dir / key).iterdir())
            for key in SUBDIRS if (scene_dir / key).is_dir()}


def get_info_file(scene: str) -> Path:
    paths = (PATHS['syns_patches'] / scene).iterdir()
    return next(f for f in paths if f.suffix == '.txt')


def get_image_file(scene: str, file: str) -> Path:
    return PATHS['syns_patches'] / scene / 'images' / file


def get_depth_file(scene: str, file: str) -> Path:
    return (PATHS['syns_patches'] / scene / 'depths' / file).with_suffix('.npy')


def get_edges_file(scene: str, subdir: str, file: str) -> Path:
    assert 'edges' in subdir, f'Must provide an "edges" directory. ({subdir})'
    assert subdir in SUBDIRS, f'Non-existent edges directory. ({subdir})'
    return PATHS['syns_patches'] / scene / subdir / file


def load_info(scene: str) -> list:
    with open(get_info_file(scene), encoding='latin-1') as f:
        return f.read().splitlines()


def load_category(scene: str):
    info = load_info(scene)
    category = info[1].replace('Scene Category: ', '')
    try:
        cat, subcat = category.split(': ')
    except ValueError:
        cat, subcat = category.split(' - ')
    return cat, subcat


def load_split(mode: str):
    file = get_split_file(mode)
    with open(file) as f:
        items = [Item(*line.split()) for line in f.read().splitlines()]
    return file, items


def load_intrinsics() -> np.ndarray:
    """Virtual KITTI-FOV camera intrinsics, padded to (4, 4)
    (ref `syns_patches.py:107-127`, trig from the desired FOV)."""
    Fy, Fx = KITTI_FOV
    h, w = KITTI_SHAPE
    cx, cy = w // 2, h // 2
    fx = cx / np.tan(np.deg2rad(Fx) / 2)
    fy = cy / np.tan(np.deg2rad(Fy) / 2)
    K = np.array([
        [fx, 0, cx, 0],
        [0, fy, cy, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ], dtype=np.float32)
    return K
