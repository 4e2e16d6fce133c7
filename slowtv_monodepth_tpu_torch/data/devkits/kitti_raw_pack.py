"""KITTI pack-store devkit (ref `src/devkits/kitti_raw_lmdb.py:14-186`).

Per-drive/cam record databases over PackDB (the LMDB replacement): images,
benchmark depths, velodyne pointclouds (projected on read), SGBM hints,
calibration and OxTS poses. Registry key stays `kitti_lmdb` so reference
configs run unchanged.
Copy of `slowtv_monodepth_tpu/data/devkits/kitti_raw_pack.py`.
"""
from __future__ import annotations

from collections import namedtuple
from pathlib import Path

import numpy as np

from ...databases import ImageDatabase, LabelDatabase
from . import PATHS, kitti_raw as kr

__all__ = [
    'Item', 'get_split_file', 'load_split', 'load_calib', 'load_images',
    'load_velos', 'load_velo_depths', 'load_depths', 'load_hints',
    'load_oxts', 'load_poses', 'PoseDatabase', 'DepthVeloDatabase', 'DepthDatabase',
]

Item = namedtuple('KittiItem', 'seq stem cam')


class PoseDatabase(LabelDatabase):
    """OxTS records -> 4x4 poses on read."""

    def __getitem__(self, item):
        oxts = super().__getitem__(item)
        if isinstance(item, list):
            return [kr.oxts2pose(o) for o in oxts]
        return kr.oxts2pose(oxts)


class DepthVeloDatabase(LabelDatabase):
    """Pointcloud records -> sparse depth maps on read (keyed (stem, cam))."""

    def __init__(self, calib_db: LabelDatabase, path, use_velo_depth: bool = False,
                 interp: bool = False, **kwargs):
        super().__init__(path, **kwargs)
        self.calib_db = calib_db
        self.use_velo_depth = use_velo_depth
        self.interp = interp
        self.Pi = np.eye(4)
        self.Pi[:3, :3] = calib_db['cam2cam/R_rect_00']
        self.Tr = np.eye(4, dtype=np.float32)
        self.Tr[:3, :3] = calib_db['velo2cam/R']
        self.Tr[:3, 3] = calib_db['velo2cam/T']

    def points2depth(self, pts: np.ndarray, cam: int) -> np.ndarray:
        return kr.points2depth(
            pts=pts, size=self.calib_db[f'cam2cam/S_rect_{cam:02}'],
            Pi=self.calib_db[f'cam2cam/P_rect_{cam:02}'] @ self.Pi, Tr=self.Tr,
            use_velo_depth=self.use_velo_depth, interp=self.interp)

    def __getitem__(self, item):
        key, cam = item
        pts = super().__getitem__(key)
        if isinstance(key, list):
            return [self.points2depth(p, cam) for p in pts]
        return self.points2depth(pts, cam)


class DepthDatabase(ImageDatabase):
    """Benchmark uint16 depth png records -> float32 metres (/256)."""

    def _convert_value(self, value: bytes) -> np.ndarray:
        import io
        from PIL import Image
        return np.array(Image.open(io.BytesIO(value)), dtype=np.float32) / 256.0


# PATHS (layout mirrors the raw tree under the *_lmdb data root).
# -----------------------------------------------------------------------------
def get_split_file(split: str, mode: str) -> Path:
    return PATHS['kitti_raw_lmdb'] / 'splits' / split / f'{mode}_files.txt'


def load_split(file: Path) -> list:
    with open(file) as f:
        return f.read().splitlines()


def load_calib(seq: str) -> LabelDatabase:
    return LabelDatabase(PATHS['kitti_raw_lmdb'] / seq / 'calibration')


def load_images(seq: str, drive: str, cam: str) -> ImageDatabase:
    return ImageDatabase(PATHS['kitti_raw_lmdb'] / seq / drive / cam / 'data')


def load_velos(seq: str, drive: str) -> LabelDatabase:
    return LabelDatabase(PATHS['kitti_raw_lmdb'] / seq / drive / 'velodyne_points' / 'data')


def load_velo_depths(seq: str, drive: str, calib_db, use_velo_depth=False,
                     interp=False) -> DepthVeloDatabase:
    return DepthVeloDatabase(
        calib_db=calib_db,
        path=PATHS['kitti_raw_lmdb'] / seq / drive / 'velodyne_points' / 'data',
        use_velo_depth=use_velo_depth, interp=interp)


def load_hints(seq: str, drive: str, cam: str) -> LabelDatabase:
    return LabelDatabase(PATHS['kitti_raw_lmdb'] / 'depth_hints' / seq / drive / cam)


def load_depths(seq: str, drive: str, cam: str) -> DepthDatabase:
    return DepthDatabase(PATHS['kitti_raw_lmdb'] / 'depth_benchmark' / seq / drive
                         / 'proj_depth' / 'groundtruth' / cam)


def load_oxts(seq: str, drive: str) -> LabelDatabase:
    return LabelDatabase(PATHS['kitti_raw_lmdb'] / seq / drive / 'oxts' / 'data')


def load_poses(seq: str, drive: str) -> PoseDatabase:
    return PoseDatabase(PATHS['kitti_raw_lmdb'] / seq / drive / 'oxts' / 'data')
