"""KITTI Raw Sync devkit: path building, calibration, velodyne projection.

Parity with `src/devkits/kitti_raw.py:14-349`: file layout helpers, calib
parsing (R/K reshaped, P homogeneous), uint16/256 benchmark depth, velodyne
loading + projection with the matlab `-1` rounding convention and min-depth
Z-buffering, OxTS Mercator poses, and optional LinearND interpolation.
Copy of `slowtv_monodepth_tpu/data/devkits/kitti_raw.py`; PIL and scipy
are imported where they are used, so the module imports without them.
"""
from __future__ import annotations

import warnings
from collections import Counter, namedtuple
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import PATHS

__all__ = [
    'SEQS', 'OXTS', 'Item',
    'get_split_file', 'get_image_file', 'get_pose_file',
    'get_velodyne_file', 'get_hint_file', 'get_depth_file',
    'load_calib', 'load_split', 'load_oxts', 'load_pose', 'load_poses',
    'load_velo', 'load_depth_velodyne', 'load_depth',
    'project_velo', 'interp_velo', 'points2depth', 'oxts2pose',
]

Item = namedtuple('KittiItem', 'seq stem cam')

SEQS = ('2011_09_26', '2011_09_28', '2011_09_29', '2011_09_30', '2011_10_03')
OXTS = (
    'lat', 'lon', 'alt',
    'roll', 'pitch', 'yaw',
    'vn', 've', 'vf', 'vl', 'vu',
    'ax', 'ay', 'az', 'af', 'al', 'au',
    'wx', 'wy', 'wz', 'wf', 'wl', 'wu',
    'pos_accuracy', 'vel_accuracy',
    'navstat', 'numsats', 'posmode', 'velmode', 'orimode',
)


# PATH BUILDING
# -----------------------------------------------------------------------------
def get_image_file(seq: str, cam: str, stem: int) -> Path:
    return PATHS['kitti_raw'] / seq / cam / 'data' / f'{stem:010d}.png'


def get_pose_file(seq: str, stem: int) -> Path:
    return PATHS['kitti_raw'] / seq / 'oxts' / 'data' / f'{stem:010d}.txt'


def get_velodyne_file(seq: str, stem: int) -> Path:
    return PATHS['kitti_raw'] / seq / 'velodyne_points' / 'data' / f'{stem:010d}.bin'


def get_hint_file(seq: str, cam: str, stem: int) -> Path:
    return PATHS['kitti_raw'] / 'depth_hints' / seq / cam / f'{stem:010d}.npy'


def get_depth_file(seq: str, cam: str, stem: int) -> Path:
    return (PATHS['kitti_raw'] / 'depth_benchmark' / seq / 'proj_depth'
            / 'groundtruth' / cam / f'{stem:010d}.png')


def get_split_file(split: str, mode: str) -> Path:
    return PATHS['kitti_raw'] / 'splits' / split / f'{mode}_files.txt'
# -----------------------------------------------------------------------------


# LOADING
# -----------------------------------------------------------------------------
def readlines(file) -> list[str]:
    with open(file) as f:
        return f.read().splitlines()


def load_dict(file: Path, header: int = 0, strip: str = ':',
              shape: Optional[Sequence[int]] = None) -> dict:
    """Parse `key: v v v ...` line files into float arrays (ref `:76-97`)."""
    lines = [line.split() for line in readlines(file)][header:]
    d = {}
    for line in lines:
        h, arr = line[0], np.array(line[1:], dtype=np.float32)
        if shape:
            arr = arr.reshape(shape)
        d[h.strip(strip)] = arr
    return d


def load_calib(seq: str):
    """Load cam2cam/imu2velo/velo2cam calib dicts for a sequence (ref `:100-131`)."""
    cam2cam = load_dict(PATHS['kitti_raw'] / seq / 'calib_cam_to_cam.txt', header=1)
    imu2velo = load_dict(PATHS['kitti_raw'] / seq / 'calib_imu_to_velo.txt', header=1)
    velo2cam = load_dict(PATHS['kitti_raw'] / seq / 'calib_velo_to_cam.txt', header=1)
    homo = np.array([0, 0, 0, 1], dtype=float)[None]

    for d in (cam2cam, imu2velo, velo2cam):
        for k, v in d.items():
            if 'R' in k:
                d[k] = v.reshape(3, 3)
            elif 'K' in k:
                d[k] = v.reshape(3, 3)
            elif 'S' in k:
                d[k] = v.astype(int)
            elif 'P' in k:
                d[k] = np.vstack((v.reshape(3, 4), homo))
    return cam2cam, imu2velo, velo2cam


def load_split(file: Path) -> list[str]:
    return readlines(file)


def load_velo(file: Path) -> np.ndarray:
    """(n, 4) velodyne points as (x, y, z, 1) — reflectance replaced."""
    pts = np.fromfile(file, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def load_oxts(file: Path) -> dict:
    return dict(zip(OXTS, np.loadtxt(file, dtype=np.float32)))


def load_pose(file: Path) -> np.ndarray:
    return oxts2pose(load_oxts(file))


def load_poses(seq: str, drive: int) -> np.ndarray:
    oxts_dir = PATHS['kitti_raw'] / seq / f'{seq}_drive_{drive:04}_sync' / 'oxts' / 'data'
    return np.stack([load_pose(file) for file in sorted(oxts_dir.iterdir())])


def load_depth_velodyne(file: Path, velo2cam: dict, cam2cam: dict, cam: int,
                        use_velo_depth: bool = False,
                        interpolate: bool = False) -> np.ndarray:
    """Project a velodyne scan into a sparse (h, w) depth map (ref `:180-208`)."""
    Pi = np.eye(4)
    Pi[:3, :3] = cam2cam['R_rect_00']
    Pi = cam2cam[f'P_rect_{cam:02}'] @ Pi

    Tr = np.eye(4, dtype=np.float32)
    Tr[:3, :3] = velo2cam['R']
    Tr[:3, 3] = velo2cam['T']

    return points2depth(
        pts=load_velo(file), size=cam2cam[f'S_rect_{cam:02}'], Pi=Pi, Tr=Tr,
        use_velo_depth=use_velo_depth, interp=interpolate)


def load_depth(file: Path) -> np.ndarray:
    """KITTI benchmark depth png: uint16 / 256 (NOT 255; ref `:211-219`)."""
    from PIL import Image
    depth = Image.open(file)
    return np.array(depth, dtype=np.float32) / 256.0
# -----------------------------------------------------------------------------


# CONVERSIONS
# -----------------------------------------------------------------------------
def oxts2pose(oxts: dict) -> np.ndarray:
    """OxTS GPS/IMU -> 4x4 pose (Mercator translation; ref `:226-251`)."""
    earth_radius = 6378137
    scale = np.cos(oxts['lat'] * np.pi / 180.0)
    mercator_x = scale * oxts['lon'] * np.pi * earth_radius / 180
    mercator_y = scale * earth_radius * np.log(np.tan((90 + oxts['lat']) * np.pi / 360))
    t = np.array([mercator_x, mercator_y, oxts['alt']])

    rx, ry, rz = oxts['roll'], oxts['pitch'], oxts['yaw']
    Rx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
    Ry = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0], [-np.sin(ry), 0, np.cos(ry)]])
    Rz = np.array([[np.cos(rz), -np.sin(rz), 0], [np.sin(rz), np.cos(rz), 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx

    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def points2depth(pts: np.ndarray, size: Sequence[int], Pi: np.ndarray, Tr: np.ndarray,
                 use_velo_depth: bool, interp: bool) -> np.ndarray:
    """Pointcloud -> sparse depth map with min-Z dedup (ref `:254-296`)."""
    if use_velo_depth:
        warnings.warn('Using raw velodyne depth... Only for legacy Kitti Eigen GT.')

    w, h = size
    pc_img, valid = project_velo(pts, Pi, Tr, size, use_velo_depth=use_velo_depth)
    pc_img = pc_img[valid]

    if interp:
        return interp_velo((h, w), pc_img)

    xs, ys = pc_img[:, :2].T.astype(int)
    depth = np.zeros((h, w), dtype=np.float32)
    depth[ys, xs] = pc_img[:, 2]

    # Z-buffer duplicates: keep the nearest point (quirky flat index kept for
    # bit-parity with the reference's generated ground truth).
    idxs = ys * (w - 1) + xs - 1
    dup = (item for item, count in Counter(idxs).items() if count > 1)
    for idx in dup:
        pts_i = np.where(idxs == idx)[0]
        x, y = xs[pts_i[0]], ys[pts_i[0]]
        depth[y, x] = pc_img[pts_i, 2].min()
    return depth.clip(min=0)


def project_velo(pts: np.ndarray, P: np.ndarray, Tr: np.ndarray, size: Sequence[int],
                 T: np.ndarray = np.eye(4), use_velo_depth: bool = False):
    """Project LiDAR points to (u, v, depth) + validity (ref `:299-329`)."""
    w, h = size
    pts_img = P @ Tr @ T @ pts.T
    pts_img = pts_img[:3]
    pts_img[:2] /= pts_img[-1][None]
    if use_velo_depth:
        pts_img[2] = pts[:, 0]

    pts_img[:2] = pts_img[:2].round() - 1  # Match the Kitti matlab devkit.
    valid_u = (pts_img[0] >= 0) & (pts_img[0] < w)
    valid_v = (pts_img[1] >= 0) & (pts_img[1] < h)
    valid_z = pts[:, 0] >= 0

    return pts_img.T, valid_u & valid_v & valid_z


def interp_velo(shape: tuple, pts: np.ndarray) -> np.ndarray:
    """LinearND-interpolated dense depth (ref `:332-347`)."""
    from scipy.interpolate import LinearNDInterpolator
    h, w = shape
    xy, d = pts[:, 1::-1], pts[:, 2]
    interp = LinearNDInterpolator(xy, d, fill_value=0)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    coords = np.vstack((ys.flatten(), xs.flatten())).T
    return interp(coords).reshape(shape)
