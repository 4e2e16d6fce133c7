"""Project DDAD LiDAR point clouds into per-frame depth maps (numpy only).

Counterpart of the JAX package's `api/data/preprocess/project_ddad_lidar.py`,
the same files bit for bit: parse each DGP scene JSON, load the camera_01
pose/intrinsics and the synchronized LiDAR points, transform them into the
camera frame, project, and save `<scene_dir>/depth_01/<stem>.npz` (the
nearest point per pixel), which `data.devkits.ddad` reads.

DGP specifics: point clouds are .npz files with a `data` structured array
(X/Y/Z), poses are given per datum as quaternion+translation in the world
frame.

Usage:
    python -m slowtv_monodepth_tpu_torch.project_ddad_lidar [--mode val] [--overwrite 1]
"""
from __future__ import annotations

import json
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from .data.devkits import ddad as dd

__all__ = ['project_scene', 'main']


def _pose_to_T(p: dict) -> np.ndarray:
    q = p['rotation']
    t = p['translation']
    w, x, y, z = q['qw'], q['qx'], q['qy'], q['qz']
    R = np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [t['x'], t['y'], t['z']]
    return T


def _load_points(scene_dir: Path, rec: dict) -> np.ndarray:
    f = scene_dir / rec['filename']
    with np.load(f) as d:
        pts = d['data']
    return np.stack([pts['X'], pts['Y'], pts['Z']], axis=-1).astype(np.float64) \
        if pts.dtype.names else np.asarray(pts, np.float64)[:, :3]


def project_scene(scene_file: Path, overwrite: bool = False) -> None:
    scene_dir = scene_file.parent
    out_dir = scene_dir / 'depth_01'
    out_dir.mkdir(exist_ok=True)
    with open(scene_file) as f:
        scene = json.load(f)

    # Pair camera_01 images with point clouds per sample.
    for sample in scene.get('data', []):
        datum = sample.get('datum', {})
        img = datum.get('image')
        if not img or 'camera_01' not in img.get('filename', '').lower():
            continue
        pc = datum.get('point_cloud')
        if pc is None:
            continue

        stem = Path(img['filename']).stem
        out = out_dir / f'{stem}.npz'
        if out.is_file() and not overwrite:
            continue

        K = dd.Frame(scene_dir, img).load_K()[:3, :3]
        T_w_cam = _pose_to_T(img['pose'])
        T_w_lidar = _pose_to_T(pc['pose'])
        T_cam_lidar = np.linalg.inv(T_w_cam) @ T_w_lidar

        pts = _load_points(scene_dir, pc)
        pts_cam = pts @ T_cam_lidar[:3, :3].T + T_cam_lidar[:3, 3]
        z = pts_cam[:, 2]
        valid = z > 0
        uv = (pts_cam[valid] / z[valid, None]) @ K.T

        h, w = img['height'], img['width']
        u = np.round(uv[:, 0]).astype(int)
        v = np.round(uv[:, 1]).astype(int)
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        depth = np.zeros((h, w), np.float32)
        # Nearest-point z-buffer.
        order = np.argsort(-z[valid][ok])
        depth[v[ok][order], u[ok][order]] = z[valid][ok][order]
        np.savez_compressed(out, depth=depth)


def main() -> None:
    parser = ArgumentParser('Project DDAD LiDAR to per-frame depth maps.')
    parser.add_argument('--mode', default='val')
    parser.add_argument('--overwrite', default=0, type=int)
    args = parser.parse_args()

    root = dd.get_json_file().parent
    with open(dd.get_json_file()) as f:
        meta = json.load(f)
    scenes = meta['scene_splits']['1']['filenames'] if 'scene_splits' in meta \
        else meta[args.mode]
    for sf in scenes:
        print(f'-> {sf}')
        project_scene(root / sf, args.overwrite)


if __name__ == '__main__':
    main()
