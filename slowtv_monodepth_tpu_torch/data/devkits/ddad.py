"""DDAD devkit: a lightweight reader for DGP-format scene JSONs.

Copy of `slowtv_monodepth_tpu/data/devkits/ddad.py` (PIL imported where an
image is opened). The reference wraps the vendored TRI DGP devkit
(`src/datasets/ddad.py:17-23`) only to iterate `camera_01` frames and their
LiDAR depth on the val split; this reads the DGP scene JSONs directly.

Expected layout (from the official ddad.tar): `<root>/ddad_train_val/
ddad.json` referencing `<scene_dir>/scene_<hash>.json`, each with
`data[*].datum.image` entries for camera_01 (+ point_cloud for lidar).
LiDAR depth maps must be pre-projected to `<scene_dir>/depth_01/<stem>.npz`
by `python -m slowtv_monodepth_tpu_torch.project_ddad_lidar` or the JAX
package's `api/data/preprocess/project_ddad_lidar.py` (the same files; the
missing-file message names the latter, as the JAX devkit's does).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = ['get_json_file', 'load_scenes', 'Frame']


def get_json_file() -> Path:
    return PATHS['ddad'] / 'ddad_train_val' / 'ddad.json'


class Frame:
    """One synchronized camera_01 sample."""

    def __init__(self, scene_dir: Path, image_rec: dict):
        self.scene_dir = scene_dir
        self.rec = image_rec

    @property
    def img_file(self) -> Path:
        return self.scene_dir / self.rec['filename']

    @property
    def depth_file(self) -> Path:
        stem = Path(self.rec['filename']).stem
        return self.scene_dir / 'depth_01' / f'{stem}.npz'

    def load_img(self):
        from PIL import Image
        return Image.open(self.img_file)

    def load_depth(self) -> np.ndarray:
        if not self.depth_file.is_file():
            raise FileNotFoundError(
                f'Missing projected LiDAR depth "{self.depth_file}". Run '
                'api/data/preprocess/project_ddad_lidar.py first.')
        return np.load(self.depth_file)['depth'].astype(np.float32)[..., None]

    def load_K(self) -> np.ndarray:
        i = self.rec['intrinsics']
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = i['fx'], i['fy'], i['cx'], i['cy']
        return K


def load_scenes(mode: str = 'val', camera: str = 'CAMERA_01') -> list:
    """All `camera` frames of every scene in the split, in scene order."""
    root = get_json_file().parent
    with open(get_json_file()) as f:
        meta = json.load(f)

    split_key = {'train': 'train', 'val': 'val'}[mode]
    scene_files = meta['scene_splits'][
        {'train': '0', 'val': '1'}.get(split_key, split_key)]['filenames'] \
        if 'scene_splits' in meta else meta[split_key]

    frames = []
    for sf in scene_files:
        scene_file = root / sf
        scene_dir = scene_file.parent
        with open(scene_file) as f:
            scene = json.load(f)
        for sample in scene.get('data', []):
            datum = sample.get('datum', {})
            img = datum.get('image')
            if img and camera.lower() in img.get('filename', '').lower():
                frames.append(Frame(scene_dir, img))
    return frames
