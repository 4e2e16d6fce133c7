"""MapFreeReloc devkit (ref `src/devkits/mapfreereloc.py:14-101`): jpg frames,
mm-encoded depth PNGs per source (e.g. dptkitti), per-scene intrinsics/poses.

Copy of `slowtv_monodepth_tpu/data/devkits/mapfreereloc.py` (PIL imported
where an image is opened)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = ['Item', 'create_split_file']


def create_split_file(mode: str = 'train') -> None:
    split_file = PATHS['mapfree'] / 'splits' / f'{mode}_files.txt'
    split_file.parent.mkdir(parents=True, exist_ok=True)
    files = sorted((PATHS['mapfree'] / mode).glob('./*/seq?/*.jpg'))
    with open(split_file, 'w') as f:
        f.writelines(f'{p.parent.parent.stem} {p.parent.stem} {p.stem}\n' for p in files)


@dataclass
class Item:
    mode: str   # {train, val, test}
    scene: str  # s{i:05}
    seq: str    # seq[0, 1]
    stem: str   # frame_{i:05}

    @classmethod
    def get_split_file(cls, mode: str) -> Path:
        return PATHS['mapfree'] / 'splits' / f'{mode}_files.txt'

    @classmethod
    def load_split(cls, mode: str) -> list:
        with open(cls.get_split_file(mode)) as f:
            return [cls(mode, *s.split()) for s in f.read().splitlines()]

    def get_img_file(self) -> Path:
        return PATHS['mapfree'] / self.mode / self.scene / self.seq / f'{self.stem}.jpg'

    def get_depth_file(self, src: str) -> Path:
        return PATHS['mapfree'] / self.mode / self.scene / self.seq / f'{self.stem}.{src}.png'

    def get_intrinsics_file(self) -> Path:
        return PATHS['mapfree'] / self.mode / self.scene / 'intrinsics.txt'

    def get_poses_file(self) -> Path:
        return PATHS['mapfree'] / self.mode / self.scene / 'poses.txt'

    def load_img(self):
        from PIL import Image
        return Image.open(self.get_img_file())

    def load_depth(self, src: str) -> np.ndarray:
        """Depth PNG encoded in millimetres."""
        from PIL import Image
        depth = np.array(Image.open(self.get_depth_file(src)), dtype=np.float32)
        return depth[..., None] / 1000

    def load_intrinsics(self) -> np.ndarray:
        """Per-scene intrinsics file rows: `seq/frame.jpg fx fy cx cy w h`."""
        with open(self.get_intrinsics_file()) as f:
            lines = [line.split() for line in f.read().splitlines()]
        stem = f'{self.seq}/{self.stem}.jpg'
        line = next(ln for ln in lines if ln[0] == stem)
        fx, fy, cx, cy = map(float, line[1:5])
        K = np.zeros((4, 4), dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2], K[2, 2], K[3, 3] = fx, fy, cx, cy, 1, 1
        return K

    def load_pose(self) -> np.ndarray:
        """Per-scene poses file rows: `seq/frame.jpg qw qx qy qz tx ty tz`."""
        with open(self.get_poses_file()) as f:
            lines = [line.split() for line in f.read().splitlines()]
        stem = f'{self.seq}/{self.stem}.jpg'
        line = next(ln for ln in lines if ln[0] == stem)
        qw, qx, qy, qz = map(float, line[1:5])
        t = np.array(list(map(float, line[5:8])), np.float32)

        # Quaternion -> R (w, x, y, z convention; ref `geometry.py:143-159`).
        w, x, y, z = qw, qx, qy, qz
        R = np.array([
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return T
