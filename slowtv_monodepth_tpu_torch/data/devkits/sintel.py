"""MPI Sintel devkit (ref `src/devkits/sintel.py:1-107`): .dpt depth + .cam
intrinsics in the official devkit binary format (TAG_FLOAT check).

Copy of `slowtv_monodepth_tpu/data/devkits/sintel.py` (PIL imported where an
image is opened)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = ['Item', 'TAG_FLOAT', 'create_splits']

TAG_FLOAT = 202021.25  # Endianness canary from the official devkit.


def create_splits() -> None:
    """Train split from all left-camera .cam files (ref `:19-27`)."""
    split_file = PATHS['sintel'] / 'splits' / 'train_files.txt'
    split_file.parent.mkdir(parents=True, exist_ok=True)
    files = sorted((PATHS['sintel'] / 'train' / 'camdata_left').glob('**/*.cam'))
    with open(split_file, 'w') as f:
        f.writelines(f'{p.parent.stem} {p.stem}\n' for p in files)


@dataclass
class Item:
    mode: str  # {train} (the official training split is our test set)
    seq: str
    stem: str  # frame_{i:04}

    @classmethod
    def get_split_file(cls, mode: str) -> Path:
        return PATHS['sintel'] / 'splits' / f'{mode}_files.txt'

    @classmethod
    def load_split(cls, mode: str) -> list:
        with open(cls.get_split_file(mode)) as f:
            return [cls(mode, *s.split()) for s in f.read().splitlines()]

    def get_img_file(self) -> Path:
        return PATHS['sintel'] / self.mode / 'final' / self.seq / f'{self.stem}.png'

    def get_depth_file(self) -> Path:
        return PATHS['sintel'] / self.mode / 'depth' / self.seq / f'{self.stem}.dpt'

    def get_cam_file(self) -> Path:
        return PATHS['sintel'] / self.mode / 'camdata_left' / self.seq / f'{self.stem}.cam'

    def load_img(self):
        from PIL import Image
        return Image.open(self.get_img_file())

    def load_depth(self) -> np.ndarray:
        """Official .dpt format: f32 tag, i32 w/h, f32 raster."""
        with open(self.get_depth_file(), 'rb') as f:
            check = np.fromfile(f, dtype=np.float32, count=1)[0]
            assert check == TAG_FLOAT, f'Wrong tag in depth file ({check} vs. {TAG_FLOAT}).'
            w = np.fromfile(f, dtype=np.int32, count=1)[0]
            h = np.fromfile(f, dtype=np.int32, count=1)[0]
            numel = w * h
            assert w > 0 and h > 0 and 1 < numel < 100000000, f'Wrong size ({w=}, {h=})'
            depth = np.fromfile(f, dtype=np.float32, count=-1).reshape((h, w))[..., None]
        return depth

    def load_intrinsics(self) -> np.ndarray:
        """Official .cam format: f32 tag, f64 3x3 K (+3x4 extrinsics)."""
        with open(self.get_cam_file(), 'rb') as f:
            check = np.fromfile(f, dtype=np.float32, count=1)[0]
            assert check == TAG_FLOAT, f'Wrong tag in cam file ({check} vs. {TAG_FLOAT}).'
            K3 = np.fromfile(f, dtype='float64', count=9).reshape((3, 3)).astype(np.float32)
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = K3
        return K
