"""NYU Depth v2 devkit (ref `src/devkits/nyud.py:12-42`).

Copy of `slowtv_monodepth_tpu/data/devkits/nyud.py` (PIL imported where an
image is opened)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = ['Item']


@dataclass
class Item:
    mode: str  # {test}
    stem: str  # {i:05}

    @classmethod
    def get_split_file(cls, mode: str) -> Path:
        return PATHS['nyud'] / 'splits' / f'{mode}_files.txt'

    @classmethod
    def load_split(cls, mode: str) -> list:
        with open(cls.get_split_file(mode)) as f:
            return [cls(mode, s) for s in f.read().splitlines()]

    def get_img_file(self) -> Path:
        return PATHS['nyud'] / self.mode / 'rgb' / f'{self.stem}.png'

    def get_depth_file(self) -> Path:
        return PATHS['nyud'] / self.mode / 'depth' / f'{self.stem}.npy'

    def load_img(self):
        from PIL import Image
        return Image.open(self.get_img_file())

    def load_depth(self) -> np.ndarray:
        return np.load(self.get_depth_file())
