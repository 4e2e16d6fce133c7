"""DIODE devkit (ref `src/devkits/diode.py:12-60`): CSV splits + npy depth/mask.

Copy of `slowtv_monodepth_tpu/data/devkits/diode.py` (PIL imported where an
image is opened)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = ['Item']


@dataclass
class Item:
    mode: str   # {val}
    split: str  # {indoors, outdoor}
    scene: str  # scene_{i:05}
    scan: str   # scan_{i:05}
    stem: str

    @classmethod
    def get_split_file(cls, mode: str, split: str) -> Path:
        return PATHS['diode'] / 'data_list' / f'{mode}_{split}.csv'

    @classmethod
    def load_split(cls, mode: str, split: str) -> list:
        with open(cls.get_split_file(mode, split)) as f:
            lines = [Path(line.split(',')[0]) for line in f.read().splitlines()]
        return [cls(mode=p[-5], split=p[-4], scene=p[-3], scan=p[-2], stem=f.stem)
                for f in lines if (p := f.parts)]

    def _dir(self) -> Path:
        return PATHS['diode'] / self.mode / self.split / self.scene / self.scan

    def get_img_file(self) -> Path:
        return self._dir() / f'{self.stem}.png'

    def get_depth_file(self) -> Path:
        return self._dir() / f'{self.stem}_depth.npy'

    def get_mask_file(self) -> Path:
        return self._dir() / f'{self.stem}_depth_mask.npy'

    def load_img(self):
        from PIL import Image
        return Image.open(self.get_img_file())

    def load_depth(self) -> np.ndarray:
        return np.load(self.get_depth_file()).astype(np.float32)

    def load_mask(self) -> np.ndarray:
        return np.load(self.get_mask_file()).astype(bool)
