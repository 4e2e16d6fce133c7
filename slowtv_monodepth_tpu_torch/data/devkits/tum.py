"""TUM-RGBD devkit (ref `src/devkits/tum.py:13-136`): associated rgb/depth
pairs, Kinect depth encoded /5000, split creation via timestamp association.

Copy of `slowtv_monodepth_tpu/data/devkits/tum.py` (PIL imported where an
image is opened)."""
from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import PATHS

__all__ = ['Item', 'create_splits', 'read_file_list', 'associate']


@dataclass
class Item:
    seq: str         # rgbd_dataset_freiburg[2,3]_{seq}
    rgb_stem: str    # rgb/{timestamp}.png
    depth_stem: str  # depth/{timestamp}.png

    @classmethod
    def get_split_file(cls, mode: str) -> Path:
        return PATHS['tum'] / 'splits' / f'{mode}_files.txt'

    @classmethod
    def load_split(cls, mode: str) -> list:
        with open(cls.get_split_file(mode)) as f:
            return [cls(*line.split()) for line in f.read().splitlines()]

    def get_img_file(self) -> Path:
        return PATHS['tum'] / self.seq / self.rgb_stem

    def get_depth_file(self) -> Path:
        return PATHS['tum'] / self.seq / self.depth_stem

    def load_img(self):
        from PIL import Image
        return Image.open(self.get_img_file())

    def load_depth(self) -> np.ndarray:
        from PIL import Image
        depth = np.array(Image.open(self.get_depth_file()), dtype=np.float32) / 5000
        return depth[..., None]


def read_file_list(filename) -> dict:
    """(stamp, data) records from a TUM trajectory file (official tools)."""
    with open(filename) as f:
        lines = f.read().replace(',', ' ').replace('\t', ' ').split('\n')
    rows = [[v.strip() for v in line.split(' ') if v.strip()]
            for line in lines if line and line[0] != '#']
    return dict((float(r[0]), r[1:]) for r in rows if len(r) > 1)


def associate(first_list: dict, second_list: dict, offset: float,
              max_difference: float) -> list:
    """Greedy nearest-timestamp association (official TUM tools)."""
    first_keys = list(first_list.keys())
    second_keys = list(second_list.keys())
    potential = sorted((abs(a - (b + offset)), a, b)
                       for a in first_keys for b in second_keys
                       if abs(a - (b + offset)) < max_difference)
    matches = []
    for _, a, b in potential:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def create_splits(th: float = 0.02, max: int = 2500, seed: int = 42) -> None:  # noqa: A002
    """Associated rgb/depth split, freiburg2 decimated x3 (ref `:53-82`)."""
    file = PATHS['tum'] / 'splits' / 'test_files.txt'
    file.parent.mkdir(parents=True, exist_ok=True)

    items = []
    seqs = sorted(d for d in PATHS['tum'].iterdir() if d.is_dir() and d.stem != 'splits')
    for seq in seqs:
        first = read_file_list(seq / 'rgb.txt')
        second = read_file_list(seq / 'depth.txt')
        matches = associate(first, second, offset=0, max_difference=th)
        if 'freiburg2' in seq.stem:
            matches = matches[::3]
        items += [f'{seq.stem} {first[a][0]} {second[b][0]}\n' for a, b in matches]

    rng = random.Random(seed)
    rng.shuffle(items)
    with open(file, 'w') as f:
        f.writelines(sorted(items[:max]))
