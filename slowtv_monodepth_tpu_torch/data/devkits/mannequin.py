"""MannequinChallenge devkit (ref `src/devkits/mannequin.py:14-93`).

Paths + calibration.txt parsing: per-frame crop shape, intrinsics, and pose.
Copy of `slowtv_monodepth_tpu/data/devkits/mannequin.py`.
"""
from __future__ import annotations

import random
from collections import namedtuple
from pathlib import Path
from typing import Union

import numpy as np

from . import PATHS

__all__ = ['Item', 'get_split_file', 'get_info_file', 'get_img_file',
           'get_depth_file', 'load_split', 'load_info', 'create_split']

Item = namedtuple('MannequinItem', 'seq stem')


def get_split_file(mode: str) -> Path:
    return PATHS['mannequin'] / 'splits' / f'{mode}_files.txt'


def get_info_file(mode: str, seq: str) -> Path:
    return PATHS['mannequin'] / mode / seq / 'calibration.txt'


def get_img_file(mode: str, seq: str, stem: Union[str, int]) -> Path:
    return PATHS['mannequin'] / mode / seq / f'{int(stem):05}.jpg'


def get_depth_file(mode: str, seq: str, stem: Union[str, int]) -> Path:
    return PATHS['mannequin'] / mode / seq / f'{int(stem):05}.npy'


def load_split(mode: str):
    file = get_split_file(mode)
    with open(file) as f:
        items = [Item(*line.split()) for line in f.read().splitlines()]
    return file, items


def load_info(mode: str, seq: str) -> dict:
    """Parse calibration.txt: 6 lines per image — crop box, (fx fy cx cy),
    3 rotation rows, translation (ref `mannequin.py:50-80`)."""
    with open(get_info_file(mode, seq)) as f:
        lines = [line.split() for line in f.read().splitlines()]

    n_imgs, offset = map(int, lines.pop(0))
    assert len(lines) == n_imgs * 6

    items = {}
    for i in range(n_imgs):
        y_min, y_max, x_min, x_max = map(int, lines.pop(0))
        d = {'shape': (y_max - y_min, x_max - x_min)}

        fx, fy, cx, cy = map(float, lines.pop(0))
        d['K'] = np.array([
            [fx, 0, cx, 0],
            [0, fy, cy, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ], dtype=np.float32)

        R = np.array([[float(v) for v in lines.pop(0)] for _ in range(3)], np.float32)
        t = np.array([float(v) for v in lines.pop(0)], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        d['T'] = T

        items[f'{i + offset:05d}'] = d

    assert not lines
    return items


def create_split(max=1000, seed=42):  # noqa: A002
    """Regenerate the test split from available depth files (ref `:86-93`)."""
    mode = 'test'
    root = PATHS['mannequin'] / mode
    files = [f for s in sorted(root.iterdir()) if s.is_dir()
             for f in sorted(s.iterdir()) if f.suffix == '.npy']
    rng = random.Random(seed)
    rng.shuffle(files)
    files = sorted(files[:max])
    with open(get_split_file(mode), 'w') as f:
        for file in files:
            f.write(f'{file.parent.stem} {file.stem}\n')
