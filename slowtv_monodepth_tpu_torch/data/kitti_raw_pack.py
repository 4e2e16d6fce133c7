"""KITTI dataset over pack stores (ref `src/datasets/kitti_raw_lmdb.py:16-106`).

Same semantics as `KittiRawDataset` with per-drive record databases preloaded
lazily (pack readers open on first access, so constructing them before loader
threads spawn is safe — the role of LMDB's lazy env in the reference).
Copy of `slowtv_monodepth_tpu/data/kitti_raw_pack.py`; cv2 and PIL are
imported where they are used, so the module imports without them.
"""
from __future__ import annotations

import numpy as np

from ..registry import register
from .base_mde import SuppImageNotFoundError
from .devkits import kitti_raw_pack as kr
from .kitti_raw import KittiRawDataset

__all__ = ['KittiRawPackDataset']


@register('kitti_lmdb')
class KittiRawPackDataset(KittiRawDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.image_dbs: dict = {}
        self.depth_dbs: dict = {}
        self.hints_dbs: dict = {}
        self.calib_dbs: dict = {}
        self.preload()

    def parse_items(self):
        file = kr.get_split_file(self.split, self.mode)
        lines = [line.split() for line in kr.load_split(file)]
        items = [kr.Item(line[0], int(line[1]), self._side2cam[line[2]]) for line in lines]
        return file, items

    def preload(self) -> None:
        """Construct all record databases for the split's drives."""
        drives = set(item.seq for item in self.items_data)
        for d in drives:
            self.image_dbs[f'{d}/image_02'] = kr.load_images(*d.split('/'), 'image_02')
            self.image_dbs[f'{d}/image_03'] = kr.load_images(*d.split('/'), 'image_03')

        if self.has('depth'):
            for d in drives:
                self.depth_dbs[f'{d}/image_02'] = kr.load_depths(*d.split('/'), 'image_02')
                self.depth_dbs[f'{d}/image_03'] = kr.load_depths(*d.split('/'), 'image_03')

        if self.has('depth_velo'):
            seqs = set(seq.split('/')[0] for seq in drives)
            self.calib_dbs = {s: kr.load_calib(s) for s in seqs}
            for d in drives:
                seq, drive = d.split('/')
                self.depth_dbs[d] = kr.load_velo_depths(seq, drive, self.calib_dbs[seq])

        if self.has('depth_hint'):
            for d in drives:
                self.hints_dbs[f'{d}/image_02'] = kr.load_hints(*d.split('/'), 'image_02')
                self.hints_dbs[f'{d}/image_03'] = kr.load_hints(*d.split('/'), 'image_03')

    def _load_image(self, data: kr.Item, offset: int = 0) -> np.ndarray:
        k = f'{data.stem + offset:010}'
        kdb = f'{data.seq}/{data.cam}'
        db = self.image_dbs[kdb]
        if k not in db:
            exc = FileNotFoundError if offset == 0 else SuppImageNotFoundError
            raise exc(f'Could not find specified file "{kdb}/{k}" with "{offset=}"')

        img = db.pil(k)
        if self.should_resize:
            from PIL import Image
            img = img.resize(self.size, resample=Image.Resampling.BILINEAR)
        return self._to_img(img.convert('RGB'))

    def _load_depth(self, data: kr.Item) -> np.ndarray:
        depth = self.depth_dbs[f'{data.seq}/{data.cam}'][f'{data.stem:010}']
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, (self.SHAPE[1], self.SHAPE[0]),
                               interpolation=cv2.INTER_NEAREST)
        return depth[..., None]

    def _load_depth_velo(self, data: kr.Item) -> np.ndarray:
        depth = self.depth_dbs[data.seq][(f'{data.stem:010}', int(data.cam[-2:]))]
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, (self.SHAPE[1], self.SHAPE[0]),
                               interpolation=cv2.INTER_NEAREST)
        return depth[..., None]

    def _load_depth_hint(self, data: kr.Item) -> np.ndarray:
        depth = self.hints_dbs[f'{data.seq}/{data.cam}'][f'{data.stem:010}']
        if self.should_resize:
            import cv2
            depth = cv2.resize(depth, dsize=self.size, interpolation=cv2.INTER_NEAREST)
        return depth[..., None]
