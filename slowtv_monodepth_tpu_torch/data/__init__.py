"""Host-side datasets and loaders (numpy; copies of the JAX package's
framework-free `data/` modules). Ported datasets: `slow_tv`, `slow_tv_lmdb`,
`kitti`, `kitti_lmdb`, `mannequin`, `mannequin_lmdb`, `syns_patches`."""
from .augment import ColorJiggle
from .base import BaseDataset, collate_items
from .base_mde import IMAGENET_MEAN, IMAGENET_STD, MdeBaseDataset, SuppImageNotFoundError
from .kitti_raw import KittiRawDataset
from .kitti_raw_pack import KittiRawPackDataset
from .loader import ConcatDataLoader, DataLoader, ShardedSampler
from .mannequin import MannequinDataset
from .mannequin_pack import MannequinPackDataset
from .slow_tv import SlowTvDataset
from .slow_tv_pack import SlowTvPackDataset
from .syns_patches import SynsPatchesDataset

__all__ = ['ColorJiggle', 'BaseDataset', 'collate_items', 'IMAGENET_MEAN', 'IMAGENET_STD',
           'MdeBaseDataset', 'SuppImageNotFoundError', 'ConcatDataLoader', 'DataLoader',
           'ShardedSampler', 'KittiRawDataset', 'KittiRawPackDataset', 'MannequinDataset',
           'MannequinPackDataset', 'SlowTvDataset', 'SlowTvPackDataset',
           'SynsPatchesDataset']
