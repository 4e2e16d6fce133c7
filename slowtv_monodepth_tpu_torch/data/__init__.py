"""Host-side datasets and loaders (numpy; copies of the JAX package's
framework-free `data/` modules). Every dataset of the JAX package's registry:
`slow_tv`, `slow_tv_lmdb`, `kitti`, `kitti_lmdb`, `mannequin`,
`mannequin_lmdb`, `syns_patches`, `ddad`, `diode`, `nyud`, `sintel`, `tum`
and `mapfree`."""
from .augment import ColorJiggle
from .base import BaseDataset, collate_items
from .base_mde import IMAGENET_MEAN, IMAGENET_STD, MdeBaseDataset, SuppImageNotFoundError
from .eval_datasets import DdadDataset, DiodeDataset, NyudDataset, SintelDataset, TumDataset
from .kitti_raw import KittiRawDataset
from .kitti_raw_pack import KittiRawPackDataset
from .loader import ConcatDataLoader, DataLoader, ShardedSampler
from .mannequin import MannequinDataset
from .mannequin_pack import MannequinPackDataset
from .mapfreereloc import MapFreeRelocDataset
from .slow_tv import SlowTvDataset
from .slow_tv_pack import SlowTvPackDataset
from .syns_patches import SynsPatchesDataset

__all__ = ['ColorJiggle', 'BaseDataset', 'collate_items', 'IMAGENET_MEAN', 'IMAGENET_STD',
           'MdeBaseDataset', 'SuppImageNotFoundError', 'ConcatDataLoader', 'DataLoader',
           'ShardedSampler', 'KittiRawDataset', 'KittiRawPackDataset', 'MannequinDataset',
           'MannequinPackDataset', 'SlowTvDataset', 'SlowTvPackDataset',
           'SynsPatchesDataset', 'DdadDataset', 'DiodeDataset', 'NyudDataset',
           'SintelDataset', 'TumDataset', 'MapFreeRelocDataset']
