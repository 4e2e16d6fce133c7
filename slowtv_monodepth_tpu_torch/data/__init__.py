"""Host-side datasets and loaders (numpy; copies of the JAX package's
framework-free `data/` modules). Ported datasets: `slow_tv`."""
from .augment import ColorJiggle
from .base import BaseDataset, collate_items
from .base_mde import IMAGENET_MEAN, IMAGENET_STD, MdeBaseDataset, SuppImageNotFoundError
from .loader import ConcatDataLoader, DataLoader, ShardedSampler
from .slow_tv import SlowTvDataset

__all__ = ['ColorJiggle', 'BaseDataset', 'collate_items', 'IMAGENET_MEAN', 'IMAGENET_STD',
           'MdeBaseDataset', 'SuppImageNotFoundError', 'ConcatDataLoader', 'DataLoader',
           'ShardedSampler', 'SlowTvDataset']
