"""Abstract datum-driven dataset base (host-side numpy pipeline).

Capability parity with `src/datasets/base.py:18-341`: datum-dispatch loading
(`load_<datum>`), the Load -> Augment -> Transform pipeline, `max_len` +
`randomize` epoch limiting, per-item timing, subclass hooks installing retry +
argument validation, and the `play()` visual debugger.

Copy of `slowtv_monodepth_tpu/data/base.py` (no framework in it).
- Items are plain numpy NHWC dicts; there is no ToTorch/permute stage: the
  loop moves the collated arrays to the device as they are, channel-last.
- `collate_fn` stacks numpy arrays (timers/strings pass through un-collated,
  the role of the reference's patched `default_collate`, `src/utils/collate.py`).
"""
from __future__ import annotations

import inspect
import random
import threading
from abc import ABC, abstractmethod
from contextlib import nullcontext
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from ..utils import MultiLevelTimer, get_logger
from .deco import retry_new_on_error, validated_init

__all__ = ['BaseDataset', 'collate_items', 'img_to_f32']


def img_to_f32(img) -> np.ndarray:
    """PIL 8-bit image -> float32 [0, 1] (the hot decode-side conversion).

    `np.array(img, dtype=np.float32)` routes through PIL's per-pixel
    conversion (~179 ms for a 720p RGB frame — 10x the JPEG decode itself);
    viewing the 8-bit buffer first and converting in numpy is ~4x faster
    end to end with bit-identical results (u8 -> f32 is exact, then the
    same `/ 255` division).
    """
    a = np.asarray(img).astype(np.float32)
    a /= 255.0
    return a


def _collate_leaf(vals: list):
    """Stack numeric leaves; pass strings/timers/objects through as lists."""
    v0 = vals[0]
    if isinstance(v0, np.ndarray):
        return np.stack(vals)
    if isinstance(v0, (int, float, bool, np.number)):
        return np.asarray(vals)
    return list(vals)


def collate_items(items: Sequence[tuple]) -> tuple:
    """Collate [(x, y, m), ...] -> (x, y, m) of stacked arrays."""
    out = []
    for dicts in zip(*items):
        keys = dicts[0].keys()
        out.append({k: _collate_leaf([d[k] for d in dicts]) for k in keys})
    return tuple(out)


class BaseDataset(ABC):
    """:param datum: Datatypes to load (str or list of str).
    :param use_aug: If True, call `augment` during `__getitem__`.
    :param max_len: Max items per epoch (combine with `randomize`).
    :param randomize: If True, randomize the item number when loading.
    :param log_time: If True, time item loading stages.

    Class attributes child classes must provide: `VALID_DATUM`, `items_data`.
    """
    _tagged = False

    def __init__(self,
                 datum: Optional[Union[str, Sequence[str]]] = None,
                 use_aug: bool = False,
                 max_len: Optional[int] = None,
                 randomize: bool = False,
                 log_time: bool = True):
        self.datum = datum or []
        self.use_aug = use_aug
        self.log_time = log_time
        self.max_len = max_len
        self.randomize = randomize

        self.items_data = None  # Must be overridden.

        if isinstance(self.VALID_DATUM, str):
            self.VALID_DATUM = set(self.VALID_DATUM.split())
        if isinstance(self.datum, str):
            self.datum = self.datum.split()

        # Items load concurrently in loader threads (unlike the reference's
        # process workers), so the timer must be per-thread.
        self._timer_local = threading.local()

    @property
    def timer(self):
        if not self.log_time:
            return nullcontext
        t = getattr(self._timer_local, 'timer', None)
        if t is None:
            t = self._timer_local.timer = MultiLevelTimer(
                name=self.__class__.__qualname__, as_ms=True, precision=4)
        return t

    def __init_subclass__(cls, retry_exc=None, silent: bool = False,
                          max_retries: int = 10, use_blacklist: bool = False, **kwargs):
        """Install logger, validated init, and the retry wrapper
        (ref `base.py:132-161`)."""
        super().__init_subclass__(**kwargs)
        cls.logger = get_logger(f'BaseDataset.{cls.__qualname__}')

        if not inspect.isabstract(cls) and not cls._tagged:
            cls._tagged = True
            cls.__init__ = validated_init(cls.__init__)

        cls.__getitem__ = retry_new_on_error(
            cls.__getitem__, exc=retry_exc, silent=silent,
            max=max_retries, use_blacklist=use_blacklist)

    def __repr__(self) -> str:
        sig = inspect.signature(self.__init__)
        kw = {k: getattr(self, k) for k in sig.parameters if hasattr(self, k)}
        kw = ', '.join(f'{k}={v}' for k, v in kw.items())
        return f'{self.__class__.__qualname__}({kw})'

    # ------------------------------------------------------------- validation
    def validate_args(self) -> None:
        """Error checking for the provided dataset configuration
        (ref `base.py:170-184`)."""
        if self.__class__.__len__ is not BaseDataset.__len__:
            raise TypeError('Child datasets should not override `__len__`; '
                            'override `num_items` instead (max_len support).')
        if self.items_data is None:
            raise NotImplementedError('Dataset must provide `items_data` to use for loading...')
        if not self.datum:
            raise ValueError('Must provide `datum` to load!')

        ds = [d for d in self.datum if not self.is_valid(d)]
        if any(ds):
            raise ValueError(f'Invalid data types. ({ds} vs. {self.VALID_DATUM})')

        fns = [f for d in self.datum if not hasattr(self, f := f'load_{d}')]
        if any(fns):
            raise NotImplementedError(f'Missing data loading functions: {fns}')

    def log_args(self) -> None:
        self.logger.debug(f'Loading datum: {self.datum}...')

    # ------------------------------------------------------------------ sizes
    def __len__(self) -> int:
        return min(self.num_items(), self.max_len) if self.max_len else self.num_items()

    def num_items(self) -> int:
        return len(self.items_data)

    # ------------------------------------------------------------------ datum
    @property
    @abstractmethod
    def VALID_DATUM(self):
        """Set of valid datatypes (class attribute)."""

    def is_valid(self, data_type: str) -> bool:
        return data_type in self.VALID_DATUM

    def has(self, data_type: str) -> bool:
        if not self.is_valid(data_type):
            raise ValueError(f'Invalid data type. ({data_type} vs. {self.VALID_DATUM})')
        return data_type in self.datum

    def get_load_fn(self, data_type: str) -> Callable:
        if not self.is_valid(data_type):
            raise ValueError(f'Invalid data type. ({data_type} vs. {self.VALID_DATUM})')
        return getattr(self, f'load_{data_type}')

    # ---------------------------------------------------------------- loading
    def __getitem__(self, item: int):
        """Load -> Augment -> Transform pipeline (ref `base.py:241-269`)."""
        if item >= len(self):
            raise IndexError
        if self.randomize:
            iitem, item = item, random.randrange(self.num_items())

        batch = x, y, m = {}, {}, {'items': str(item)}
        if self.randomize:
            m['items_original'] = str(iitem)
        if self.use_aug:
            m['augs'] = ''

        with self.timer('Total'):
            with self.timer('Load'):
                batch = self.load(item, batch)
            if self.use_aug:
                with self.timer('Augment'):
                    batch = self.augment(batch)
            with self.timer('Transform'):
                batch = self.transform(batch)

        if self.log_time:
            m['timer_data'] = self.timer.copy()
            self.timer.reset()
        return batch

    def load(self, item: int, batch: tuple) -> tuple:
        data = self.items_data[item]
        batch = self.add_metadata(data, batch)
        for d in self.datum:
            with self.timer(d.capitalize()):
                batch = self.get_load_fn(d)(data, batch)
        return batch

    def add_metadata(self, data: Any, batch: tuple) -> tuple:
        return batch

    def augment(self, batch: tuple) -> tuple:
        return batch

    def transform(self, batch: tuple) -> tuple:
        return batch

    # -------------------------------------------------------------- collating
    @classmethod
    def collate_fn(cls, items: Sequence[tuple]) -> tuple:
        return collate_items(items)

    # ------------------------------------------------------------- displaying
    def create_axs(self):
        import matplotlib.pyplot as plt
        _, ax = plt.subplots()
        return ax

    @abstractmethod
    def show(self, batch: tuple, axs) -> None:
        """Show a single dataset item."""

    def play(self, fps: float = 30, skip: int = 1, reverse: bool = False,
             axs=None, title: Optional[Callable] = None) -> None:
        """Iterate through the dataset and display items (ref `base.py:297-340`)."""
        import matplotlib.pyplot as plt
        axs = self.create_axs() if axs is None else axs
        fig = plt.gcf()
        if title is None:
            title = lambda i, b: str(i)  # noqa: E731

        items = range(len(self) - 1, 0, -skip) if reverse else range(0, len(self), skip)
        for i in items:
            axs.cla() if isinstance(axs, plt.Axes) else [ax.cla() for ax in np.asarray(axs).flatten()]
            batch = self[i]
            self.show(batch, axs)
            fig.suptitle(title(i, batch))
            plt.pause(1 / fps)
        plt.show(block=False)
