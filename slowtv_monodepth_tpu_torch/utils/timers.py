"""Wall-clock timers for host-side instrumentation.

The nestable `MultiLevelTimer` used across the input pipeline and the train
loop: a copy of that class from `slowtv_monodepth_tpu/utils/timers.py`. CUDA dispatch is
asynchronous, so a caller that times device work passes a `sync_fn`
(`torch.cuda.synchronize`), which runs on entry and on exit.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional

__all__ = ['MultiLevelTimer']


class MultiLevelTimer:
    """Nestable named timer producing a flat dict of level-prefixed means.

    Usage::

        t = MultiLevelTimer(name='Step')
        with t('Forward'): ...
        with t('Loss'):
            with t('Photo'): ...
        t.to_dict()  # {'Forward': ..., 'Loss': ..., 'Loss/Photo': ...}
    """

    def __init__(self, name: str = 'MultiLevelTimer', as_ms: bool = True,
                 precision: int = 4, sync_fn: Optional[Callable] = None):
        self.name = name
        self.as_ms = as_ms
        self.precision = precision
        self.sync_fn = sync_fn
        self._stack: list[str] = []
        self._totals: 'OrderedDict[str, float]' = OrderedDict()
        self._counts: 'OrderedDict[str, int]' = OrderedDict()
        self._starts: dict[str, float] = {}

    def __call__(self, label: str) -> 'MultiLevelTimer':
        self._pending = label
        return self

    def __enter__(self) -> 'MultiLevelTimer':
        label = self._pending
        key = '/'.join(self._stack + [label])
        self._stack.append(label)
        if self.sync_fn:
            self.sync_fn()
        self._starts[key] = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.sync_fn:
            self.sync_fn()
        label = self._stack.pop()
        key = '/'.join(self._stack + [label])
        dt = time.perf_counter() - self._starts.pop(key)
        if self.as_ms:
            dt *= 1000
        self._totals[key] = self._totals.get(key, 0.) + dt
        self._counts[key] = self._counts.get(key, 0) + 1

    def to_dict(self) -> dict[str, float]:
        """Mean elapsed time per label."""
        return {
            k: round(self._totals[k] / self._counts[k], self.precision)
            for k in self._totals
        }

    def total_elapsed(self) -> dict[str, float]:
        """Summed elapsed time per label."""
        return {k: round(v, self.precision) for k, v in self._totals.items()}

    def mean_elapsed(self, others: Optional[list['MultiLevelTimer']] = None) -> dict[str, float]:
        """Mean of per-label means, optionally averaged across several timers."""
        timers = others if others else [self]
        keys = {k for t in timers for k in t._totals}
        out = {}
        for k in sorted(keys):
            vals = [t._totals[k] / t._counts[k] for t in timers if k in t._totals]
            out[k] = round(sum(vals) / len(vals), self.precision)
        return out

    def copy(self) -> 'MultiLevelTimer':
        """Snapshot of accumulated stats (e.g. to attach to batch metadata
        before `reset`, ref `src/datasets/base.py:253-268`)."""
        t = MultiLevelTimer(name=self.name, as_ms=self.as_ms,
                            precision=self.precision, sync_fn=self.sync_fn)
        t._totals = OrderedDict(self._totals)
        t._counts = OrderedDict(self._counts)
        return t

    def reset(self) -> None:
        self._stack.clear()
        self._totals.clear()
        self._counts.clear()
        self._starts.clear()

    def __str__(self) -> str:
        unit = 'ms' if self.as_ms else 's'
        lines = [f'{self.name}:'] + [f'  {k}: {v:.{self.precision}f}{unit}' for k, v in self.to_dict().items()]
        return '\n'.join(lines)
