"""Dataset decorators: init validation + retry-on-error item loading.

Copy of `slowtv_monodepth_tpu/data/deco.py`; parity with `src/datasets/deco.py:10-77`: `validated_init` runs
`log_args`/`validate_args` post-`__init__`; `retry_new_on_error` catches the
declared exceptions, picks a random replacement item, records the error string
in `m['errors']`, with optional blacklist and a max-retry guard.
"""
from __future__ import annotations

import random
from functools import wraps
from typing import Callable, Optional, Sequence, Union

__all__ = ['validated_init', 'retry_new_on_error']


def validated_init(__init__: Callable) -> Callable:
    """Ensure a BaseDataset child always validates arguments after init."""
    @wraps(__init__)
    def wrapper(self, *args, **kwargs) -> None:
        self.logger.info(f"Creating '{self.__class__.__qualname__}'...")
        __init__(self, *args, **kwargs)
        self.log_args()
        self.validate_args()
    return wrapper


def retry_new_on_error(__getitem__: Callable,
                       exc: Optional[Union[type, Sequence[type]]] = None,
                       silent: bool = False,
                       max: Optional[int] = None,  # noqa: A002
                       use_blacklist: bool = False) -> Callable:
    """Wrap `__getitem__` to retry a random different item on expected errors.

    Unlike the reference's shared nonlocal counter (process-per-worker there),
    the retry count here is carried through the recursion so concurrent loads
    from threaded loader workers can't trample each other's counts.
    """
    blacklist: set = set()

    exc = exc or tuple()
    if isinstance(exc, (list, tuple)):
        exc = tuple(exc)
    else:
        exc = (exc,)

    @wraps(__getitem__)
    def wrapper(self, item: int, _attempt: int = 0):
        try:
            x, y, m = __getitem__(self, item)
            if not silent and 'errors' not in m:
                m['errors'] = ''
        except exc as e:
            if max and _attempt + 1 >= max:
                raise RuntimeError('Exceeded max retries when loading dataset item...')
            if use_blacklist:
                blacklist.add(item)
            if self.log_time:
                self.timer.reset()

            new = item
            while new == item or new in blacklist:
                new = random.randrange(len(self))

            x, y, m = wrapper(self, new, _attempt + 1)
            if not silent:
                m['errors'] += f'{" - " if m["errors"] else ""}{(item, e)}'
        return x, y, m
    return wrapper
