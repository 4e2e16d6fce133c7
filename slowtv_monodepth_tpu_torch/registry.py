"""Dataset registry: cfg `dataset` keys -> dataset classes.

The part of `slowtv_monodepth_tpu/registry.py` the port needs: nets, losses
and schedules are plain dicts in `parsers` and `core.schedules`.
"""
from __future__ import annotations

import importlib
from typing import Iterable, Union

__all__ = ['DATA_REG', 'register', 'trigger_datasets']

DATA_REG: dict[str, type] = {}


def register(name: Union[str, Iterable[str]]):
    """Class decorator adding a dataset to `DATA_REG` under one or more names."""
    names = [name] if isinstance(name, str) else list(name)

    def wrapper(cls):
        for n in names:
            if n in DATA_REG and DATA_REG[n] is not cls:
                raise KeyError(f'Duplicate registry key "{n}" ({DATA_REG[n]} vs. {cls}).')
            DATA_REG[n] = cls
        return cls

    return wrapper


def trigger_datasets() -> None:
    """Populate `DATA_REG` by importing the data package."""
    importlib.import_module('.data', package=__package__)
