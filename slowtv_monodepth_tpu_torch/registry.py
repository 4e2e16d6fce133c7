"""Registries: cfg `dataset` keys -> dataset classes, predictor names -> predictors.

The part of `slowtv_monodepth_tpu/registry.py` the port needs: nets, losses
and schedules are plain dicts in `parsers` and `core.schedules`.
"""
from __future__ import annotations

import importlib
from typing import Iterable, Union

__all__ = ['DATA_REG', 'PRED_REG', 'register', 'trigger_datasets', 'trigger_preds']

DATA_REG: dict[str, type] = {}
PRED_REG: dict[str, type] = {}

_TYPE2REG = {'data': DATA_REG, 'pred': PRED_REG}


def register(name: Union[str, Iterable[str]], type: str = 'data'):  # noqa: A002
    """Class decorator adding the target to a registry under one or more names.

    :param type: Registry to use: 'data' (datasets) or 'pred' (predictors).
    """
    names = [name] if isinstance(name, str) else list(name)
    reg = _TYPE2REG[type]

    def wrapper(cls):
        for n in names:
            if n in reg and reg[n] is not cls:
                raise KeyError(f'Duplicate registry key "{n}" ({reg[n]} vs. {cls}).')
            reg[n] = cls
        return cls

    return wrapper


def trigger_datasets() -> None:
    """Populate `DATA_REG` by importing the data package."""
    importlib.import_module('.data', package=__package__)


def trigger_preds() -> None:
    """Populate `PRED_REG` by importing the predictors."""
    importlib.import_module('.core.predictors', package=__package__)
