"""Dependency-free base helpers (copy of `slowtv_monodepth_tpu/utils/misc.py`)."""
from __future__ import annotations

import logging
from typing import Any, Mapping

__all__ = ['flatten_dict', 'get_logger']


def flatten_dict(d: Mapping, parent: str = '', sep: str = '/') -> dict[str, Any]:
    """Flatten a nested dict into `parent/child` keys (ref `misc.py:28-37`)."""
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f'{parent}{sep}{k}' if parent else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, parent=key, sep=sep))
        else:
            out[key] = v
    return out


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(f'slowtv_torch.{name}')
    logger.setLevel(level)
    return logger
