"""YAML config loading & recursive merging.

Mirrors the reference semantics (`src/utils/io.py:134-163`): an ordered chain
of YAML files merged recursively (dicts merge key-wise, scalars/lists replace),
with `~` (None) values deleting a component at parse time
(`src/tools/parsers.py:44-45`). This keeps the reference's `cfg/` trees usable
with this framework unchanged. Copy of `slowtv_monodepth_tpu/config.py`; yaml
is imported inside the functions that read or write a file.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Union

__all__ = ['load_yaml', 'save_yaml', 'merge_dicts', 'load_merge_yaml', 'strip_none_components',
           'get_nested']

PathLike = Union[str, Path]


def load_yaml(path: PathLike) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(path: PathLike, data: dict) -> None:
    import yaml
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        yaml.safe_dump(data, f, default_flow_style=False, sort_keys=False)


def merge_dicts(base: dict, new: dict) -> dict:
    """Recursively merge `new` into a deep copy of `base`.

    Dicts merge per key; any other value (scalar, list) replaces. A `None`
    value in `new` is kept as-is — component deletion via `~` is resolved by
    the parsers, which skip None-valued component entries.
    """
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_merge_yaml(*paths: PathLike) -> dict:
    """Load an ordered chain of YAML files, merging later files over earlier."""
    cfg: dict = {}
    for p in paths:
        cfg = merge_dicts(cfg, load_yaml(p))
    return cfg


def strip_none_components(cfg: dict) -> dict:
    """Drop top-level component entries set to None (the `~` deletion idiom)."""
    return {k: v for k, v in cfg.items() if v is not None}


def get_nested(cfg: dict, dotted: str, default: Any = None) -> Any:
    """Fetch `a.b.c` style keys from a nested dict."""
    cur: Any = cfg
    for part in dotted.split('.'):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur
