"""Dataset/model root resolution.

Equivalent to the reference's `src/paths.py:18-113`: optional user-provided
roots in a repo-level `PATHS.yaml` take priority over the repo-relative
defaults. Copy of what the port uses of `slowtv_monodepth_tpu/paths.py` (the
roots, the lazy dataset paths, `find_data_dir` and `find_model_file`); yaml is imported only when a `PATHS.yaml` exists.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ['REPO_ROOT', 'MODEL_ROOTS', 'DATA_ROOTS', 'DATA_PATHS', 'find_data_dir',
           'find_model_file']

REPO_ROOT = Path(__file__).resolve().parent.parent

_DEFAULT_MODEL_ROOTS = [REPO_ROOT / 'models']
_DEFAULT_DATA_ROOTS = [REPO_ROOT / 'data']


def _load_user_paths() -> dict:
    f = REPO_ROOT / 'PATHS.yaml'
    if not f.is_file():
        return {}
    import yaml
    with open(f) as fh:
        return yaml.safe_load(fh) or {}


def _build_roots(key: str, defaults: list[Path]) -> list[Path]:
    """Priority: env var `SLOWTV_<key>` (colon-separated) > PATHS.yaml > repo defaults."""
    env = os.environ.get(f'SLOWTV_{key}')
    env_roots = [Path(p) for p in env.split(':')] if env else []
    user = _load_user_paths().get(key) or []
    if isinstance(user, (str, os.PathLike)):
        user = [user]
    return env_roots + [Path(p) for p in user] + defaults


MODEL_ROOTS = _build_roots('MODEL_ROOTS', _DEFAULT_MODEL_ROOTS)
DATA_ROOTS = _build_roots('DATA_ROOTS', _DEFAULT_DATA_ROOTS)


# Dataset key -> on-disk directory name, for the ported datasets (ref `src/paths.py:68-89`).
DATASET_NAMES = {
    'ddad': 'DDAD',
    'diode': 'Diode',
    'kitti_raw': 'kitti_raw_sync',
    'kitti_raw_lmdb': 'kitti_raw_sync_lmdb',
    'mannequin': 'MannequinChallenge',
    'mannequin_lmdb': 'MannequinChallenge_lmdb',
    'mapfree': 'mapfree',
    'nyud': 'NYUD_v2',
    'sintel': 'Sintel',
    'slow_tv': 'slow_tv',
    'slow_tv_lmdb': 'slow_tv_lmdb',
    'syns_patches': 'syns_patches',
    'tum': 'TUM_RGBD',
}


class _LazyPaths(dict):
    """Dataset-key -> Path mapping resolved on first access.

    Unlike the reference's import-time scan (`src/paths.py:97`), resolution is
    lazy so tests/tools can create data dirs (or override entries) after
    import. Explicit assignments always win.
    """

    def __init__(self, names: dict, roots_fn):
        super().__init__()
        self._names = names
        self._roots_fn = roots_fn

    def __missing__(self, key: str) -> Path:
        if key not in self._names:
            raise KeyError(f'Unknown dataset key "{key}". ({sorted(self._names)})')
        name = self._names[key]
        for root in self._roots_fn():
            p = Path(root) / name
            if p.exists():
                return p
        raise FileNotFoundError(f'No valid path found for "{key}:{name}" in {self._roots_fn()}')

    def __contains__(self, key) -> bool:
        if super().__contains__(key):
            return True
        try:
            self.__missing__(key)
            return True
        except (KeyError, FileNotFoundError):
            return False


DATA_PATHS = _LazyPaths(DATASET_NAMES, lambda: DATA_ROOTS)


def find_data_dir(name: str) -> Path:
    """Return the first existing `<root>/<name>` data directory."""
    for root in DATA_ROOTS:
        d = root / name
        if d.is_dir():
            return d
    raise FileNotFoundError(f'Data dir "{name}" not found in any root: {DATA_ROOTS}')


def find_model_file(name: str) -> Path:
    """Return the first existing `<root>/<name>` model file or directory."""
    for root in MODEL_ROOTS:
        f = root / name
        if f.exists():
            return f
    raise FileNotFoundError(f'Model "{name}" not found in any root: {MODEL_ROOTS}')
