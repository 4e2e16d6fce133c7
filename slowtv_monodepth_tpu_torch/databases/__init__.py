"""Typed record databases over PackDB (the LMDB storage-layer equivalent).

API parity with `src/external_libs/databases/database.py:13-120` + writers
(`writers.py:13-80`): a lazy-open `Database` base with `keys`/`__getitem__`/
`index`, typed subclasses (Image/Label/Mask/Array/Tensor), and
`write_*_database` builders. "Tensor" values are host numpy NHWC arrays (the
torch variant's role); images decode with PIL from their stored encoding.
Copy of `slowtv_monodepth_tpu/databases/__init__.py` over the port's Python
pack reader (`packdb.py`); PIL is imported where a value is decoded.
"""
from __future__ import annotations

import io as _io
import pickle
import shutil
from pathlib import Path
from typing import Union

import numpy as np

from .packdb import PackReader, PackWriter

__all__ = [
    'Database', 'ImageDatabase', 'LabelDatabase', 'MaskDatabase',
    'ArrayDatabase', 'TensorDatabase',
    'write_image_database', 'write_label_database', 'write_array_database',
    'PackReader', 'PackWriter',
]


class Database:
    """Lazy-open read-only record database.

    :param path: Pack file (or reference-style directory containing one).
    :param readahead/pre_open: Kept for API parity; mmap readers are already
        fork/thread-safe without eager opening.
    """

    def __init__(self, path, readahead: bool = True, pre_open: bool = False):
        self.path = self._resolve(path)
        self._db = PackReader(self.path)
        if pre_open:
            self._db._open()

    @staticmethod
    def _resolve(path) -> str:
        p = Path(path)
        if p.is_dir():  # Reference layout: a directory per database.
            packs = sorted(p.glob('*.pack'))
            if not packs:
                raise FileNotFoundError(f'No .pack file inside "{p}".')
            p = packs[0]
        elif p.suffix != '.pack' and not p.exists():
            p = p.with_suffix('.pack')
        return str(p)

    @property
    def protocol(self) -> int:
        return self._db.meta.get('protocol', pickle.DEFAULT_PROTOCOL)

    @property
    def keys(self) -> list:
        return self._db.keys

    def __len__(self) -> int:
        return len(self._db)

    def __contains__(self, item: str) -> bool:
        return item in self._db

    def _convert_value(self, value: bytes):
        return value

    def __getitem__(self, item: Union[str, list]):
        if isinstance(item, list):
            return [self._convert_value(self._db.get(k)) for k in item]
        return self._convert_value(self._db.get(item))

    def index(self, index: int):
        key = self.keys[index]
        return key, self[key]

    def close(self) -> None:
        self._db.close()


class ImageDatabase(Database):
    """Values are encoded images (png/jpg bytes) -> float32 (h, w, 3) [0, 1]."""

    def _convert_value(self, value: bytes) -> np.ndarray:
        from PIL import Image
        img = Image.open(_io.BytesIO(value))
        return np.array(img.convert('RGB'), dtype=np.float32) / 255.0

    def pil(self, item: str):
        """Raw PIL image (for callers that resize before conversion)."""
        from PIL import Image
        return Image.open(_io.BytesIO(self._db.get(item)))


class LabelDatabase(Database):
    """Values are pickled Python objects."""

    def _convert_value(self, value: bytes):
        return pickle.loads(value)


class ArrayDatabase(Database):
    """Values are `np.save`-encoded arrays."""

    def _convert_value(self, value: bytes) -> np.ndarray:
        return np.load(_io.BytesIO(value), allow_pickle=False)


class TensorDatabase(ArrayDatabase):
    """Alias: the torch-tensor variant stores plain arrays here (NHWC)."""


class MaskDatabase(Database):
    """Values are encoded binary masks -> bool (h, w, 1)."""

    def _convert_value(self, value: bytes) -> np.ndarray:
        from PIL import Image
        m = np.array(Image.open(_io.BytesIO(value)))
        if m.ndim == 3:
            m = m[..., 0]
        return (m > 0)[..., None]


# WRITERS (ref `writers.py:13-80`)
# -----------------------------------------------------------------------------
def _fresh(database: Path) -> Path:
    database = Path(database)
    if database.suffix != '.pack':
        if database.exists() and database.is_dir():
            shutil.rmtree(database)
        database.mkdir(parents=True, exist_ok=True)
        database = database / 'data.pack'
    database.parent.mkdir(parents=True, exist_ok=True)
    if database.exists():
        database.unlink()
    return database


def write_image_database(d: dict, database: Path, kind: str = 'image') -> Path:
    """{key: image file path (or encoded bytes)} -> pack of encoded images."""
    database = _fresh(database)
    with PackWriter(database, meta={'kind': kind}) as w:
        for key, value in sorted(d.items()):
            data = Path(value).read_bytes() if not isinstance(value, (bytes, bytearray)) else bytes(value)
            w.put(key, data)
    return database


def write_label_database(d: dict, database: Path) -> Path:
    """{key: object} -> pack of pickles."""
    database = _fresh(database)
    with PackWriter(database, meta={'kind': 'label'}) as w:
        for key, value in sorted(d.items()):
            w.put(key, pickle.dumps(value))
    return database


def write_array_database(d: dict, database: Path) -> Path:
    """{key: ndarray} -> pack of `np.save` blobs."""
    database = _fresh(database)
    with PackWriter(database, meta={'kind': 'array'}) as w:
        for key, value in sorted(d.items()):
            buf = _io.BytesIO()
            np.save(buf, np.asarray(value), allow_pickle=False)
            w.put(key, buf.getvalue())
    return database
