"""PackDB: single-file packed record store (format + writer + reader).

Copy of `slowtv_monodepth_tpu/databases/packdb.py` with its pure-Python
reader only: mmap + a dict index built on first access. The storage layer
replacing the reference's LMDB databases (`src/external_libs/databases`,
445 LoC over py-lmdb): one append-only file with a sorted FNV-1a hash index
in the footer. The reader is read-only and thread/multi-process safe (lazy
open per handle, the property the reference gets from LMDB's lazy env,
`database.py:28-47`).

Format: b'SPKD0001', the index offset (u64), the records; at the index
offset the record count (u64), one (hash, offset, length, key_off, key_len)
u64 entry per record sorted by (hash, key), the keys' bytes, the pickled
meta's length (u64) and the pickled meta.
"""
from __future__ import annotations

import mmap
import pickle
import struct
from pathlib import Path
from typing import Iterator, Optional

__all__ = ['PackWriter', 'PackReader']

MAGIC = b'SPKD0001'
_ENTRY = struct.Struct('<QQQQQ')  # hash, offset, length, key_off, key_len


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class PackWriter:
    """Stream records into a pack file; the index is written on close.

    Usage::
        with PackWriter(path, meta={'kind': 'image'}) as w:
            w.put('key', payload_bytes)
    """

    def __init__(self, path, meta: Optional[dict] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.meta = meta or {}
        self._entries: list = []
        self._f = open(self.path, 'wb')
        self._f.write(MAGIC)
        self._f.write(struct.pack('<Q', 0))  # index_offset placeholder.

    def put(self, key: str, value: bytes) -> None:
        kb = key.encode('utf-8')
        off = self._f.tell()
        self._f.write(value)
        self._entries.append((_fnv1a(kb), off, len(value), kb))

    def close(self) -> None:
        index_offset = self._f.tell()
        # Sort by (hash, key bytes) — the native reader's search order.
        self._entries.sort(key=lambda e: (e[0], e[3]))

        keys_blob = bytearray()
        table = bytearray()
        for h, off, length, kb in self._entries:
            table += _ENTRY.pack(h, off, length, len(keys_blob), len(kb))
            keys_blob += kb

        meta = dict(self.meta)
        meta.setdefault('protocol', pickle.DEFAULT_PROTOCOL)
        meta_blob = pickle.dumps(meta)

        self._f.write(struct.pack('<Q', len(self._entries)))
        self._f.write(table)
        self._f.write(keys_blob)
        self._f.write(struct.pack('<Q', len(meta_blob)))
        self._f.write(meta_blob)

        self._f.seek(8)
        self._f.write(struct.pack('<Q', index_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PackReader:
    """Read-only pack handle; lazy-opens on first access (safe to construct
    before forking/threading workers)."""

    def __init__(self, path):
        self.path = str(path)
        self._mm = None         # Python mmap.
        self._index: Optional[dict] = None
        self._meta: Optional[dict] = None
        self._keys: Optional[list] = None

    # ------------------------------------------------------------------ open
    def _open(self):
        if self._mm is None:
            f = open(self.path, 'rb')
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            f.close()
            if self._mm[:8] != MAGIC:
                raise OSError(f'Not a valid pack file: {self.path}')
            (index_offset,) = struct.unpack_from('<Q', self._mm, 8)
            (n,) = struct.unpack_from('<Q', self._mm, index_offset)
            table_off = index_offset + 8
            keys_off = table_off + n * _ENTRY.size
            self._index = {}
            entries = []
            for i in range(n):
                h, off, length, key_off, key_len = _ENTRY.unpack_from(
                    self._mm, table_off + i * _ENTRY.size)
                entries.append((off, length, key_off, key_len))
            keys_end = keys_off
            self._keys_py = []
            for off, length, key_off, key_len in entries:
                key = self._mm[keys_off + key_off:keys_off + key_off + key_len].decode()
                self._index[key] = (off, length)
                self._keys_py.append(key)
                keys_end = max(keys_end, keys_off + key_off + key_len)
            (meta_len,) = struct.unpack_from('<Q', self._mm, keys_end)
            self._meta = pickle.loads(self._mm[keys_end + 8:keys_end + 8 + meta_len])

    # ------------------------------------------------------------------- api
    @property
    def meta(self) -> dict:
        if self._meta is None:
            self._open()
        return self._meta

    @property
    def keys(self) -> list:
        if self._keys is None:
            self._open()
            self._keys = list(self._keys_py)
        return self._keys

    def __len__(self) -> int:
        self._open()
        return len(self._index)

    def __contains__(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def get(self, key: str) -> bytes:
        """Record bytes for `key` (raises KeyError)."""
        self._open()
        try:
            off, length = self._index[key]
        except KeyError:
            raise KeyError(key) from None
        return self._mm[off:off + length]

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys)

    def close(self) -> None:
        if self._mm:
            self._mm.close()
            self._mm = None
