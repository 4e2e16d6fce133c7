"""A 16-bit greyscale PNG writer (zlib and struct only).

MapFree's challenge predictions are uint16 PNGs of depth in millimetres.
The JAX package writes them with `cv2.imwrite`; the card's machine has no
cv2 (nor PIL), so the port writes the file itself: signature, IHDR (bit
depth 16, colour type 0), one IDAT of the rows (filter byte 0, big-endian
samples) compressed by zlib, IEND. Any PNG decoder reads back the same
pixels that `cv2.imwrite` of the array gives.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ['write_png16']

_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack('>I', len(data)) + tag + data + struct.pack('>I', zlib.crc32(tag + data))


def write_png16(path, img: np.ndarray) -> None:
    """(h, w) uint16 array -> a greyscale PNG at `path`. Raises where the file
    cannot be written."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint16:
        raise ValueError(f'Expected a (h, w) uint16 array, got {img.shape} {img.dtype}.')
    h, w = img.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)  # filter type 0 (None) per row
    rows[:, 1:] = img.astype('>u2').view(np.uint8).reshape(h, 2 * w)
    ihdr = struct.pack('>IIBBBBB', w, h, 16, 0, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b'IHDR', ihdr) + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _chunk(b'IEND', b''))
    Path(path).write_bytes(data)
