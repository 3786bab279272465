"""Minimal PNG writer on the standard library (zlib), for 8-bit gray, RGB
and RGBA arrays, so writing artifacts needs no Pillow or OpenCV."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(image: np.ndarray, level: int = 1) -> bytes:
    """(H, W) or (H, W, C) uint8, C in {1, 3, 4} -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG writer takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, level))
