"""Minimal PNG reader and writer on the standard library (zlib), for 8-bit
gray, gray + alpha, RGB and RGBA images, so the port's artifacts need no
Pillow or OpenCV. The reader takes non-interlaced files with any of the
five row filters; the writer uses filter 0."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels


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


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 paeth)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 1:
            # Each byte adds the reconstructed byte bpp to its left: a
            # running sum per channel, modulo 256.
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                up = prev[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(left, up, upleft)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row filter {kind} is not defined")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 for 8-bit, non-interlaced gray,
    gray + alpha, RGB or RGBA images."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG reader takes 8-bit non-interlaced gray/RGB(A) images, got "
                         f"bit depth {depth}, colour type {ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
