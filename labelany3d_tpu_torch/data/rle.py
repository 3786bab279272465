"""COCO run-length-encoding codec (pycocotools-compatible, self-contained).

The reference depends on pycocotools' C extension (`src/util.py:10,367`) to
decode COCONUT instance masks. That package is not part of this image, so the
codec is reimplemented from the published COCO mask API format:

  * masks are run-length encoded in **column-major** (Fortran) order,
    runs alternating background/foreground starting with background;
  * the compact string form packs each count as little-endian base-32
    varints (5 value bits + 1 continuation bit per character, biased by
    ASCII 48), with counts[i] for i >= 2 stored as a delta against
    counts[i-2].

The four hot loops take the C++ codec of `labelany3d_tpu_torch.native`
(built with the host compiler at first use, loaded with ctypes), and the
numpy codec here when there is no compiler, as in `labelany3d_tpu/data/rle.py`.
The fallback is announced once on stderr, and `PATHS` counts the calls each
path served.
"""

from __future__ import annotations

import ctypes

import numpy as np

from labelany3d_tpu_torch.utils.logging import warn_once

# Calls of the four hot loops served by the native codec and by numpy.
PATHS = {"native": 0, "numpy": 0}

_I64P = ctypes.POINTER(ctypes.c_int64)


def _native():
    """The native codec (counted as the path taken), or None (numpy)."""
    from labelany3d_tpu_torch.native import load_rle

    lib = load_rle()
    PATHS["numpy" if lib is None else "native"] += 1
    if lib is None:
        warn_once("rle_numpy", "the native RLE codec could not be built (no host C++ "
                  "compiler?); the numpy codec serves instead")
    return lib


def rle_from_string(s: bytes | str) -> np.ndarray:
    """Decode a compressed-counts string into an int64 run-length array."""
    if isinstance(s, str):
        s = s.encode("utf-8")
    lib = _native()
    if lib is not None:
        buf = np.zeros(len(s) + 4, np.int64)
        m = lib.rle_from_string(s, len(s), buf.ctypes.data_as(_I64P), len(buf))
        return buf[:m].copy()
    counts = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def rle_to_string(counts: np.ndarray) -> bytes:
    """Encode an int run-length array into the compressed-counts string."""
    counts = np.ascontiguousarray(counts, np.int64)
    lib = _native()
    if lib is not None:
        out_buf = ctypes.create_string_buffer(int(len(counts) * 16 + 16))
        n = lib.rle_to_string(counts.ctypes.data_as(_I64P), len(counts), out_buf,
                              len(out_buf))
        return out_buf.raw[:n]
    out = bytearray()
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def rle_to_mask(counts: np.ndarray, height: int, width: int) -> np.ndarray:
    """Run lengths -> (H, W) bool mask (column-major runs)."""
    counts = np.ascontiguousarray(counts, np.int64)
    lib = _native()
    if lib is not None:
        mask = np.zeros((height, width), np.uint8)
        lib.rle_to_mask(counts.ctypes.data_as(_I64P), len(counts), height, width,
                        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return mask.astype(bool)
    total = int(counts.sum())
    if total != height * width:
        # COCO tolerates a short final run; pad/truncate defensively.
        flat = np.zeros(height * width, bool)
    else:
        flat = np.zeros(total, bool)
    ends = np.cumsum(counts)
    starts = np.concatenate([[0], ends[:-1]])
    # Foreground runs are the odd-indexed ones.
    n = min(len(counts), len(starts))
    for i in range(1, n, 2):
        s, e = int(starts[i]), int(ends[i])
        flat[s : min(e, flat.size)] = True
    return flat.reshape((width, height)).T  # column-major


def mask_to_rle(mask: np.ndarray) -> np.ndarray:
    """(H, W) mask -> run-length counts (column-major, background first)."""
    lib = _native()
    if lib is not None:
        m8 = np.ascontiguousarray(mask, np.uint8)
        h, w = m8.shape
        buf = np.zeros(h * w + 2, np.int64)
        n = lib.mask_to_rle(m8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                            buf.ctypes.data_as(_I64P), len(buf))
        return buf[:n].copy()
    flat = np.asarray(mask, bool).T.reshape(-1)
    if flat.size == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(boundaries).astype(np.int64)
    if flat[0]:
        runs = np.concatenate([[0], runs])
    return runs


def rle_decode(rle: dict) -> np.ndarray:
    """pycocotools-style decode of {'size': [h, w], 'counts': str|bytes|list}."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_from_string(counts)
    return rle_to_mask(np.asarray(counts, np.int64), int(h), int(w))


def rle_encode(mask: np.ndarray, compress: bool = True) -> dict:
    """pycocotools-style encode; returns {'size': [h, w], 'counts': ...}."""
    h, w = mask.shape
    counts = mask_to_rle(mask)
    if compress:
        return {"size": [int(h), int(w)], "counts": rle_to_string(counts)}
    return {"size": [int(h), int(w)], "counts": counts.tolist()}


def rle_area(rle: dict) -> int:
    """Foreground pixels of a pycocotools-style RLE (its odd-indexed runs)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_from_string(counts)
    return int(np.asarray(counts, np.int64)[1::2].sum())
