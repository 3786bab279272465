"""Plain instance masks of the labelling reference: a copy of the port's
COCONUT filters (`data/coconut.py::read_instances`) and mask packing
(`pipeline/stages/common.py`), from the split's RLE."""

from __future__ import annotations

import numpy as np


def rle_counts(s: str) -> list[int]:
    """COCO's compressed RLE string -> run lengths (pycocotools'
    `rleFrString`)."""
    counts, p = [], 0
    while p < len(s):
        x = k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and c & 0x10:
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(seg: dict) -> np.ndarray:
    """COCO RLE (compressed string or run list; column-major runs, zeros
    first) -> bool mask."""
    h, w = seg["size"]
    counts = seg["counts"]
    runs = np.asarray(rle_counts(counts) if isinstance(counts, str) else counts, np.int64)
    values = np.zeros(len(runs), bool)
    values[1::2] = True
    return np.repeat(values, runs).reshape(w, h).T


def kept_instances(annotations: list[dict], width: int, height: int,
                   min_height_frac: float = 0.0625, boundary: int = 10,
                   min_pixels: int = 100) -> list[tuple[np.ndarray, list, int]]:
    """(mask, bbox, category id) of the instances the port's filters keep:
    no crowds, more than `min_height_frac` of the image tall (occupied
    rows), fewer than 10 pixels within `boundary` of the border, at least
    `min_pixels` pixels."""
    out = []
    for a in annotations:
        if a.get("iscrowd") or "segmentation" not in a:
            continue
        m = rle_decode(a["segmentation"])
        rows = int(np.any(m, axis=1).sum())
        mi = m.astype(np.int64)
        b = boundary
        trunc = mi[:b].sum() + mi[-b:].sum() + mi[:, :b].sum() + mi[:, -b:].sum()
        if rows / height > min_height_frac and trunc < 10 and mi.sum() >= min_pixels:
            out.append((m, a["bbox"], a["category_id"]))
    return out


def resize_nearest(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[-2], arr.shape[-1]
    if h == height and w == width:
        return arr
    ys = np.floor(np.arange(height) * (h / height)).astype(np.int64)
    xs = np.floor(np.arange(width) * (w / width)).astype(np.int64)
    return arr[..., ys[:, None], xs[None, :]]


def packed_masks(masks: list[np.ndarray], height: int, width: int,
                 max_instances: int) -> np.ndarray:
    """The first `max_instances` masks, nearest-resized to the bucket, as an
    (H, W) int64 bitfield (instance i in bit i)."""
    out = np.zeros((height, width), np.int64)
    for i, m in enumerate(masks[:max_instances]):
        out[resize_nearest(m, height, width)] |= np.int64(1) << i
    return out
