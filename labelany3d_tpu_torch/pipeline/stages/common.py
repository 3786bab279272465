"""Shared stage plumbing: image sources, resizing, instance padding/packing.
Counterpart of `labelany3d_tpu/pipeline/stages/common.py`; Pillow is
imported only where an image is decoded or actually resized."""

from __future__ import annotations

import os
from typing import Protocol

import numpy as np


class ImageSource(Protocol):
    def get(self, image_info: dict) -> np.ndarray:
        """Return (H, W, 3) uint8 RGB for an images[] entry."""
        ...


class FileImageSource:
    """Reads `images_root/<file_name>`."""

    def __init__(self, images_root: str):
        self.images_root = images_root

    def get(self, image_info: dict) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.images_root, image_info["file_name"])
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


class ArrayImageSource:
    """In-memory source keyed by image id (tests, synthetic scenes)."""

    def __init__(self, images_by_id: dict[int, np.ndarray]):
        self.images_by_id = images_by_id

    def get(self, image_info: dict) -> np.ndarray:
        return self.images_by_id[image_info["id"]]


def resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear uint8 image resize on the host (Pillow, antialiased)."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))


def resize_nearest(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest resize for depth maps and masks."""
    h, w = arr.shape[-2], arr.shape[-1]
    if h == height and w == width:
        return arr
    ys = np.floor(np.arange(height) * (h / height)).astype(np.int64)
    xs = np.floor(np.arange(width) * (w / width)).astype(np.int64)
    return arr[..., ys[:, None], xs[None, :]]


def pad_instances(masks: np.ndarray, max_instances: int) -> tuple[np.ndarray, np.ndarray]:
    """(I, H, W) -> ((max_I, H, W), keep flags). Overflow instances drop."""
    i, h, w = masks.shape
    out = np.zeros((max_instances, h, w), bool)
    n = min(i, max_instances)
    out[:n] = masks[:n]
    kept = np.zeros(max_instances, bool)
    kept[:n] = True
    return out, kept


def pack_instance_masks(masks: np.ndarray) -> np.ndarray:
    """(I, H, W) bool -> (H, W) bitfield, instance i in bit i (I <= 32);
    `labeling.unpack_instance_masks` restores it on the device."""
    i, h, w = masks.shape
    if i > 32:
        raise ValueError(f"bit packing supports <=32 instance slots, got {i}")
    dtype = np.uint8 if i <= 8 else np.uint16 if i <= 16 else np.uint32
    out = np.zeros((h, w), dtype)
    for b in range(i):
        out[masks[b]] |= dtype(1 << b)
    return out
