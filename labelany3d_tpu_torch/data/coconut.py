"""COCONUT instance-annotation loading and host-side instance extraction.

Parity targets in the reference repo:
  * `src/batch_scripts/coconut_loader.py:19-90` (`CoconutLoader`,
    `get_dataset_paths`),
  * `src/util.py:337-415` (`read_bounding_boxes_segmentations`,
    `create_boolean_mask_from_polygon`).

The loader is host-side by design (JSON + index building); mask decoding uses
the self-contained RLE codec (`data/rle.py`) and a scanline polygon
rasterizer (cv2 when present). Filtering thresholds mirror the device-side
`geometry/masks.py::filter_instances` so host and device paths agree.
A copy of `labelany3d_tpu/data/coconut.py` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from labelany3d_tpu_torch.data.categories import category_names
from labelany3d_tpu_torch.data.rle import rle_decode


class CoconutLoader:
    """Load COCONUT instance annotations with an image-id index."""

    def __init__(self, split: str = "val", annotations_dir: str = "../dataset/coco/annotations"):
        self.split = split
        name = "coconut_val.json" if split == "val" else "coconut_train.json"
        json_path = os.path.join(annotations_dir, name)
        with open(json_path, "r") as f:
            data = json.load(f)
        self.images: list[dict] = data["images"]
        self.categories: list[dict] = data.get("categories", [])
        self.annotations_by_image: dict[int, list[Any]] = {}
        for anno in data["annotations"]:
            self.annotations_by_image.setdefault(anno["image_id"], []).append(anno)

    def get_image_by_index(self, index: int) -> dict:
        return self.images[index]

    def get_annotations(self, image_id: int) -> list[dict]:
        return self.annotations_by_image.get(image_id, [])

    def __len__(self) -> int:
        return len(self.images)


def get_dataset_paths(split: str, dataset_root: str = "../dataset/coco") -> tuple[str, str]:
    """(images_dir, annotations_dir) for a split; layout parity with the
    reference's `get_dataset_paths` (`coconut_loader.py:76-90`)."""
    sub = "val2017" if split == "val" else "train2017"
    return os.path.join(dataset_root, "images", sub), os.path.join(dataset_root, "annotations")


def _polygon_mask(image_size: tuple[int, int], segmentation: list) -> np.ndarray:
    """Rasterize COCO polygon lists to a bool mask. image_size = (W, H)."""
    w, h = image_size
    mask = np.zeros((h, w), np.uint8)
    try:
        import cv2

        for polygon in segmentation:
            pts = np.asarray(polygon, np.float64).reshape(-1, 2).astype(np.int32)
            cv2.fillPoly(mask, [pts], color=1)
        return mask.astype(bool)
    except ImportError:
        pass
    # Scanline fallback (even-odd rule), adequate for tests without cv2.
    for polygon in segmentation:
        pts = np.asarray(polygon, np.float64).reshape(-1, 2)
        ys = np.arange(h) + 0.5
        for yi, y in enumerate(ys):
            x0 = pts[:, 0]
            y0 = pts[:, 1]
            x1 = np.roll(x0, -1)
            y1 = np.roll(y0, -1)
            cond = (y0 <= y) != (y1 <= y)
            denom = np.where(y1 != y0, y1 - y0, 1.0)
            xint = x0 + (y - y0) / denom * (x1 - x0)
            crossings = np.sort(xint[cond])
            for a, b in zip(crossings[::2], crossings[1::2]):
                mask[yi, int(np.ceil(a - 0.5)) : int(np.floor(b - 0.5)) + 1] = 1
    return mask.astype(bool)


def decode_annotation_mask(annotation: dict, image_size: tuple[int, int]) -> np.ndarray:
    """Decode one annotation's segmentation to a bool (H, W) mask.

    image_size = (W, H) as in the reference (PIL `Image.size` ordering).
    """
    seg = annotation["segmentation"]
    if isinstance(seg, dict) and "counts" in seg:
        if isinstance(seg["counts"], list):  # uncompressed RLE
            return rle_decode({"size": seg["size"], "counts": seg["counts"]})
        return rle_decode(seg)
    return _polygon_mask(image_size, seg)


@dataclass
class InstanceSet:
    """Filtered instances of one image (host-side, variable length)."""

    bboxes: np.ndarray          # (I, 4) XYWH as stored in COCO
    masks: np.ndarray           # (I, H, W) bool
    labels: list[str] = field(default_factory=list)
    category_ids: list[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.labels)


def read_instances(
    annotations: list[dict],
    image_size: tuple[int, int],
    min_height_frac: float = 0.0625,
    boundary_threshold: int = 10,
    scale_threshold: int = 100,
) -> InstanceSet:
    """Decode + filter instances; host equivalent of
    `src/util.py:337-382`: drop crowds, drop masks that are border-truncated,
    too small, or under 6.25% of the image height."""
    w, h = image_size
    bboxes, masks, cat_ids = [], [], []
    for anno in annotations:
        if anno.get("iscrowd"):
            continue
        if "segmentation" not in anno:
            continue
        mask = decode_annotation_mask(anno, image_size)
        rows = np.any(mask, axis=1)
        if isinstance(anno["segmentation"], dict):
            height = int(rows.sum())  # reference: sum of occupied rows (RLE path)
        else:
            idx = np.flatnonzero(rows)
            height = int(idx[-1] - idx[0] + 1) if idx.size else 0
        m = mask.astype(np.int64)
        b = boundary_threshold
        truncation = m[:b].sum() + m[-b:].sum() + m[:, :b].sum() + m[:, -b:].sum()
        if (
            height / h > min_height_frac
            and truncation < 10
            and m.sum() >= scale_threshold
        ):
            bboxes.append(anno["bbox"])
            masks.append(mask)
            cat_ids.append(anno["category_id"])
    return InstanceSet(
        bboxes=np.asarray(bboxes, np.float64).reshape(-1, 4),
        masks=np.asarray(masks, bool).reshape(-1, h, w) if masks else np.zeros((0, h, w), bool),
        labels=category_names(cat_ids),
        category_ids=cat_ids,
    )


def xywh_to_xyxy(bboxes: np.ndarray) -> np.ndarray:
    """COCO XYWH_ABS -> XYXY_ABS (detectron2 BoxMode.convert equivalent,
    used at `src/batch_scripts/get_crops_enhanced.py:66`)."""
    out = np.asarray(bboxes, np.float64).copy().reshape(-1, 4)
    out[:, 2] += out[:, 0]
    out[:, 3] += out[:, 1]
    return out
