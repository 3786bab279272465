"""Panoptic -> instance annotation conversion (COCONUT's panoptic masks).

Counterpart of `labelany3d_tpu/data/panoptic.py`: the COCONUT panoptic
datasets ship RGB-encoded panoptic id masks with their segments_info, and
the pipeline reads instance-format JSON (`coconut_{split}.json`, named by
`OUTPUT_FILENAMES`). `panoptic_rgb_to_ids` decodes the ids (r + g*256 +
b*65536); `convert_panoptic_item` keeps the things, run-length encodes each
segment with the port's RLE codec and gives its XYWH box. The JAX package's
`download_coconut` wraps these around a dataset download, which needs the
network, and is not ported.
"""

from __future__ import annotations

import numpy as np

from labelany3d_tpu_torch.data.rle import rle_encode

OUTPUT_FILENAMES = {
    "relabeled_coco_val": "coconut_val.json",
    "coconut_s": "coconut_train.json",
    "coconut_b": "coconut_train_b.json",
}


def panoptic_rgb_to_ids(panoptic_mask: np.ndarray) -> np.ndarray:
    """RGB-encoded panoptic PNG -> int32 segment-id map.

    Parity: `download_coconut.py:244-249` (id = r + g*256 + b*65536).
    """
    m = np.asarray(panoptic_mask)
    if m.ndim == 3:
        return (
            m[:, :, 0].astype(np.int32)
            + m[:, :, 1].astype(np.int32) * 256
            + m[:, :, 2].astype(np.int32) * 65536
        )
    return m.astype(np.int32)


def convert_panoptic_item(
    panoptic_mask: np.ndarray,
    segments_info: list[dict],
    image_id: int,
    start_annotation_id: int = 0,
    compress_rle: bool = True,
) -> list[dict]:
    """One panoptic image -> COCO-instance annotations (things only)."""
    ids = panoptic_rgb_to_ids(panoptic_mask)
    annotations = []
    anno_id = start_annotation_id
    for seg in segments_info:
        if not seg.get("isthing", 0):
            continue  # thing-only parity (download_coconut.py:255-257)
        anno_id += 1
        mask = ids == seg["id"]
        area = int(mask.sum())
        if area == 0:
            continue
        rows = np.any(mask, axis=1)
        cols = np.any(mask, axis=0)
        y0, y1 = np.flatnonzero(rows)[[0, -1]]
        x0, x1 = np.flatnonzero(cols)[[0, -1]]
        rle = rle_encode(mask, compress=compress_rle)
        counts = rle["counts"]
        if isinstance(counts, bytes):
            counts = counts.decode()
        annotations.append(
            {
                "id": anno_id,
                "image_id": int(image_id),
                "category_id": int(seg.get("category_id", 0)),
                "iscrowd": int(seg.get("iscrowd", 0)),
                "area": area,
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "segmentation": {"size": rle["size"], "counts": counts},
            }
        )
    return annotations
