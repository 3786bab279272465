"""IoU-based bipartite matching on the host (scipy), as
`labelany3d_tpu/export/hungarian.py::hungarian_match`, except that a pair
with a non-finite IoU scores 0 instead of raising. The JAX package's
on-device auction solver (`auction_assignment`) is not ported: no route
calls it (ROADMAP.md queue 1 item 4)."""

from __future__ import annotations

import numpy as np


def hungarian_match(boxes0: np.ndarray, boxes1: np.ndarray) -> list[tuple[int, int, float]]:
    """Exact IoU matching of xyxy boxes; returns [(i, j, iou), ...]."""
    from scipy.optimize import linear_sum_assignment

    b0 = np.asarray(boxes0, np.float32)[:, None, :]
    b1 = np.asarray(boxes1, np.float32)[None, :, :]
    x1 = np.maximum(b0[..., 0], b1[..., 0])
    y1 = np.maximum(b0[..., 1], b1[..., 1])
    x2 = np.minimum(b0[..., 2], b1[..., 2])
    y2 = np.minimum(b0[..., 3], b1[..., 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    a0 = (b0[..., 2] - b0[..., 0]) * (b0[..., 3] - b0[..., 1])
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    iou = inter / (a0 + a1 - inter + 1e-6)
    # A box projected from corners behind the camera has non-finite edges;
    # it overlaps nothing (scipy refuses NaN, so the JAX version raises).
    iou = np.where(np.isfinite(iou), iou, 0.0)
    rows, cols = linear_sum_assignment(-iou)
    return [(int(i), int(j), float(iou[i, j])) for i, j in zip(rows, cols)]
