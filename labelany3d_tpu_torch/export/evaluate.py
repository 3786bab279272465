"""COCO3D label-set comparison: mean 3D IoU between two Omni3D JSONs.

Counterpart of `labelany3d_tpu/export/evaluate.py`: annotations of two
COCO3D files are matched by image `file_path`, then by Hungarian matching
on their 2D tight boxes within the image (pairs under 0.25 2D IoU are not
the same object), and the matched pairs are scored with the
stratified-grid oriented IoU (`export/iou3d.py`). The JAX package scores
one pair a call; here every matched pair of a file goes through
`box3d_iou` together, CHUNK pairs a call, on `device`.

CLI:  python -m labelany3d_tpu_torch.export.evaluate ours.json theirs.json
      [--grid 32] [--device cuda]
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np
import torch

from labelany3d_tpu_torch.export.hungarian import hungarian_match
from labelany3d_tpu_torch.export.iou3d import box3d_iou
from labelany3d_tpu_torch.utils.device import resolve_device

# Matched pairs scored per box3d_iou call: 1024 pairs at the 32^3 grid hold
# about 0.4 GB in each of the grid-point tensors.
CHUNK = 1024


def _index_by_image(data: dict) -> dict:
    images = {img["id"]: img for img in data["images"]}
    per_image = defaultdict(list)
    for anno in data["annotations"]:
        img = images.get(anno["image_id"])
        if img is None:
            continue
        per_image[img["file_path"]].append(anno)
    return per_image


def matched_corners(ours: dict, theirs: dict) -> tuple[np.ndarray, np.ndarray, dict]:
    """The matched pairs' corners, (P, 8, 3) float32 each, in the JAX
    function's order (shared file paths sorted, then each image's
    Hungarian pairs), and the counts."""
    ours_ix = _index_by_image(ours)
    theirs_ix = _index_by_image(theirs)
    shared = sorted(set(ours_ix) & set(theirs_ix))
    ca, cb = [], []
    for fp in shared:
        a_list, b_list = ours_ix[fp], theirs_ix[fp]
        boxes_a = np.asarray([a.get("bbox2D_tight", a["bbox2D_trunc"]) for a in a_list], float)
        boxes_b = np.asarray([b.get("bbox2D_tight", b["bbox2D_trunc"]) for b in b_list], float)
        for i, j, iou2d in hungarian_match(boxes_a, boxes_b):
            if iou2d < 0.25:
                continue  # not the same object
            ca.append(a_list[i]["bbox3D_cam"])
            cb.append(b_list[j]["bbox3D_cam"])
    counts = {"images_shared": len(shared),
              "annotations_ours": sum(len(v) for v in ours_ix.values()),
              "annotations_theirs": sum(len(v) for v in theirs_ix.values())}
    shape = (-1, 8, 3)
    return (np.asarray(ca, np.float32).reshape(shape), np.asarray(cb, np.float32).reshape(shape),
            counts)


def pair_ious(ca: np.ndarray, cb: np.ndarray, grid: int = 32, device=None) -> torch.Tensor:
    """box3d_iou of (P, 8, 3) corner pairs on `device`, CHUNK pairs a call;
    (P,) float32 on that device."""
    dev = resolve_device(device)
    a = torch.from_numpy(ca).to(dev)
    b = torch.from_numpy(cb).to(dev)
    if not len(a):
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    return torch.cat([box3d_iou(a[i:i + CHUNK], b[i:i + CHUNK], grid)
                      for i in range(0, len(a), CHUNK)])


def compare_coco3d(ours: dict, theirs: dict, grid: int = 32, device=None) -> dict:
    """Match and score two loaded COCO3D dicts; returns summary stats (the
    JAX function's keys). `device` defaults to CUDA."""
    ca, cb, counts = matched_corners(ours, theirs)
    ious = pair_ious(ca, cb, grid, device).cpu().numpy().astype(np.float64)
    has = len(ious) > 0
    return {
        **counts,
        "matched_pairs": int(len(ious)),
        "mean_iou3d": float(np.mean(ious)) if has else 0.0,
        "median_iou3d": float(np.median(ious)) if has else 0.0,
        "iou3d_ge_0.5": float(np.mean(ious >= 0.5)) if has else 0.0,
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Compare two COCO3D JSONs by 3D IoU")
    p.add_argument("ours")
    p.add_argument("theirs")
    p.add_argument("--grid", type=int, default=32)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    with open(args.ours) as f:
        ours = json.load(f)
    with open(args.theirs) as f:
        theirs = json.load(f)
    print(json.dumps(compare_coco3d(ours, theirs, args.grid, args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
