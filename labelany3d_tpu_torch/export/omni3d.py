"""Omni3D-format COCO3D JSON export.

Parity target: `src/tools/combine_results.py:147-311` in the reference repo:
per-scene `3dbbox.json` + `cam_params.json` (+ optional `bboxes.json` 2D
boxes) are merged into one JSON with `images[]` / `annotations[]`, Omni3D
category ids, projected/truncated 2D boxes, and Hungarian-matched tight 2D
boxes. Dataset ids (22/23), image-id offsets (1e6/2e6) and annotation-id
offsets (1e8/2e8) follow the reference so downstream consumers (OVMono3D
finetuning on COCO3D) see an identical schema.

The per-annotation math (corner projection, box clamping) is pure and
batched (`project_corners_to_2d_box`); the directory walk and JSON assembly
stay on host where they belong.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from labelany3d_tpu_torch.data.categories import CATEGORY_NAME_TO_OMNI3D_ID, OMNI3D_CATEGORIES
from labelany3d_tpu_torch.export.hungarian import hungarian_match


def project_corners_to_2d_box(corners: np.ndarray, K: np.ndarray, width: int, height: int):
    """(..., 8, 3) corner sets -> (proj_box, trunc_box) in xyxy.

    Parity: `combine_results.py:237-252` (no clamping for bbox2D_proj,
    image-bounds clamping for bbox2D_trunc).
    """
    corners = np.asarray(corners, np.float64)
    uvw = corners @ np.asarray(K, np.float64).T
    uv = uvw[..., :2] / uvw[..., 2:3]
    min_xy = uv.min(axis=-2)
    max_xy = uv.max(axis=-2)
    proj = np.concatenate([min_xy, max_xy], axis=-1)
    trunc = np.stack(
        [
            np.maximum(0.0, min_xy[..., 0]),
            np.maximum(0.0, min_xy[..., 1]),
            np.minimum(float(width), max_xy[..., 0]),
            np.minimum(float(height), max_xy[..., 1]),
        ],
        axis=-1,
    )
    return proj, trunc


def scene_to_omni3d(
    scene_name: str,
    cam_params: dict,
    bbox_list: list[dict],
    bbox2d_list: list | None,
    split: str,
    image_id: int,
    annotation_id_start: int,
    dataset_id: int,
    tight_fallback: bool = True,
) -> tuple[dict | None, list[dict]]:
    """Convert one scene's artifacts into (image_dict, annotations).

    Returns (None, []) only when the scene has no boxes at all (the
    reference skips such scenes, `combine_results.py:213-215`). When boxes
    exist but every annotation is dropped for an unknown category, the image
    entry is still emitted (and the caller still advances image_id), exactly
    as the reference does — so image ids and file mappings stay aligned.

    `tight_fallback` (default on) is an intentional robustness improvement
    over the reference: annotations left UNMATCHED by Hungarian matching get
    `bbox2D_tight = bbox2D_trunc` instead of a missing key, so downstream
    consumers never KeyError. Pass False to reproduce the reference
    bit-for-bit (`combine_results.py:278-286`): when matching ran, losers
    keep a missing key; when no 2D boxes exist at all, the reference itself
    falls back to `bbox2D_tight = bbox2D_trunc` for every annotation
    (its `else` branch) — verified against the reference's own module in
    `tests/test_parity_export.py`.
    """
    K = np.asarray(cam_params["K"], np.float64)
    H, W = cam_params["H"], cam_params["W"]
    if not bbox_list:
        return None, []

    image_dict = {
        "width": int(W),
        "height": int(H),
        "file_path": f"coco/images/{split}2017/{scene_name}.jpg",
        "K": K.tolist(),
        "src_90_rotate": 0,
        "src_flagged": False,
        "incomplete": False,
        "id": image_id,
        "dataset_id": dataset_id,
    }

    annotations: list[dict] = []
    annotation_id = annotation_id_start
    for anno in bbox_list:
        category_name = anno.get("category_name", "").replace("_", " ")
        category_id = CATEGORY_NAME_TO_OMNI3D_ID.get(category_name, -1)
        if category_id == -1:
            continue
        corners = np.asarray(anno["bbox3D_cam"], np.float64)
        proj, trunc = project_corners_to_2d_box(corners, K, int(W), int(H))
        annotations.append(
            {
                "behind_camera": False,
                "truncation": 0.0,
                "visibility": 1,
                "segmentation_pts": -1,
                "lidar_pts": -1,
                "valid3D": True,
                "category_name": category_name,
                "category_id": category_id,
                "image_id": image_id,
                "id": annotation_id,
                "dataset_id": dataset_id,
                "center_cam": anno.get("center_cam"),
                "dimensions": anno.get("dimensions"),
                "R_cam": anno.get("R_cam"),
                "bbox3D_cam": anno.get("bbox3D_cam"),
                "bbox2D_proj": list(map(float, proj)),
                "bbox2D_trunc": list(map(float, trunc)),
                "depth_error": -1,
            }
        )
        annotation_id += 1

    # Tight 2D boxes: Hungarian-match the truncated projections against the
    # scene's COCONUT 2D boxes; fall back to the truncated projection.
    matched = False
    if bbox2d_list and annotations:
        trunc_boxes = np.asarray([a["bbox2D_trunc"] for a in annotations], np.float64)
        matches = hungarian_match(trunc_boxes, np.asarray(bbox2d_list, np.float64))
        for i, j, _iou in matches:
            annotations[i]["bbox2D_tight"] = bbox2d_list[j]
        matched = True
    if tight_fallback or not matched:
        for a in annotations:
            a.setdefault("bbox2D_tight", a["bbox2D_trunc"])

    return image_dict, annotations


def combine_results(
    results_dir: str,
    split: str,
    output_path: str | None = None,
    bbox_filename: str = "3dbbox.json",
) -> dict:
    """Walk `results_dir/split/*/` scene dirs and emit the combined JSON.

    Directory/file contract parity: `combine_results.py:147-311`.
    """
    scene_root = os.path.join(results_dir, split)
    if not os.path.exists(scene_root):
        raise FileNotFoundError(f"Results directory not found: {scene_root}")
    scene_ids = sorted(
        d for d in os.listdir(scene_root) if os.path.isdir(os.path.join(scene_root, d))
    )

    dataset_id = 22 if split == "val" else 23
    image_id = 1000000 if split == "val" else 2000000
    annotation_id = 100000000 if split == "val" else 200000000

    images: list[dict] = []
    annotations: list[dict] = []
    for scene_name in scene_ids:
        scene_path = os.path.join(scene_root, scene_name)
        bbox_path = os.path.join(scene_path, bbox_filename)
        cam_path = os.path.join(scene_path, "cam_params.json")
        bbox2d_path = os.path.join(scene_path, "bboxes.json")
        if not (os.path.exists(bbox_path) and os.path.exists(cam_path)):
            continue
        with open(cam_path) as f:
            cam_params = json.load(f)
        with open(bbox_path) as f:
            bbox_list = json.load(f)
        bbox2d_list = None
        if os.path.exists(bbox2d_path):
            with open(bbox2d_path) as f:
                bbox2d_list = json.load(f)
        image_dict, local = scene_to_omni3d(
            scene_name, cam_params, bbox_list, bbox2d_list, split,
            image_id, annotation_id, dataset_id,
        )
        if image_dict is None:
            continue
        images.append(image_dict)
        annotations.extend(local)
        annotation_id += len(local)
        image_id += 1

    output: dict[str, Any] = {
        "info": {
            "id": dataset_id,
            "source": "COCO",
            "name": f"COCO {'Validation' if split == 'val' else 'Train'}",
            "split": split.capitalize(),
            "version": "0.1",
            "url": "https://cocodataset.org/#home",
        },
        "categories": OMNI3D_CATEGORIES,
        "images": images,
        "annotations": annotations,
    }
    if output_path is not None:
        parent = os.path.dirname(output_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(output, f)
    return output
