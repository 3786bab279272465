"""The on-disk scene-directory contract (checkpoint/resume surface).

The reference's inter-stage API *is* the filesystem: every stage writes named
artifacts into `save_dir/split/<scene>/` and later stages (and resume) key on
their existence (SURVEY.md §5; `docs/COCO_PIPELINE.md:121-145`). This module
keeps that contract bit-compatible so users of the reference find the same
tree:

  input.png                 original image
  depth_map.npy             aligned metric depth (stage 1)
  cam_params.json           {K, c2w, W, H}
  depth_scene.ply           scene point cloud (optional artifact)
  enhanced/input.png        super-resolved image (stage 2)
  bboxes.json               selected 2D boxes (stage 3)
  crops/{id}_reproj.png     square RGBA crop (stage 3)
  crops/{id}_crop_params.npy  [offset_x, offset_y, scale]
  crops/{id}_rgba.png       amodal-completed crop (stage 4)
  object_space/{id}/estimated_elevation.npy   (stage 5)
  object_space/{id}.glb     generated object mesh (stage 6)
  reconstruction/{id}.glb   scene-space mesh (stage 7)
  reconstruction/{id}_canonical_upright.npy   (stage 7)
  3dbbox.json               final ground-aligned boxes (stage 7)
  vis_3dbox.png             overlay visualization
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


def scene_dir_name(file_name: str) -> str:
    """Image file name -> scene directory name.

    Parity: `src/batch_scripts/depth.py:124` (strip extension, '/'->'_',
    '-'->'_').
    """
    return file_name.split(".")[0].replace("/", "_").replace("-", "_")


class SceneDir:
    """Typed accessor for one scene's artifact tree."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)

    # -- layout -----------------------------------------------------------
    def ensure(self) -> "SceneDir":
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "crops").mkdir(exist_ok=True)
        (self.root / "object_space").mkdir(exist_ok=True)
        (self.root / "reconstruction").mkdir(exist_ok=True)
        return self

    @property
    def input_image(self) -> Path:
        return self.root / "input.png"

    @property
    def depth_map(self) -> Path:
        return self.root / "depth_map.npy"

    @property
    def cam_params(self) -> Path:
        return self.root / "cam_params.json"

    @property
    def enhanced_image(self) -> Path:
        return self.root / "enhanced" / "input.png"

    @property
    def bboxes2d(self) -> Path:
        return self.root / "bboxes.json"

    @property
    def bbox3d(self) -> Path:
        return self.root / "3dbbox.json"

    @property
    def bbox3d_ground(self) -> Path:
        return self.root / "3dbbox_ground.json"

    def crop(self, obj_id: str) -> Path:
        return self.root / "crops" / f"{obj_id}_reproj.png"

    def crop_params(self, obj_id: str) -> Path:
        return self.root / "crops" / f"{obj_id}_crop_params.npy"

    def crop_completed(self, obj_id: str) -> Path:
        return self.root / "crops" / f"{obj_id}_rgba.png"

    def elevation(self, obj_id: str) -> Path:
        return self.root / "object_space" / str(obj_id) / "estimated_elevation.npy"

    def object_mesh(self, obj_id: str) -> Path:
        return self.root / "object_space" / f"{obj_id}.glb"

    def scene_mesh(self, obj_id: str) -> Path:
        return self.root / "reconstruction" / f"{obj_id}.glb"

    def canonical_upright(self, obj_id: str) -> Path:
        return self.root / "reconstruction" / f"{obj_id}_canonical_upright.npy"

    # -- resume predicates (skip-if-exists parity) ------------------------
    def depth_done(self) -> bool:
        """Parity: `depth.py:141-142`."""
        return self.depth_map.exists() and self.cam_params.exists()

    def boxes_done(self) -> bool:
        """Parity: `whole.py:61-62`."""
        return self.bbox3d.exists()

    def crops_done(self, obj_id: str) -> bool:
        """Parity: `get_crops_enhanced.py:95`."""
        return self.crop(obj_id).exists() and self.crop_params(obj_id).exists()

    # -- typed IO ---------------------------------------------------------
    def write_cam_params(self, K: np.ndarray, c2w: np.ndarray, width: int, height: int) -> None:
        payload = {
            "K": np.asarray(K, np.float64).tolist(),
            "c2w": np.asarray(c2w, np.float64).tolist(),
            "W": int(width),
            "H": int(height),
        }
        self.cam_params.write_text(json.dumps(payload))

    def read_cam_params(self) -> dict:
        return json.loads(self.cam_params.read_text())

    def write_depth(self, depth: np.ndarray) -> None:
        np.save(self.depth_map, np.asarray(depth, np.float32))

    def read_depth(self) -> np.ndarray:
        return np.load(self.depth_map)

    def write_bbox3d(self, bbox_list: list[dict]) -> None:
        self.bbox3d.write_text(json.dumps(bbox_list))

    def read_bbox3d(self) -> list[dict]:
        return json.loads(self.bbox3d.read_text())

    def write_bboxes2d(self, boxes: np.ndarray) -> None:
        self.bboxes2d.write_text(json.dumps(np.asarray(boxes, np.float64).tolist()))

    def list_crop_ids(self) -> list[str]:
        """Object ids from crop file names (the reference encodes metadata in
        names and parses it back, `src/util_3dbox.py:252-254`)."""
        crops = sorted((self.root / "crops").glob("*_reproj.png"))
        return [p.stem.replace("_reproj", "") for p in crops]
