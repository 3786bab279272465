"""Stage 7: scene layout -- register generated meshes, fit ground-aligned boxes.

Counterpart of `labelany3d_tpu/pipeline/stages/layout.py` (the reference's
`whole.py`): per image, restore each object's full-image mask from its crop,
register all of the image's meshes in one batched pass (matcher + PnP +
median-depth scale, `registration.process`), place each mesh by its
transform, the camera pose and the convention flip diag(-1, -1, 1), write
per-object and full-scene meshes, then fit ground-aligned boxes to 500
surface samples per mesh in one `fit_boxes_batch` call (with
`bbox_method=minarea_pallas`, one launch of the yaw kernel) and write
`3dbbox.json` and the overlay.

Like the JAX package, an object whose registration finds no pose stays at
identity, and an image whose registration raises is skipped; unlike it,
every caught error is also kept in `self.failures` (file name, error), so a
run can tell a model that found no pose from a stage that raised.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh, load_glb, save_glb
from labelany3d_tpu_torch.geometry.boxfit import fit_boxes_batch
from labelany3d_tpu_torch.geometry.crops import restore_mask_from_crop
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.registration.process import (
    MatcherBackend,
    ObjectToRegister,
    register_objects,
)
from labelany3d_tpu_torch.registration.renderer import OrbitRenderer
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.png import read_png

# The camera-convention flip applied to every placed mesh (whole.py:111-114).
CONVENTION_FLIP = np.diag([-1.0, -1.0, 1.0, 1.0])


class LayoutStage:
    def __init__(self, cfg: PipelineConfig, loader, save_dir: str, split: str,
                 matcher: MatcherBackend, renderer: OrbitRenderer | None = None,
                 num_box_points: int = 500, device: str | torch.device | None = None,
                 draws=None):
        self.cfg = cfg
        self.loader = loader
        self.save_dir = save_dir
        self.split = split
        self.matcher = matcher
        self.device = resolve_device(device)
        if renderer is None:
            # The canonical 512^2, fx=560.44 render camera scaled to the
            # configured resolution.
            from labelany3d_tpu_torch.registration.cameras import RENDER_K, RENDER_SIZE

            K = RENDER_K.copy()
            K[:2] *= cfg.render_size / RENDER_SIZE
            renderer = OrbitRenderer(image_size=cfg.render_size, K=K, device=self.device)
        self.renderer = renderer
        self.num_box_points = num_box_points
        # RANSAC draws: `draws(image_index, stage, object, n_valid)` when
        # given (parity tests), else this generator.
        self.draws = draws
        self.generator = torch.Generator(device=renderer.device).manual_seed(cfg.seed + 21)
        self.failures: list[tuple[str, str]] = []

    def _objects(self, scene: SceneDir, image_hw):
        """Every registrable object of a scene, crops in reverse order as the
        reference iterates them (whole.py:71-73)."""
        obj_ids, objects = [], []
        for obj_id in reversed(scene.list_crop_ids()):
            if not scene.crop_params(obj_id).exists():
                continue
            crop_path = scene.crop_completed(obj_id)
            if not crop_path.exists():
                crop_path = scene.crop(obj_id)
            crop = read_png(crop_path)
            cp = np.load(scene.crop_params(obj_id))
            mask = restore_mask_from_crop(torch.as_tensor(crop[:, :, 3] > 127),
                                          float(cp[0]), float(cp[1]), float(cp[2]),
                                          image_hw).numpy()
            elev_path = scene.elevation(obj_id)
            elevation = float(np.load(elev_path)) if elev_path.exists() else 0.0
            mesh_path = scene.object_mesh(obj_id)
            if not mesh_path.exists():
                continue
            mesh = load_glb(mesh_path)
            if mesh.is_empty:
                continue
            obj_ids.append(obj_id)
            objects.append(ObjectToRegister(
                mesh=mesh, ref_crop_rgba=crop.astype(np.float32) / 255.0,
                elevation_deg=elevation,
                crop_params=(float(cp[0]), float(cp[1]), float(cp[2])), scene_mask=mask))
        return obj_ids, objects

    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for i in range(start_index, end_index):
            info = self.loader.get_image_by_index(i)
            scene = SceneDir(os.path.join(self.save_dir, self.split,
                                          scene_dir_name(info["file_name"]))).ensure()
            if scene.boxes_done() or not scene.depth_done():
                continue
            cam = scene.read_cam_params()
            K_img = np.asarray(cam["K"], np.float64)
            pose = np.asarray(cam["c2w"], np.float64)
            depth_map = scene.read_depth()
            obj_ids, objects = self._objects(scene, depth_map.shape)

            draws = None if self.draws is None else (
                lambda stage, obj, n, i=i: self.draws(i, stage, obj, n))
            try:
                regs = register_objects(objects, K_img, depth_map.shape, depth_map,
                                        self.matcher, renderer=self.renderer, draws=draws,
                                        generator=self.generator)
            except Exception as e:  # per-image tolerance (whole.py:104-107), recorded
                print(f"Error aligning scene {info['file_name']}: {e!r}")
                self.failures.append((info["file_name"], repr(e)))
                regs = []

            placed: list[tuple[str, Mesh, np.ndarray]] = []
            for obj_id, ob, reg in zip(obj_ids, objects, regs):
                # identity on failure or empty overlap (util.py:489-493)
                transform = reg.transform if reg.ok else np.eye(4)
                mesh = ob.mesh
                mesh.apply_transform(transform)
                mesh.apply_transform(pose)
                mesh.apply_transform(CONVENTION_FLIP)
                save_glb(scene.scene_mesh(obj_id), mesh)
                canonical_upright = (CONVENTION_FLIP @ transform)[:, 1]
                np.save(scene.canonical_upright(obj_id), canonical_upright)
                placed.append((obj_id, mesh, canonical_upright))
            if not placed:
                continue

            offsets = np.cumsum([0] + [len(m.vertices) for _, m, _ in placed[:-1]])
            save_glb(scene.root / "reconstruction" / "full_scene.glb",
                     Mesh(np.concatenate([m.vertices for _, m, _ in placed]),
                          np.concatenate([m.faces + off for (_, m, _), off
                                          in zip(placed, offsets)]).astype(np.int32)))
            cubes = self._write_ground_boxes(scene, placed)
            try:
                from labelany3d_tpu_torch.utils.visualization import draw_cube_overlay

                draw_cube_overlay(scene, image=read_png(scene.input_image), K=K_img,
                                  cubes=cubes)
            except ImportError as e:  # the overlay is optional (needs OpenCV)
                from labelany3d_tpu_torch.utils.logging import warn_once

                warn_once("overlay", f"vis_3dbox.png skipped: {e}")
            done += 1
        return done

    def _write_ground_boxes(self, scene: SceneDir, placed) -> list[dict]:
        """Ground-aligned boxes of every placed mesh in one batched fit
        (util_3dbox.py:231-294); the object count is padded to
        `cfg.max_instances` slots, as in the JAX package."""
        n = len(placed)
        pts = np.stack([m.sample(self.num_box_points, seed=j)
                        for j, (_, m, _) in enumerate(placed)])
        ups = np.stack([u[:3] for _, _, u in placed]).astype(np.float32)
        valid = np.ones((n, self.num_box_points), bool)
        n_pad = max(self.cfg.max_instances, n)
        if n_pad != n:
            pts = np.concatenate([pts, np.zeros((n_pad - n, *pts.shape[1:]), pts.dtype)])
            ups = np.concatenate([ups, np.tile([[0.0, 1.0, 0.0]], (n_pad - n, 1))
                                  .astype(np.float32)])
            valid = np.concatenate([valid, np.zeros((n_pad - n, self.num_box_points), bool)])
        dev = self.renderer.device
        boxes = fit_boxes_batch(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                                torch.as_tensor(valid, device=dev),
                                torch.as_tensor(ups, device=dev), method=self.cfg.bbox_method)
        boxes = type(boxes)(*(t.cpu().numpy() for t in boxes))
        bbox_list = []
        for j, (obj_id, _m, _u) in enumerate(placed):
            if not boxes.ok[j]:
                continue
            parts = obj_id.split("_", 1)
            bbox_list.append({
                "obj_id": parts[0],
                "category_name": parts[1] if len(parts) > 1 else "unknown",
                "center_cam": boxes.center_cam[j].tolist(),
                "R_cam": boxes.R_cam[j].tolist(),
                "dimensions": boxes.dimensions[j].tolist(),
                "bbox3D_cam": boxes.vertices[j].tolist(),
            })
        scene.bbox3d_ground.write_text(json.dumps(bbox_list))
        os.replace(scene.bbox3d_ground, scene.bbox3d)  # whole.py:131-132
        return bbox_list
