"""Stages 2, 4, 5 and 6 with their shipping-default backends.

Counterpart of `labelany3d_tpu/pipeline/stages/generative.py`:

  * EnhanceStage (stage 2): 4x upscale -> `enhanced/input.png`. Default
    backend: Pillow's BICUBIC, computed on the stage's device.
  * CompletionStage (stage 4): amodal crop completion -> `crops/{id}_rgba.png`.
    Default: passthrough (`run.amodal_completion=None`).
  * ElevationStage (stage 5): per-object camera elevation ->
    `object_space/{id}/estimated_elevation.npy`. Default: 0 degrees.
  * ReconstructionStage (stage 6): image -> 3D -> `object_space/{id}.glb`.
    Default: silhouette extrusion.

Each stage skips the artifacts that exist (resume). The generative backends
(InvSR, the amodal completion, Zero123 elevation: `models/diffusion/`;
TRELLIS: `models/trellis/`) come from `pipeline/backends.py`'s factories;
Hunyuan3D is not ported, and its names raise there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh, save_glb
from labelany3d_tpu_torch.models.layers import resize_bicubic_8bit
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.png import read_png, write_png


class BicubicEnhance:
    """Non-generative 4x upscale (the stage-2 default): Pillow's BICUBIC
    (`models/layers.py::resize_bicubic_8bit`) on `device`."""

    def __init__(self, factor: int = 4, device: str | torch.device | None = None):
        self.factor = factor
        self.device = resolve_device(device)

    @torch.inference_mode()
    def enhance(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        x = torch.tensor(image, device=self.device)
        y = resize_bicubic_8bit(x.permute(2, 0, 1)[None], (h * self.factor, w * self.factor))
        return y[0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()


class PassthroughCompletion:
    """`run.amodal_completion=None`: the crop as it is."""

    def complete(self, crop_rgba: np.ndarray, label: str) -> np.ndarray:
        return crop_rgba


class ZeroElevation:
    """The 0-degree elevation (the reference's fallback when estimation fails)."""

    def estimate(self, crop_rgba: np.ndarray) -> float:
        from labelany3d_tpu_torch.utils.logging import warn_once

        warn_once("elevation_zero",
                  "elevation backend is the 0-degree fallback (no Zero123 weights): "
                  "per-object camera elevation is not estimated")
        return 0.0


class SilhouetteExtrude:
    """Deterministic image->3D baseline: extrude the crop mask silhouette.

    A watertight prism whose front and back faces follow the mask on a
    coarse grid, centred and unit-normalised like a generative
    reconstructor's output, vertex-coloured from the crop."""

    def __init__(self, grid: int = 32, depth_ratio: float = 0.4):
        self.grid = grid
        self.depth_ratio = depth_ratio

    def reconstruct(self, crop_rgba: np.ndarray, label: str = "") -> Mesh:
        is_u8 = crop_rgba.dtype == np.uint8
        alpha = crop_rgba[..., 3] > (127 if is_u8 else 0.5)
        h, w = alpha.shape
        g = self.grid
        ys = (np.arange(g) * (h / g)).astype(int)
        xs = (np.arange(g) * (w / g)).astype(int)
        occ = alpha[np.ix_(ys, xs)]
        if not occ.any():
            occ = np.zeros((g, g), bool)
            occ[g // 2, g // 2] = True

        cell = 1.0 / g
        verts: list[list[float]] = []
        faces: list[list[int]] = []
        colors: list[list[float]] = []
        rgb = crop_rgba[..., :3].astype(np.float32)
        if is_u8:
            rgb = rgb / 255.0
        hd = self.depth_ratio / 2

        def add_quad(p0, p1, p2, p3, color):
            base = len(verts)
            verts.extend([p0, p1, p2, p3])
            colors.extend([color] * 4)
            faces.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])

        def boundary(ii, jj):
            return not (0 <= ii < g and 0 <= jj < g and occ[ii, jj])

        for i in range(g):
            for j in range(g):
                if not occ[i, j]:
                    continue
                # normalised object coords: x right, y up, z depth
                x0 = j * cell - 0.5
                x1 = x0 + cell
                y0, y1 = 0.5 - (i + 1) * cell, 0.5 - i * cell
                color = rgb[ys[i], xs[j]].tolist()
                add_quad([x0, y0, hd], [x1, y0, hd], [x1, y1, hd], [x0, y1, hd], color)
                add_quad([x0, y0, -hd], [x0, y1, -hd], [x1, y1, -hd], [x1, y0, -hd], color)
                if boundary(i - 1, j):  # top
                    add_quad([x0, y1, -hd], [x0, y1, hd], [x1, y1, hd], [x1, y1, -hd], color)
                if boundary(i + 1, j):  # bottom
                    add_quad([x0, y0, -hd], [x1, y0, -hd], [x1, y0, hd], [x0, y0, hd], color)
                if boundary(i, j - 1):  # left
                    add_quad([x0, y0, -hd], [x0, y0, hd], [x0, y1, hd], [x0, y1, -hd], color)
                if boundary(i, j + 1):  # right
                    add_quad([x1, y0, -hd], [x1, y1, -hd], [x1, y1, hd], [x1, y0, hd], color)

        return Mesh(vertices=np.asarray(verts, np.float32), faces=np.asarray(faces, np.int32),
                    colors=np.asarray(colors, np.float32))


class _PerSceneStage:
    def __init__(self, cfg: PipelineConfig, loader, save_dir: str, split: str):
        self.cfg = cfg
        self.loader = loader
        self.save_dir = save_dir
        self.split = split

    def _scenes(self, start_index: int, end_index: int):
        for i in range(start_index, end_index):
            info = self.loader.get_image_by_index(i)
            yield info, SceneDir(os.path.join(self.save_dir, self.split,
                                              scene_dir_name(info["file_name"]))).ensure()

    @staticmethod
    def _object_crop(scene: SceneDir, obj_id: str):
        """The completed crop when stage 4 wrote one, else the plain crop."""
        path = scene.crop_completed(obj_id)
        return read_png(path if path.exists() else scene.crop(obj_id))


class EnhanceStage(_PerSceneStage):
    """Stage 2: the image -> `enhanced/input.png`, unless it exists."""

    def __init__(self, cfg, loader, image_source, save_dir, split, backend=None,
                 device: str | torch.device | None = None):
        super().__init__(cfg, loader, save_dir, split)
        self.image_source = image_source
        self.backend = backend or BicubicEnhance(device=device)

    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for info, scene in self._scenes(start_index, end_index):
            if scene.enhanced_image.exists():
                continue
            out = self.backend.enhance(self.image_source.get(info))
            scene.enhanced_image.parent.mkdir(exist_ok=True)
            write_png(scene.enhanced_image, out)
            done += 1
        return done


class CompletionStage(_PerSceneStage):
    """Stage 4: every crop -> `crops/{id}_rgba.png`, unless it exists."""

    def __init__(self, cfg, loader, save_dir, split, backend=None):
        super().__init__(cfg, loader, save_dir, split)
        self.backend = backend or PassthroughCompletion()

    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for _info, scene in self._scenes(start_index, end_index):
            for obj_id in scene.list_crop_ids():
                out_path = scene.crop_completed(obj_id)
                if out_path.exists():
                    continue
                label = obj_id.split("_", 1)[-1].replace("_", " ")
                completed = self.backend.complete(read_png(scene.crop(obj_id)), label)
                write_png(out_path, completed.astype(np.uint8))
            done += 1
        return done


class ElevationStage(_PerSceneStage):
    """Stage 5: every object's camera elevation (degrees) ->
    `object_space/{id}/estimated_elevation.npy`, unless it exists."""

    def __init__(self, cfg, loader, save_dir, split, backend=None):
        super().__init__(cfg, loader, save_dir, split)
        self.backend = backend or ZeroElevation()

    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for _info, scene in self._scenes(start_index, end_index):
            for obj_id in scene.list_crop_ids():
                out_path = scene.elevation(obj_id)
                if out_path.exists():
                    continue
                elev = float(self.backend.estimate(self._object_crop(scene, obj_id)))
                out_path.parent.mkdir(parents=True, exist_ok=True)
                np.save(out_path, np.float64(elev))
            done += 1
        return done


class ReconstructionStage(_PerSceneStage):
    """Stage 6: every crop of a scene -> `object_space/{id}.glb`; existing
    meshes are kept (resume). Reads the completed crop when stage 4 wrote
    one, else the plain crop."""

    def __init__(self, cfg: PipelineConfig, loader, save_dir: str, split: str, backend=None):
        super().__init__(cfg, loader, save_dir, split)
        self.backend = backend or SilhouetteExtrude()

    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for _info, scene in self._scenes(start_index, end_index):
            for obj_id in scene.list_crop_ids():
                out_path = scene.object_mesh(obj_id)
                if out_path.exists():
                    continue
                label = obj_id.split("_", 1)[-1].replace("_", " ")
                save_glb(out_path, self.backend.reconstruct(self._object_crop(scene, obj_id),
                                                            label))
            done += 1
        return done
