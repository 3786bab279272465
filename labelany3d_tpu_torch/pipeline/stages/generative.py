"""Stage 6, reconstruction, with its deterministic default backend.

Counterpart of the `SilhouetteExtrude` and `ReconstructionStage` parts of
`labelany3d_tpu/pipeline/stages/generative.py`: each object crop becomes a
mesh at `object_space/{id}.glb`. Enhancement, amodal completion and
elevation (stages 2, 4, 5) run no kernel at their shipping defaults
(bicubic, passthrough, 0 degrees); the layout stage copes without their
artifacts, and they wait for a later port.
"""

from __future__ import annotations

import os

import numpy as np

from labelany3d_tpu_torch.data.meshio import Mesh, save_glb
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.utils.png import read_png


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


class ReconstructionStage:
    """Stage 6: every crop of a scene -> `object_space/{id}.glb`; existing
    meshes are kept (resume). Reads the completed crop when stage 4 wrote
    one, else the plain crop."""

    def __init__(self, cfg: PipelineConfig, loader, save_dir: str, split: str, backend=None):
        self.cfg = cfg
        self.loader = loader
        self.save_dir = save_dir
        self.split = split
        self.backend = backend or SilhouetteExtrude()

    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for i in range(start_index, end_index):
            info = self.loader.get_image_by_index(i)
            scene = SceneDir(os.path.join(self.save_dir, self.split,
                                          scene_dir_name(info["file_name"]))).ensure()
            for obj_id in scene.list_crop_ids():
                out_path = scene.object_mesh(obj_id)
                if out_path.exists():
                    continue
                crop_path = scene.crop_completed(obj_id)
                if not crop_path.exists():
                    crop_path = scene.crop(obj_id)
                label = obj_id.split("_", 1)[-1].replace("_", " ")
                save_glb(out_path, self.backend.reconstruct(read_png(crop_path), label))
            done += 1
        return done
