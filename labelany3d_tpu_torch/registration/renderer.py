"""Multi-view mesh renderer for the registration loop.

Counterpart of `labelany3d_tpu/registration/renderer.py`: orbit views at
distance 1.5 with fixed intrinsics, albedo shading, per-view (rgba, depth,
R, t), through the port's tiled rasterizer (`ops.rasterize`) on the
renderer's device. Views come back to the host as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh
from labelany3d_tpu_torch.ops.rasterize import rasterize_mesh, shade_vertex_colors
from labelany3d_tpu_torch.registration.cameras import (
    RENDER_DISTANCE,
    RENDER_K,
    RENDER_SIZE,
    opencv_orbit_pose,
)
from labelany3d_tpu_torch.utils.device import resolve_device


class RenderedView(NamedTuple):
    rgba: np.ndarray    # (H, W, 4) float in [0, 1]
    depth: np.ndarray   # (H, W), -1 background
    R: np.ndarray       # (3, 3) world->camera
    t: np.ndarray       # (3,)


class OrbitRenderer:
    """Renders a mesh from orbit viewpoints (and arbitrary poses)."""

    def __init__(self, image_size: int = RENDER_SIZE, K: np.ndarray | None = None,
                 faces_per_tile: int = 512, device: str | torch.device | None = None):
        self.image_size = image_size
        self.K = RENDER_K if K is None else np.asarray(K, np.float32)
        self.faces_per_tile = faces_per_tile
        self.device = resolve_device(device)

    @staticmethod
    def _bucket_faces(faces: np.ndarray, bucket: int = 2048) -> np.ndarray:
        """Pad the face list to a multiple of `bucket` with degenerate
        (zero-area) faces, as the JAX package does, so tile lists match."""
        f = np.asarray(faces, np.int32)
        target = max(bucket, -(-len(f) // bucket) * bucket)
        if target == len(f):
            return f
        return np.concatenate([f, np.zeros((target - len(f), 3), np.int32)])

    @torch.inference_mode()
    def _render(self, mesh: Mesh, Rs: np.ndarray, ts: np.ndarray, size: tuple[int, int],
                K: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(V, 3, 3) rotations and (V, 3) translations -> (V, H, W, 4) rgba and
        (V, H, W) depth as numpy."""
        dev = self.device
        verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=dev)
        faces = torch.as_tensor(self._bucket_faces(mesh.faces), device=dev)
        colors = None if mesh.colors is None else torch.as_tensor(np.asarray(mesh.colors),
                                                                 device=dev)
        Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        rgbas, depths = [], []
        for R, t in zip(Rs, ts):
            R = torch.as_tensor(np.asarray(R, np.float32), device=dev)
            t = torch.as_tensor(np.asarray(t, np.float32), device=dev)
            out = rasterize_mesh(verts @ R.T + t, faces, Kt, size,
                                 faces_per_tile=self.faces_per_tile)
            rgbas.append(shade_vertex_colors(out, faces, colors))
            depths.append(out.depth)
        return torch.stack(rgbas).cpu().numpy(), torch.stack(depths).cpu().numpy()

    def render_pose(self, mesh: Mesh, R: np.ndarray, t: np.ndarray,
                    image_size: tuple[int, int] | None = None,
                    K: np.ndarray | None = None) -> RenderedView:
        size = image_size or (self.image_size, self.image_size)
        # Render on a grid padded to a multiple of 64 and crop, as the JAX
        # package does (pixels are independent rays).
        ph, pw = -(-size[0] // 64) * 64, -(-size[1] // 64) * 64
        rgba, depth = self._render(mesh, np.asarray(R)[None], np.asarray(t)[None], (ph, pw),
                                   self.K if K is None else K)
        return RenderedView(rgba[0, :size[0], :size[1]], depth[0, :size[0], :size[1]],
                            np.asarray(R), np.asarray(t))

    def render_orbit_views(self, mesh: Mesh, elevations, azimuths,
                           radius: float = RENDER_DISTANCE) -> list[RenderedView]:
        poses = [opencv_orbit_pose(float(e), float(a), radius)
                 for e, a in zip(elevations, azimuths)]
        Rs = np.stack([p[0] for p in poses]).astype(np.float32)
        ts = np.stack([p[1] for p in poses]).astype(np.float32)
        rgba, depth = self._render(mesh, Rs, ts, (self.image_size, self.image_size), self.K)
        return [RenderedView(rgba[i], depth[i], Rs[i], ts[i]) for i in range(len(poses))]
