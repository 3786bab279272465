"""Multi-view space-carving reconstruction (stage 6's `hunyuan3d_carve`).

Counterpart of `labelany3d_tpu/models/spacecarve.py`: the same views -> mesh
contract as the Hunyuan3D path with a deterministic geometric core, the
visual hull. Each view's alpha silhouette carves the voxel grid under its
known orbit camera (the G^3 voxels x V views projection test is one batched
product and bilinear sample, `ops/sampling.py::grid_sample`); the occupancy
is meshed with marching tetrahedra and coloured by projecting the vertices
into the front view. With generated novel views (Zero123) this is an
image -> 3D path; with the input crop alone it is a one-silhouette extrusion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh
from labelany3d_tpu_torch.ops.marching_cubes import marching_cubes_mesh
from labelany3d_tpu_torch.ops.sampling import grid_sample
from labelany3d_tpu_torch.registration.cameras import opencv_orbit_pose
from labelany3d_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class SpaceCarveConfig:
    grid_size: int = 64
    radius: float = 1.5            # orbit camera distance (render parity)
    extent: float = 0.6            # voxel cube half-extent in object units
    views_azimuths: tuple = (0.0, 60.0, 120.0, 180.0, 240.0, 300.0)
    elevation: float = 0.0
    focal: float = 560.44 / 512.0  # normalized render focal (cameras.py)
    min_coverage: float = 1.0      # visual hull = intersection; lower for noisy views


def carve_occupancy(alphas: torch.Tensor, Rs: torch.Tensor, ts: torch.Tensor, K: torch.Tensor,
                    cfg: SpaceCarveConfig) -> torch.Tensor:
    """Visual hull: (V, H, W) silhouettes + cameras -> (G, G, G) bool
    occupancy, on the silhouettes' device. A voxel survives if it projects
    inside the silhouette (bilinear alpha > 0.5) in at least `min_coverage`
    of the views it is in front of."""
    g = cfg.grid_size
    dev = alphas.device
    lin = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g * 2.0 - 1.0
    pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3) * cfg.extent
    h, w = alphas.shape[-2:]
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    with full_f32():
        cam = torch.einsum("nc,vdc->vnd", pts, torch.as_tensor(Rs, dtype=torch.float32,
                                                                device=dev))
    cam = cam + torch.as_tensor(ts, dtype=torch.float32, device=dev)[:, None]
    z = cam[..., 2]
    u = K[0, 0] * cam[..., 0] / z.clamp_min(1e-6) + K[0, 2]
    v = K[1, 1] * cam[..., 1] / z.clamp_min(1e-6) + K[1, 2]
    grid = torch.stack([u / w * 2 - 1, v / h * 2 - 1], dim=-1)     # (V, N, 2)
    a = torch.stack([grid_sample(alphas[i, ..., None].float(), grid[i])[:, 0]
                     for i in range(alphas.shape[0])])
    in_front = z > 1e-3
    votes = ((a > 0.5) & in_front).sum(0)
    counted = in_front.sum(0).clamp_min(1)
    need = torch.ceil(cfg.min_coverage * counted).int().clamp_min(1)
    return (votes >= need).reshape(g, g, g)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) -> (size, size, C) as Pillow's `Image.resize(..., NEAREST)`:
    the source of output pixel x is the integer part of (0.5 + x) * in / out,
    summed in double one step at a time as Pillow sums it."""
    def src(n_in):
        scale = n_in / size
        steps = np.full(size, scale)
        steps[0] = 0.5 * scale
        return np.clip(np.cumsum(steps).astype(np.int64), 0, n_in - 1)

    return img[src(img.shape[0])][:, src(img.shape[1])]


class SpaceCarveReconstruction:
    """Stage-6 backend: crop -> novel views -> visual hull -> coloured mesh.

    `novel_views` is optional (a Zero123NovelView-like `generate`); without
    it only the input silhouette carves. Carving runs on `device`."""

    def __init__(self, cfg: SpaceCarveConfig | None = None, novel_views=None, device=None):
        from labelany3d_tpu_torch.utils.device import resolve_device

        self.cfg = cfg or SpaceCarveConfig()
        self.novel_views = novel_views
        self.device = resolve_device(device)

    def views(self, crop_rgba: np.ndarray):
        """(V, H, W) bool silhouettes, V uint8 RGB views, (V, 3, 3) R and
        (V, 3) t. Every view at the view source's size (the crop resized
        nearest); generated views' alpha from their non-white pixels."""
        cfg = self.cfg
        alphas, rgbs, Rs, ts = [], [], [], []
        base = np.asarray(crop_rgba)
        target = getattr(self.novel_views, "image_size", None) or base.shape[0]
        if base.shape[0] != target or base.shape[1] != target:
            b8 = base if base.dtype == np.uint8 else (np.clip(base, 0, 1) * 255).astype(np.uint8)
            base = resize_nearest(b8, target)
        for azim in cfg.views_azimuths:
            if azim == 0.0 or self.novel_views is None:
                img = base
            else:
                rgb = self.novel_views.generate(base, d_elev=0.0, d_azim=float(azim))
                a = (rgb.astype(np.int32).sum(-1) < 3 * 250).astype(np.uint8) * 255
                img = np.concatenate([rgb, a[..., None]], axis=-1)
            if img.shape[-1] == 4:
                alpha = img[..., 3] > 127 if img.dtype == np.uint8 else img[..., 3] > 0.5
            else:
                alpha = np.ones(img.shape[:2], bool)
            R, t = opencv_orbit_pose(cfg.elevation, float(azim), cfg.radius)
            alphas.append(alpha)
            rgbs.append(img[..., :3])
            Rs.append(R)
            ts.append(t)
            if self.novel_views is None:
                break
        return np.stack(alphas), rgbs, np.stack(Rs), np.stack(ts)

    def reconstruct(self, crop_rgba: np.ndarray, label: str = "") -> Mesh:
        cfg = self.cfg
        alphas, rgbs, Rs, ts = self.views(crop_rgba)
        h, w = alphas.shape[-2:]
        K = np.array([[cfg.focal * w, 0, w / 2], [0, cfg.focal * h, h / 2], [0, 0, 1]],
                     np.float32)
        occ = carve_occupancy(torch.from_numpy(alphas).to(self.device), Rs, ts, K, cfg)
        field = 1.0 - 2.0 * occ.float()  # -1 inside
        verts, faces = marching_cubes_mesh(field, iso=0.0)
        if len(verts) == 0:
            return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
        verts_obj = ((verts + 0.5) / cfg.grid_size * 2.0 - 1.0) * cfg.extent
        cam = verts_obj @ Rs[0].T + ts[0]
        u = np.clip(K[0, 0] * cam[:, 0] / np.maximum(cam[:, 2], 1e-6) + K[0, 2], 0, w - 1)
        v = np.clip(K[1, 1] * cam[:, 1] / np.maximum(cam[:, 2], 1e-6) + K[1, 2], 0, h - 1)
        rgb0 = np.asarray(rgbs[0], np.float32)
        if rgb0.max() > 1.5:
            rgb0 = rgb0 / 255.0
        colors = rgb0[v.astype(int), u.astype(int)]
        return Mesh(vertices=verts_obj.astype(np.float32), faces=faces,
                    colors=colors.astype(np.float32))
