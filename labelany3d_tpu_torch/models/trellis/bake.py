"""Render-based texture and vertex-colour baking from 3D Gaussians.

Counterpart of `labelany3d_tpu/models/trellis/bake.py` (TRELLIS `to_glb`'s
texture bake): the mesh's appearance comes from multi-view splat renders
(`ops/splat.py`) projected back onto the surface.

  * `bake_texture`: box-projection UV atlas (`uv_unwrap_box`, xatlas's
    role), UV-space rasterization (`ops/rasterize.py`) for per-texel 3D
    positions, visibility-weighted colour accumulation over orbit views,
    seam dilation; the textured mesh for a GLB (TEXCOORD_0 + baseColor).
  * `bake_vertex_colors`: per-vertex projection, no UVs.

Both run on the Gaussians' device.
"""

from __future__ import annotations

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh
from labelany3d_tpu_torch.models.trellis.decoders import GaussianSet
from labelany3d_tpu_torch.ops.splat import rasterize_gaussians
from labelany3d_tpu_torch.registration.cameras import opencv_orbit_pose


def _visible_gaussians(gaussians: GaussianSet):
    """The valid Gaussians with opacity above 0.01, as a tuple of tensors
    (means, scales, rotations, opacities, colors), or None."""
    ok = gaussians.valid & (gaussians.opacities > 0.01)
    if not bool(ok.any()):
        return None
    return tuple(t[ok] for t in (gaussians.means, gaussians.scales, gaussians.rotations,
                                 gaussians.opacities, gaussians.colors))


def _orbit_colors(pts: torch.Tensor, gs: tuple, center: np.ndarray, num_views: int,
                  image_size: int, radius: float, depth_tolerance: float):
    """Accumulate each point's rendered colour over `num_views` orbit views
    where its depth agrees with the splat depth, weighted by alpha. Returns
    (colour sums (P, 3), weight sums (P,))."""
    dev = pts.device
    s = float(image_size)
    K = torch.tensor([[s * 1.2, 0, s / 2], [0, s * 1.2, s / 2], [0, 0, 1]], device=dev)
    acc_c = torch.zeros(pts.shape[0], 3, device=dev)
    acc_w = torch.zeros(pts.shape[0], device=dev)
    for i in range(num_views):
        R, t = opencv_orbit_pose((-20.0, 0.0, 20.0)[i % 3], 360.0 * i / num_views, radius,
                                 target=center)
        R, t = torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev)
        out = rasterize_gaussians(*gs, R, t, K, (image_size, image_size), gaussians_per_tile=128)
        alpha = out.alpha.clamp_min(1e-6)
        rgb, depth = out.rgb / alpha[..., None], out.depth / alpha
        cam = pts @ R.T + t
        z = cam[:, 2]
        u = K[0, 0] * cam[:, 0] / z.clamp_min(1e-6) + K[0, 2]
        v = K[1, 1] * cam[:, 1] / z.clamp_min(1e-6) + K[1, 2]
        ui = torch.round(u).long().clamp(0, image_size - 1)
        vi = torch.round(v).long().clamp(0, image_size - 1)
        seen_a = out.alpha[vi, ui]
        inside = (u >= 0) & (u < image_size) & (v >= 0) & (v < image_size) & (z > 0)
        visible = inside & ((depth[vi, ui] - z).abs() < depth_tolerance) & (seen_a > 0.3)
        wgt = visible.float() * seen_a
        acc_c = acc_c + rgb[vi, ui] * wgt[:, None]
        acc_w = acc_w + wgt
    return acc_c, acc_w


@torch.no_grad()
def bake_vertex_colors(mesh: Mesh, gaussians: GaussianSet, num_views: int = 16,
                       image_size: int = 256, radius: float = 2.0,
                       depth_tolerance: float = 0.08) -> np.ndarray:
    """(V, 3) vertex colours from orbit splat renders; unseen vertices take
    the mean seen colour, 0.5 grey without any."""
    gs = _visible_gaussians(gaussians)
    nv = len(mesh.vertices)
    if gs is None or nv == 0:
        return np.full((nv, 3), 0.5, np.float32)
    verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=gs[0].device)
    acc_c, acc_w = _orbit_colors(verts, gs, verts.mean(0).cpu().numpy(), num_views,
                                 image_size, radius, depth_tolerance)
    acc_c, acc_w = acc_c.cpu().numpy(), acc_w.cpu().numpy()
    seen = acc_w > 1e-4
    colors = np.full((nv, 3), 0.5, np.float32)
    colors[seen] = acc_c[seen] / acc_w[seen, None]
    if seen.any() and (~seen).any():
        colors[~seen] = colors[seen].mean(axis=0)
    return np.clip(colors, 0.0, 1.0)


def uv_unwrap_box(mesh: Mesh) -> Mesh:
    """Box-projection UV atlas: each face joins one of six charts by its
    dominant normal axis and sign, projects orthographically onto the other
    two axes, and the charts pack into a 3x2 grid with margins. Vertices are
    split per face corner (V = 3F), with per-vertex `uv` in [0, 1]."""
    v = np.asarray(mesh.vertices, np.float32)
    f = np.asarray(mesh.faces, np.int64)
    if len(f) == 0:
        return Mesh(v.copy(), mesh.faces.copy(), uv=np.zeros((len(v), 2), np.float32))
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    axis = np.abs(n).argmax(axis=1)
    sign = (np.take_along_axis(n, axis[:, None], 1)[:, 0] >= 0).astype(np.int64)
    chart = axis * 2 + sign
    plane = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    new_v = tri.reshape(-1, 3)
    new_f = np.arange(len(new_v), dtype=np.int32).reshape(-1, 3)
    uv = np.zeros((len(new_v), 2), np.float32)
    cols, rows, margin = 3, 2, 0.01
    cell_w, cell_h = 1.0 / cols, 1.0 / rows
    for c in range(6):
        sel = chart == c
        if not sel.any():
            continue
        a, b = plane[c // 2]
        pts = tri[sel][:, :, (a, b)].reshape(-1, 2)
        lo = pts.min(axis=0)
        span = np.maximum(pts.max(axis=0) - lo, 1e-9)
        local = (pts - lo) / span.max()
        origin = np.array([(c % cols) * cell_w + margin, (c // cols) * cell_h + margin])
        scale = np.array([cell_w - 2 * margin, cell_h - 2 * margin])
        uv[np.repeat(sel, 3)] = origin + local * scale.min()
    colors = None
    if mesh.colors is not None:
        colors = np.asarray(mesh.colors)[f].reshape(-1, mesh.colors.shape[-1])
    return Mesh(new_v.astype(np.float32), new_f, colors=colors, uv=uv)


def _texel_positions(mesh: Mesh, texture_size: int, device):
    """Rasterize the mesh in UV space: per-texel 3D position (T, T, 3) and
    valid (T, T)."""
    from labelany3d_tpu_torch.ops.rasterize import rasterize_mesh

    uv = torch.as_tensor(mesh.uv, dtype=torch.float32, device=device)
    verts_cam = torch.stack([uv[:, 0] * texture_size, uv[:, 1] * texture_size,
                             torch.ones_like(uv[:, 0])], -1)
    faces = torch.as_tensor(np.asarray(mesh.faces), device=device).long()
    out = rasterize_mesh(verts_cam, faces, torch.eye(3, device=device),
                         (texture_size, texture_size))
    tri = torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=device)[
        faces[out.face_id.clamp_min(0)]]
    return torch.einsum("hwk,hwkc->hwc", out.bary, tri), out.face_id >= 0


@torch.no_grad()
def bake_texture(mesh: Mesh, gaussians: GaussianSet, texture_size: int = 512,
                 num_views: int = 16, image_size: int = 256, radius: float = 2.0,
                 depth_tolerance: float = 0.08) -> Mesh:
    """UV-unwrap `mesh` and bake a (T, T, 3) uint8 atlas from orbit splat
    renders; vertex colours are sampled from the atlas. Returns the
    unwrapped mesh (split vertices) with `uv` and `texture`."""
    mesh = uv_unwrap_box(mesh)
    if mesh.is_empty:
        mesh.texture = np.full((texture_size, texture_size, 3), 127, np.uint8)
        return mesh
    gs = _visible_gaussians(gaussians)
    if gs is None:
        mesh.texture = np.full((texture_size, texture_size, 3), 127, np.uint8)
        mesh.colors = np.full((len(mesh.vertices), 3), 0.5, np.float32)
        return mesh
    dev = gs[0].device
    pos, tvalid = _texel_positions(mesh, texture_size, dev)
    center = np.asarray(mesh.vertices, np.float32).mean(axis=0)
    acc_c, acc_w = _orbit_colors(pos.reshape(-1, 3), gs, center, num_views, image_size,
                                 radius, depth_tolerance)
    acc_c = acc_c.cpu().numpy().reshape(texture_size, texture_size, 3)
    acc_w = acc_w.cpu().numpy().reshape(texture_size, texture_size)
    tvalid = tvalid.cpu().numpy()
    seen = (acc_w > 1e-4) & tvalid
    tex = np.full((texture_size, texture_size, 3), 0.5, np.float32)
    if seen.any():
        tex[seen] = acc_c[seen] / acc_w[seen, None]
        # Occluded texels inside the charts take the mean seen colour; then
        # seam dilation pads the charts against bilinear bleed.
        holes = tvalid & ~seen
        if holes.any():
            tex[holes] = tex[seen].mean(axis=0)
    tex = _dilate_texture(tex, tvalid, iterations=4)
    mesh.texture = (np.clip(tex, 0.0, 1.0) * 255).astype(np.uint8)
    uvs = np.asarray(mesh.uv)
    ui = np.clip(uvs[:, 0] * (texture_size - 1), 0, texture_size - 1).astype(np.int64)
    vi = np.clip(uvs[:, 1] * (texture_size - 1), 0, texture_size - 1).astype(np.int64)
    mesh.colors = mesh.texture[vi, ui].astype(np.float32) / 255.0
    return mesh


def _dilate_texture(tex: np.ndarray, valid: np.ndarray, iterations: int) -> np.ndarray:
    """Grow chart colours into invalid texels (seam padding)."""
    tex, valid = tex.copy(), valid.copy()
    for _ in range(iterations):
        if valid.all():
            break
        grown = np.zeros_like(tex)
        count = np.zeros(valid.shape, np.float32)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted_v = np.roll(valid, (dy, dx), axis=(0, 1))
            grown += np.roll(tex, (dy, dx), axis=(0, 1)) * shifted_v[..., None]
            count += shifted_v
        newly = (~valid) & (count > 0)
        tex[newly] = grown[newly] / count[newly, None]
        valid = valid | newly
    return tex
