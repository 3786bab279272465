"""Tile-based triangle rasterizer (PyTorch3D MeshRasterizer equivalent).

Counterpart of `labelany3d_tpu/ops/rasterize.py`, in plain PyTorch:

  1. coarse: per-tile face lists from a (tiles x faces) bounding-box overlap
     test, the `faces_per_tile` lowest-indexed overlapping faces per tile;
  2. fine: per-pixel edge functions against the tile's face list,
     perspective-correct depth and barycentrics, nearest z wins (the first
     face of the list on ties).

The fine phase's intermediates are (tiles x 256 pixels x faces_per_tile);
over a 512^2 view that is 0.54 GB per intermediate in float32, so tiles
are processed in chunks of at most `_FINE_ELEMENTS` elements. Cameras are
OpenCV pinhole (x right, y down, z forward).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from labelany3d_tpu_torch.utils.precision import f32_precision

_FINE_ELEMENTS = 1 << 25   # tiles * pixels * faces per fine-phase chunk


class RasterOut(NamedTuple):
    depth: torch.Tensor     # (H, W) view-space z; -1 where no face
    face_id: torch.Tensor   # (H, W) int64; -1 background
    bary: torch.Tensor      # (H, W, 3) perspective-correct barycentrics


@f32_precision
def rasterize_mesh(verts_cam: torch.Tensor, faces: torch.Tensor, K: torch.Tensor,
                   image_size: tuple[int, int], tile: int = 16, faces_per_tile: int = 512,
                   eps_z: float = 1e-6) -> RasterOut:
    """Rasterize (V, 3) camera-space vertices and (F, 3) faces at
    `image_size` (multiples of `tile`)."""
    h, w = image_size
    dev = verts_cam.device
    verts_cam = verts_cam.float()
    faces = faces.long()
    K = K.float()

    z = verts_cam[:, 2]
    safe_z = torch.where(z.abs() > eps_z, z, torch.full_like(z, eps_z))
    u = K[0, 0] * verts_cam[:, 0] / safe_z + K[0, 2]
    v = K[1, 1] * verts_cam[:, 1] / safe_z + K[1, 2]
    tri_u, tri_v, tri_z = u[faces], v[faces], z[faces]   # (F, 3)
    front = (tri_z > eps_z).all(-1)

    big = torch.tensor(1e9, device=dev)
    bb_x0 = torch.where(front, tri_u.amin(-1), big)
    bb_x1 = torch.where(front, tri_u.amax(-1), -big)
    bb_y0 = torch.where(front, tri_v.amin(-1), big)
    bb_y1 = torch.where(front, tri_v.amax(-1), -big)

    ty, tx = h // tile, w // tile
    tiles_y0 = torch.arange(ty, dtype=torch.float32, device=dev) * tile
    tiles_x0 = torch.arange(tx, dtype=torch.float32, device=dev) * tile
    ov_y = (bb_y0[None] <= tiles_y0[:, None] + tile) & (bb_y1[None] >= tiles_y0[:, None])
    ov_x = (bb_x0[None] <= tiles_x0[:, None] + tile) & (bb_x1[None] >= tiles_x0[:, None])
    overlap = (ov_y[:, None, :] & ov_x[None, :, :]).reshape(ty * tx, -1)

    f = faces.shape[0]
    cap = min(faces_per_tile, f)
    # Deterministic tile lists: the cap lowest-indexed overlapping faces, in
    # increasing index order.
    order = -torch.arange(f, dtype=torch.float32, device=dev)
    score = torch.where(overlap, order[None], torch.tensor(float("-inf"), device=dev))
    top_score, top_idx = torch.topk(score, cap, dim=-1, sorted=True)
    tile_valid = torch.isfinite(top_score)
    tile_faces = torch.where(tile_valid, top_idx, torch.zeros_like(top_idx))

    au, av, az = tri_u[:, 0], tri_v[:, 0], tri_z[:, 0]
    bu, bv, bz = tri_u[:, 1], tri_v[:, 1], tri_z[:, 1]
    cu, cv, cz = tri_u[:, 2], tri_v[:, 2], tri_z[:, 2]
    area = (bu - au) * (cv - av) - (bv - av) * (cu - au)   # signed 2x area

    p = tile * tile
    offs = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    pyy = offs[:, None].expand(tile, tile).reshape(1, p, 1)
    pxx = offs[None, :].expand(tile, tile).reshape(1, p, 1)
    t_ids = torch.arange(ty * tx, device=dev)
    chunk = max(1, _FINE_ELEMENTS // (p * cap))
    zbufs, fids, barys = [], [], []
    for c0 in range(0, ty * tx, chunk):
        tid = t_ids[c0:c0 + chunk]
        f_idx = tile_faces[c0:c0 + chunk]                     # (T, cap)
        f_ok = tile_valid[c0:c0 + chunk]
        py = (tid // tx).float()[:, None, None] * tile + pyy  # (T, P, 1)
        px = (tid % tx).float()[:, None, None] * tile + pxx

        def g(a):
            return a[f_idx][:, None, :]                        # (T, 1, cap)

        fa_u, fa_v, fa_z = g(au), g(av), g(az)
        fb_u, fb_v, fb_z = g(bu), g(bv), g(bz)
        fc_u, fc_v, fc_z = g(cu), g(cv), g(cz)
        f_area = g(area)
        w0 = (fb_u - px) * (fc_v - py) - (fb_v - py) * (fc_u - px)
        w1 = (fc_u - px) * (fa_v - py) - (fc_v - py) * (fa_u - px)
        w2 = (fa_u - px) * (fb_v - py) - (fa_v - py) * (fb_u - px)
        ok_area = f_area.abs() > 1e-12
        denom = torch.where(ok_area, f_area, torch.full_like(f_area, 1e-12))
        b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & f_ok[:, None, :] & ok_area
        inv_z = b0 / fa_z + b1 / fb_z + b2 / fc_z
        depth = torch.where(inside, 1.0 / inv_z.clamp_min(1e-12),
                            torch.tensor(float("inf"), device=dev))

        best = depth.argmin(-1, keepdim=True)                 # (T, P, 1)
        zsel = depth.gather(-1, best)[..., 0]
        hit = torch.isfinite(zsel)
        zbuf = torch.where(hit, zsel, torch.full_like(zsel, -1.0))

        def sel(a):
            return a.expand_as(depth).gather(-1, best)[..., 0]

        fid = torch.where(hit, f_idx.gather(-1, best[..., 0]), torch.full_like(best[..., 0], -1))
        bary = torch.stack([sel(b0) / sel(fa_z) * zbuf, sel(b1) / sel(fb_z) * zbuf,
                            sel(b2) / sel(fc_z) * zbuf], dim=-1)
        bary = torch.where(hit[..., None], bary, torch.zeros_like(bary))
        zbufs.append(zbuf)
        fids.append(fid)
        barys.append(bary)

    def untile(x):
        x = x.reshape(ty, tx, tile, tile, *x.shape[2:]).transpose(1, 2)
        return x.reshape(h, w, *x.shape[4:])

    return RasterOut(depth=untile(torch.cat(zbufs)), face_id=untile(torch.cat(fids)),
                     bary=untile(torch.cat(barys)))


def shade_vertex_colors(raster: RasterOut, faces: torch.Tensor,
                        vertex_colors: torch.Tensor | None) -> torch.Tensor:
    """Interpolate per-vertex colours -> (H, W, 4) RGBA in [0, 1]; ambient
    only (plain albedo), white when the mesh has no colours."""
    hit = raster.face_id >= 0
    tri = faces.long()[raster.face_id.clamp_min(0)]          # (H, W, 3)
    if vertex_colors is None:
        rgb = torch.ones(*raster.depth.shape, 3, device=raster.depth.device)
    else:
        cols = vertex_colors.float()
        if not vertex_colors.is_floating_point():
            cols = cols / 255.0  # uint8 colours; float colours are in [0, 1]
        c = cols[..., :3][tri]                                 # (H, W, 3, 3)
        rgb = torch.einsum("hwk,hwkc->hwc", raster.bary, c)
    alpha = hit.float()[..., None]
    return torch.cat([rgb * alpha, alpha], dim=-1)
