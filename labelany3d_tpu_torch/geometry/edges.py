"""Point-map normals, depth and normal edges, and grid meshing.

Counterpart of `labelany3d_tpu/geometry/edges.py`, which builds the depth
stage's edge-filtered scene mesh (`depth_scene_no_edge.ply`). The normals
and edge masks are torch functions on the device of their inputs; only the
final mesh compaction (`image_mesh`) is host numpy, as in the JAX package.

Three details are kept from the JAX functions so that their masks agree:
  * neighbours come from `torch.roll`, as from `jnp.roll`, so border pixels
    take the opposite border's pixels as neighbours;
  * the 3x3 window reductions of `depth_edge` see outside pixels as the
    reduction's identity: `max_pool2d` pads with -inf, which gives the same
    maximum as JAX's -3.4e38 pad, and the minimum is -max(-x);
  * masked depths become +-3.4e38, not +-inf.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 3.4e38  # masked depths in the window reductions (finite, as in JAX)


def _shift(x: torch.Tensor, dy: int, dx: int, dims=(0, 1)) -> torch.Tensor:
    """x[i + dy, j + dx], wrapping around the borders."""
    return torch.roll(x, (-dy, -dx), dims=dims)


def points_to_normals(points: torch.Tensor, mask: torch.Tensor | None = None):
    """Per-pixel normals of an (H, W, 3) point map from neighbour cross
    products averaged over the four pixel quadrants. Returns (normals
    (H, W, 3), normals_mask (H, W))."""
    p = points.float()
    finite = torch.isfinite(p).all(-1)
    mask = finite if mask is None else (mask.bool() & finite)
    safe = torch.where(mask[..., None], p, torch.zeros_like(p))

    dxp = _shift(safe, 0, 1) - safe    # +x neighbour
    dyp = _shift(safe, 1, 0) - safe    # +y neighbour
    dxm = _shift(safe, 0, -1) - safe
    dym = _shift(safe, -1, 0) - safe
    mxp = _shift(mask, 0, 1) & mask
    myp = _shift(mask, 1, 0) & mask
    mxm = _shift(mask, 0, -1) & mask
    mym = _shift(mask, -1, 0) & mask

    quads = [(torch.linalg.cross(dyp, dxp), myp & mxp),
             (torch.linalg.cross(dxp, dym), mxp & mym),
             (torch.linalg.cross(dym, dxm), mym & mxm),
             (torch.linalg.cross(dxm, dyp), mxm & myp)]
    acc = torch.zeros_like(safe)
    cnt = torch.zeros(mask.shape, dtype=torch.float32, device=p.device)
    for n, m in quads:
        norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        unit = n / norm.clamp_min(1e-12)
        use = m & (norm[..., 0] > 1e-12)
        acc = acc + torch.where(use[..., None], unit, torch.zeros_like(unit))
        cnt = cnt + use.float()
    normals = acc / cnt[..., None].clamp_min(1.0)
    normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True).clamp_min(1e-12)
    return normals, (cnt > 0) & mask


def depth_edge(depth: torch.Tensor, rtol: float = 0.03,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Relative depth discontinuities: (3x3 max - 3x3 min) / |depth| > rtol
    over the masked pixels of an (H, W) depth map."""
    d = depth.float()
    finite = torch.isfinite(d)
    mask = finite if mask is None else (mask.bool() & finite)
    big = torch.tensor(_BIG, dtype=torch.float32, device=d.device)
    dmax = F.max_pool2d(torch.where(mask, d, -big)[None, None], 3, 1, 1)[0, 0]
    dmin = -F.max_pool2d(torch.where(mask, -d, -big)[None, None], 3, 1, 1)[0, 0]
    rel = (dmax - dmin) / d.abs().clamp_min(1e-12)
    return (rel > rtol) & mask


def normals_edge(normals: torch.Tensor, tol_deg: float = 5.0,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normal discontinuities: the largest angle to one of the 8 masked
    neighbours exceeds `tol_deg`."""
    n = normals.float()
    mask = (torch.ones(n.shape[:2], dtype=torch.bool, device=n.device) if mask is None
            else mask.bool())
    cos_tol = torch.cos(torch.deg2rad(torch.tensor(tol_deg, dtype=torch.float32)))
    min_cos = torch.ones(n.shape[:2], dtype=torch.float32, device=n.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            cos = (n * _shift(n, dy, dx)).sum(-1)
            min_cos = torch.where(_shift(mask, dy, dx) & mask, torch.minimum(min_cos, cos),
                                  min_cos)
    return (min_cos < cos_tol.to(n.device)) & mask


def image_mesh(points: np.ndarray, colors: np.ndarray | None, mask: np.ndarray):
    """Grid-triangulate a point map into (vertices, faces[, colors]): two
    triangles per pixel quad whose four corners are all in `mask`."""
    pts = np.asarray(points)
    m = np.asarray(mask, bool)
    h, w = m.shape
    idx = -np.ones((h, w), np.int64)
    ys, xs = np.nonzero(m)
    idx[ys, xs] = np.arange(len(ys))
    verts = pts[ys, xs].astype(np.float32)
    cols = None if colors is None else np.asarray(colors)[ys, xs]

    q = m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]
    qy, qx = np.nonzero(q)
    a, b = idx[qy, qx], idx[qy, qx + 1]
    c, d = idx[qy + 1, qx], idx[qy + 1, qx + 1]
    faces = np.concatenate([np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)],
                           axis=0).astype(np.int32)
    return (verts, faces) if cols is None else (verts, faces, cols)


def edge_filtered_scene_mesh(points: torch.Tensor, image: np.ndarray, depth: torch.Tensor,
                             mask: torch.Tensor, depth_rtol: float = 0.03,
                             normals_tol_deg: float = 5.0):
    """The depth stage's scene mesh: keep the masked pixels that are not
    both depth edges and normal edges, and triangulate the grid. `points`
    (H, W, 3), `depth` and `mask` (H, W) are tensors on one device; returns
    host (vertices, faces, colors)."""
    normals, nmask = points_to_normals(points, mask)
    keep = mask.bool() & ~(depth_edge(depth, depth_rtol, mask)
                           & normals_edge(normals, normals_tol_deg, nmask))
    return image_mesh(points.cpu().numpy(), np.asarray(image), keep.cpu().numpy())
