"""Iso-surface extraction on dense scalar fields (marching tetrahedra).

Counterpart of `labelany3d_tpu/ops/marching_cubes.py`: each grid cell splits
into 6 tetrahedra around its 0-6 diagonal; each tet emits up to 2 triangles
into fixed slots through a 16-case table, so extraction is one batched
gather program. The tables also serve
`models/trellis/decoders.py::flexicubes_to_mesh`. `marching_cubes_mesh`
compacts the slots into an indexed mesh (the SVRM and space-carving
backends).
"""

from __future__ import annotations

import numpy as np
import torch

# Cube corner offsets.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)
# 6-tet decomposition of the cube around the 0-6 diagonal.
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32)
# Tet edges: (local corner a, local corner b).
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)

# Per-case triangle table: case bit i set <=> tet vertex i is inside (field
# < iso). Each row lists up to 2 triangles as tet-edge indices, -1-padded.
_TET_TRI_TABLE = np.full((16, 6), -1, np.int32)
_TET_TRI_TABLE[1, :3] = [0, 1, 2]          # v0
_TET_TRI_TABLE[2, :3] = [0, 3, 4]          # v1
_TET_TRI_TABLE[4, :3] = [1, 3, 5]          # v2
_TET_TRI_TABLE[8, :3] = [2, 4, 5]          # v3
_TET_TRI_TABLE[3] = [1, 3, 4, 1, 4, 2]     # v0 v1
_TET_TRI_TABLE[5] = [0, 3, 5, 0, 5, 2]     # v0 v2
_TET_TRI_TABLE[9] = [0, 4, 5, 0, 5, 1]     # v0 v3
_TET_TRI_TABLE[6] = [0, 1, 5, 0, 5, 4]     # v1 v2
_TET_TRI_TABLE[10] = [0, 2, 5, 0, 5, 3]    # v1 v3
_TET_TRI_TABLE[12] = [1, 2, 4, 1, 4, 3]    # v2 v3
_TET_TRI_TABLE[7, :3] = [2, 4, 5]          # v0 v1 v2 (v3 out)
_TET_TRI_TABLE[11, :3] = [1, 3, 5]         # v0 v1 v3 (v2 out)
_TET_TRI_TABLE[13, :3] = [0, 3, 4]         # v0 v2 v3 (v1 out)
_TET_TRI_TABLE[14, :3] = [0, 1, 2]         # v1 v2 v3 (v0 out)

MAX_TRIS_PER_CELL = 12  # 6 tets x 2 triangles


def marching_cubes(field: torch.Tensor, iso: float = 0.0):
    """Iso-surface of an (Nx, Ny, Nz) scalar field.

    Returns tris (C, 12, 3, 3) float32 triangle vertices in grid coordinates
    and valid (C, 12) slot flags, C = (Nx-1)(Ny-1)(Nz-1) cells in row-major
    order."""
    f = field.float()
    dev = f.device
    nx, ny, nz = f.shape
    g = [torch.arange(m - 1, device=dev) for m in (nx, ny, nz)]
    cells = torch.stack(torch.meshgrid(*g, indexing="ij"), -1).reshape(-1, 3)
    corners = torch.as_tensor(_CORNERS, device=dev).long()
    tets = torch.as_tensor(_TETS, device=dev).long()
    edges = torch.as_tensor(_TET_EDGES, device=dev).long()
    table = torch.as_tensor(_TET_TRI_TABLE, device=dev).long()
    idx = cells[:, None, :] + corners[None]                   # (C, 8, 3)
    vals = f[idx[..., 0], idx[..., 1], idx[..., 2]]           # (C, 8)
    tv, tp = vals[:, tets], idx.float()[:, tets]              # (C, 6, 4), (C, 6, 4, 3)
    case = ((tv < iso).long() * (2 ** torch.arange(4, device=dev))).sum(-1)
    va, vb = tv[..., edges[:, 0]], tv[..., edges[:, 1]]       # (C, 6, 6)
    denom = torch.where((vb - va).abs() > 1e-12, vb - va, torch.full_like(va, 1e-12))
    t = ((iso - va) / denom).clamp(0.0, 1.0)
    pa, pb = tp[..., edges[:, 0], :], tp[..., edges[:, 1], :]
    everts = pa + t[..., None] * (pb - pa)                    # (C, 6, 6, 3)
    row = table[case].reshape(*case.shape, 2, 3)              # (C, 6, 2, 3)
    tvalid = row[..., 0] >= 0
    tris = torch.gather(everts[:, :, None].expand(-1, -1, 2, -1, -1), 3,
                        row.clamp_min(0)[..., None].expand(-1, -1, -1, -1, 3))
    tris = torch.where(tvalid[..., None, None], tris, torch.zeros_like(tris))
    return tris.reshape(-1, MAX_TRIS_PER_CELL, 3, 3), tvalid.reshape(-1, MAX_TRIS_PER_CELL)


def marching_cubes_mesh(field, iso: float = 0.0):
    """Compacted (vertices (V, 3) float32, faces (F, 3) int32) numpy mesh of
    a scalar field (a tensor on any device, or an array), as the JAX
    package's: vertices deduplicated on keys rounded at 1e-5 grid units,
    each the mean of its merged positions (in float64), faces that lost a
    corner to the merge dropped. Vertex order is the keys' lexicographic
    order, as `np.unique(axis=0)` gives."""
    tris, valid = marching_cubes(torch.as_tensor(field), iso)
    flat = tris[valid].reshape(-1, 3)
    if flat.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    keys = torch.round(flat * 1e5).long()
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    verts = torch.zeros((len(uniq), 3), dtype=torch.float64, device=flat.device)
    verts.index_add_(0, inverse, flat.double())
    verts /= torch.bincount(inverse, minlength=len(uniq))[:, None]
    faces = inverse.reshape(-1, 3)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return (verts.float().cpu().numpy(), faces[good].int().cpu().numpy())
