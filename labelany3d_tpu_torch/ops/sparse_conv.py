"""Submanifold sparse 3D convolution and pooling over fixed voxel slots.

Counterpart of `labelany3d_tpu/ops/sparse_conv.py` (spconv's role in
TRELLIS): active voxels ride (N,) slots with a valid mask; neighbour lookup
goes through a dense int32 index volume, and each kernel offset is a gather
plus an (N, Cin) x (Cin, Cout) matmul. The JAX package runs these outside
any Pallas kernel, so they are plain PyTorch here (`index_select`,
`torch.matmul`, `index_add_`), with TF32 off as `@f32_precision` asks.

Outputs live on the input's voxel set (submanifold); neighbours outside the
active set contribute zero. One instance per call: the flow and decoder
modules loop over their batch.
"""

from __future__ import annotations

import torch

from labelany3d_tpu_torch.utils.precision import f32_precision


def build_index_grid(coords: torch.Tensor, valid: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(N, 3) active voxel coords -> (G, G, G) int32 index map (-1 = empty)."""
    n = coords.shape[0]
    g = grid_size
    # One spare x-plane takes the invalid rows' writes (JAX drops them).
    grid = torch.full((g + 1, g, g), -1, dtype=torch.int32, device=coords.device)
    safe = coords.long().clamp(0, g - 1)
    cx = torch.where(valid, safe[:, 0], torch.full_like(safe[:, 0], g))
    grid[cx, safe[:, 1], safe[:, 2]] = torch.arange(n, dtype=torch.int32, device=coords.device)
    return grid[:g]


@f32_precision
def subm_sparse_conv3d(features: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                       weights: torch.Tensor, bias: torch.Tensor | None = None,
                       grid_size: int = 64) -> torch.Tensor:
    """Submanifold sparse conv: (N, Cin) x (K, K, K, Cin, Cout) -> (N, Cout)
    float32. Products run in the features' dtype and sum in float32.

    When the conv shrinks channels (Cout < Cin) the matmul runs first and
    the (N, Cout) products are gathered, as in the JAX package: fewer bytes
    gathered for the same operations."""
    n, cin = features.shape
    k = weights.shape[0]
    dev = features.device
    w = weights.to(features.dtype).reshape(k ** 3, cin, -1)  # (dx, dy, dz) row-major
    grid = build_index_grid(coords, valid, grid_size)
    r = torch.arange(k, device=dev) - k // 2
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 1, 3)
    nb = coords.long()[None] + offs                                  # (K^3, N, 3)
    inside = ((nb >= 0) & (nb < grid_size)).all(-1) & valid
    nbc = nb.clamp(0, grid_size - 1)
    idx = grid[nbc[..., 0], nbc[..., 1], nbc[..., 2]].long()
    idx = torch.where(inside & (idx >= 0), idx, torch.full_like(idx, n))  # n -> zero row
    matmul_first = w.shape[-1] < cin
    feats0 = torch.cat([features, features.new_zeros(1, cin)])
    out = torch.zeros(n, w.shape[-1], dtype=torch.float32, device=dev)
    for o in range(k ** 3):
        if matmul_first:
            out += (feats0 @ w[o]).index_select(0, idx[o]).float()
        else:
            out += (feats0.index_select(0, idx[o]) @ w[o]).float()
    if bias is not None:
        out = out + bias.float()
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def sparse_downsample(features: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                      factor: int = 2, reduce: str = "mean"):
    """Pool active voxels to a coarser grid on the same slot budget: the
    first voxel of each coarse cell (by slot order) carries the cell's
    reduced feature; the others are invalidated. Returns (pooled (N, C),
    coarse coords (N, 3), valid (N,))."""
    if reduce not in ("mean", "sum"):
        raise ValueError(reduce)
    n, c = features.shape
    dev = features.device
    coarse = torch.div(coords, factor, rounding_mode="floor")
    key = coarse[:, 0].long() * 100000 + coarse[:, 1].long() * 300 + coarse[:, 2].long()
    key = torch.where(valid, key, torch.full_like(key, 2 ** 30))
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.searchsorted(sk, sk, side="left")
    is_first = first == torch.arange(n, device=dev)
    sums = torch.zeros(n, c, dtype=features.dtype, device=dev).index_add_(0, first, features[order])
    counts = torch.zeros(n, device=dev).index_add_(0, first, torch.ones(n, device=dev))
    pooled = sums / counts.clamp_min(1.0)[:, None] if reduce == "mean" else sums
    inv = torch.argsort(order)
    return pooled[inv], coarse, is_first[inv] & valid


def sparse_pool_pair(features: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                     factor: int, grid_size: int):
    """Mean-pool voxels into parent cells, keeping the child -> parent map
    (TRELLIS `SparseDownsample` paired with `SparseUpsample`). Parents are in
    ascending linear cell-code order at the front of the slots; slots past
    the occupied cells are invalid.

    Returns (parent feats (N, C), parent coords (N, 3), parent valid (N,),
    child2parent (N,) int64)."""
    n, c = features.shape
    dev = features.device
    g = grid_size // factor
    pc = torch.div(coords, factor, rounding_mode="floor").long()
    code = (pc[:, 0] * g + pc[:, 1]) * g + pc[:, 2]
    code = torch.where(valid, code, torch.full_like(code, g * g * g))  # invalid -> sentinel
    order = torch.argsort(code, stable=True)
    sc = code[order]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sc[1:] != sc[:-1]])
    child2parent = torch.empty(n, dtype=torch.long, device=dev)
    child2parent[order] = torch.cumsum(is_first.long(), 0) - 1
    vf = torch.where(valid[:, None], features, torch.zeros_like(features))
    psum = torch.zeros(n, c, dtype=features.dtype, device=dev).index_add_(0, child2parent, vf)
    pcnt = torch.zeros(n, device=dev).index_add_(0, child2parent, valid.float())
    parent_feats = psum / pcnt.clamp_min(1.0)[:, None]
    parent_valid = pcnt > 0
    # Every child of a parent writes the same cell; the sentinel group's
    # slot is zeroed below.
    parent_coords = torch.zeros(n, 3, dtype=torch.int32, device=dev)
    parent_coords[child2parent] = pc.int()
    parent_coords = torch.where(parent_valid[:, None], parent_coords,
                                torch.zeros_like(parent_coords))
    return parent_feats, parent_coords, parent_valid, child2parent


def sparse_unpool(parent_feats: torch.Tensor, child2parent: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour unpool: each child gathers its parent's feature. A
    parent index past the (possibly sliced) parent array gathers zero."""
    m = parent_feats.shape[0]
    out = parent_feats[child2parent.clamp_max(m - 1)]
    return torch.where((child2parent < m)[:, None], out, torch.zeros_like(out))
