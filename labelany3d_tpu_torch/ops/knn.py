"""K-nearest-neighbour distances (simple-knn's role).

Counterpart of `labelany3d_tpu/ops/knn.py`: the mean distance to the 3
nearest neighbours, with which Gaussian-splat scales are initialised.
Tiled pairwise distances (|a|^2 + |b|^2 - 2ab, the product in full float32)
and the k smallest of each row, in plain PyTorch.
"""

from __future__ import annotations

import torch

from labelany3d_tpu_torch.utils.precision import full_f32


def knn_distances(points: torch.Tensor, k: int = 3, tile: int = 2048) -> torch.Tensor:
    """(N, 3) points -> (N, k) squared distances to the k nearest others."""
    pts = torch.as_tensor(points).float()
    n = pts.shape[0]
    sq = (pts * pts).sum(-1)
    out = []
    with full_f32():
        for r0 in range(0, n, tile):
            q = pts[r0:r0 + tile]
            d2 = sq[r0:r0 + tile, None] + sq[None, :] - 2.0 * (q @ pts.t())
            rows = torch.arange(r0, r0 + q.shape[0], device=pts.device)
            d2[torch.arange(q.shape[0], device=pts.device), rows] = float("inf")  # no self
            out.append(torch.topk(d2, k, dim=-1, largest=False).values)
    return torch.cat(out).clamp_min(0.0)


def mean_knn_distance(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(N,) mean distance to the k nearest neighbours (simple-knn's output)."""
    return knn_distances(points, k).sqrt().mean(-1)
