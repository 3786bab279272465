# Frozen copy of labelany3d_tpu_torch/geometry/reductions.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Masked reductions over padded (static-shape) data; counterpart of
`labelany3d_tpu/geometry/reductions.py`. Reduce over the last axis unless
noted; broadcast over leading batch dims."""

from __future__ import annotations

import torch

_BIG = 3.4e38


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=-1, keepdim=False) -> torch.Tensor:
    """Mean of `x` where `mask`; 0 when the mask is empty."""
    m = mask.to(x.dtype)
    total = (x * m).sum(dim=dim, keepdim=keepdim)
    count = m.sum(dim=dim, keepdim=keepdim)
    return total / count.clamp_min(1.0)


def masked_min(x: torch.Tensor, mask: torch.Tensor, dim=-1, keepdim=False) -> torch.Tensor:
    return torch.where(mask, x, torch.full_like(x, _BIG)).amin(dim=dim, keepdim=keepdim)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim=-1, keepdim=False) -> torch.Tensor:
    return torch.where(mask, x, torch.full_like(x, -_BIG)).amax(dim=dim, keepdim=keepdim)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of `x[mask]` along the last axis (numpy semantics for even
    counts); 0 for empty masks."""
    x = x.float()
    n = x.shape[-1]
    s = torch.where(mask, x, torch.full_like(x, _BIG)).sort(dim=-1).values
    count = mask.sum(dim=-1)
    lo = ((count - 1) // 2).clamp(0, n - 1)
    hi = (count // 2).clamp(0, n - 1)
    med = 0.5 * (s.gather(-1, lo[..., None])[..., 0] + s.gather(-1, hi[..., None])[..., 0])
    return torch.where(count > 0, med, torch.zeros_like(med))


def masked_mad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median absolute deviation of `x[mask]` (sklearn RANSAC's default
    residual threshold)."""
    med = masked_median(x, mask)
    return masked_median((x - med[..., None]).abs(), mask)
