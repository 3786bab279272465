"""Grid sampling and multi-scale deformable attention sampling.

Counterpart of `labelany3d_tpu/ops/sampling.py`, which computes both outside
Pallas, so they are plain PyTorch here:

  * `grid_sample` — torch `F.grid_sample` semantics (bilinear, normalized
    coordinates, the `align_corners` switch, zero padding) on an (H, W, C)
    image; the SVRM triplane field and the space carver sample with it;
  * `deformable_sample` — the aggregation of multi-scale deformable
    attention: bilinear reads at per-query sampling locations over several
    feature levels, weighted and summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample with zero padding. image: (H, W, C); grid: (..., 2)
    with (x, y) in [-1, 1]. Returns (..., C) float32."""
    c = image.shape[-1]
    lead = grid.shape[:-1]
    img = image.float().permute(2, 0, 1)[None]                 # (1, C, H, W)
    g = grid.float().reshape(1, 1, -1, 2)
    out = F.grid_sample(img, g, mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners)           # (1, C, 1, N)
    return out[0, :, 0].t().reshape(*lead, c)


def deformable_sample(value_levels: list[torch.Tensor], sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention aggregation.

    value_levels: L feature maps (H_l, W_l, C); sampling_locations (Q, L, P,
    2) in [0, 1] as (x, y), P points a level; attention_weights (Q, L, P).
    Returns (Q, C): bilinear reads at each point (align_corners=False,
    loc * 2 - 1 into `grid_sample`), weighted and summed."""
    out = 0.0
    for lvl, value in enumerate(value_levels):
        sampled = grid_sample(value, sampling_locations[:, lvl] * 2.0 - 1.0)  # (Q, P, C)
        out = out + (sampled * attention_weights[:, lvl][..., None]).sum(-2)
    return out
