"""Instance-mask analysis and morphology; counterpart of
`labelany3d_tpu/geometry/masks.py` (what the crop stage uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_opening(mask: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Binary opening with a size x size all-ones element, scipy semantics
    (outside the image counts as background for the erosion)."""
    m = mask.bool()
    squeeze = m.dim() == 2
    x = (m[None] if squeeze else m).float()[:, None]  # (N, 1, H, W)
    pad = size // 2
    xp = F.pad(x, (pad, pad, pad, pad), value=0.0)
    eroded = -F.max_pool2d(-xp, size, stride=1)
    lo, hi = size // 2, size - 1 - size // 2
    opened = F.max_pool2d(F.pad(eroded, (lo, hi, lo, hi), value=0.0), size, stride=1)
    out = opened[:, 0] > 0.5
    return out[0] if squeeze else out


def upscale_mask_nearest(mask: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Nearest-neighbour integer upscale."""
    return mask.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)
