"""Instance-mask analysis, filtering and morphology, batched over instance
slots; counterpart of `labelany3d_tpu/geometry/masks.py`.

  * `analyze_mask`: truncated = mask pixels in the 10-px border bands >= 10
    (the four bands summed apart, so corner pixels count twice); scaleable
    = area >= 100;
  * `mask_max_height`: last occupied row - first + 1;
  * `filter_instances`: keep when height / image height > 0.0625, not
    truncated and scaleable;
  * `binary_opening`, `upscale_mask_nearest`: the crop stage's 7x7 opening
    and 4x upscale.

A function given a tensor computes where it lives; one given a numpy array
computes on the card unless `device="cpu"`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from labelany3d_tpu_torch.utils.device import tensors_on


class MaskStats(NamedTuple):
    truncated: torch.Tensor   # bool: touches the image border bands
    scaleable: torch.Tensor   # bool: area above the threshold
    area: torch.Tensor        # int32 pixel count
    height: torch.Tensor      # int32 vertical extent in pixels


def mask_max_height(mask, *, device=None) -> torch.Tensor:
    """Vertical extent (last occupied row - first + 1) of (..., H, W) masks;
    0 for an empty mask."""
    (mask,) = tensors_on(mask, device=device, dtype=torch.bool)
    rows = mask.any(-1)
    idx = torch.arange(rows.shape[-1], dtype=torch.int32, device=rows.device)
    big = 1 << 30
    first = torch.where(rows, idx, big).amin(-1)
    last = torch.where(rows, idx, -big).amax(-1)
    return torch.where(rows.any(-1), last - first + 1, 0).to(torch.int32)


def analyze_mask(mask, scale_threshold: int = 100, boundary_threshold: int = 10,
                 truncation_count: int = 10, *, device=None) -> MaskStats:
    """Truncation and scale statistics of (..., H, W) boolean masks."""
    (mask,) = tensors_on(mask, device=device, dtype=torch.bool)
    m = mask.to(torch.int32)
    b = boundary_threshold

    def total(x):
        return x.sum((-2, -1), dtype=torch.int32)

    area = total(m)
    border = (total(m[..., :b, :]) + total(m[..., -b:, :]) + total(m[..., :, :b])
              + total(m[..., :, -b:]))
    return MaskStats(truncated=border >= truncation_count, scaleable=area >= scale_threshold,
                     area=area, height=mask_max_height(mask))


def filter_instances(masks, image_height: int, min_height_frac: float = 0.0625, *,
                     device=None) -> torch.Tensor:
    """Keep flags for (I, H, W) instance masks: taller than `min_height_frac`
    of the image, not border-truncated, and scaleable."""
    stats = analyze_mask(masks, device=device)
    tall_enough = stats.height.float() / float(image_height) > min_height_frac
    return tall_enough & ~stats.truncated & stats.scaleable


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
