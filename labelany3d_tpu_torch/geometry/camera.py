"""Camera intrinsics helpers (counterpart of `labelany3d_tpu/geometry/camera.py`;
only what the `fast` route needs)."""

from __future__ import annotations

import torch


def intrinsics_from_focal_center(fx, fy, cx, cy) -> torch.Tensor:
    """Build (..., 3, 3) pinhole intrinsics from focal lengths and center."""
    fx, fy, cx, cy = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.float32)
                                               for v in (fx, fy, cx, cy)))
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = [
        torch.stack([fx, zero, cx], dim=-1),
        torch.stack([zero, fy, cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
