"""Plain depth backend of the reference: a frozen copy of the port's
`pipeline/backends.py::TorchDepthBackend._infer_rows` for MoGe and the
35-patch DepthPro, and of the stage's host resize, over the reference
models."""

from __future__ import annotations

import numpy as np
import torch

from .depth_pro import depth_pro35_infer
from .layers import resize
from .moge import moge_infer, pixel_intrinsics_from_normalized
from .precision import full_f32


def resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear uint8 resize on the host (Pillow, antialiased)."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))


@torch.no_grad()
def infer(moge, depth_pro, img_size: int, images: torch.Tensor) -> dict:
    """(B, H, W, 3) uint8 -> relative_depth, metric_depth, depth_mask,
    K_pixels, in float32 with TF32 off."""
    with full_f32():
        _, h, w, _ = images.shape
        x = images.float() / 255.0
        m = moge_infer(moge, x, apply_mask=True)
        k_pix = pixel_intrinsics_from_normalized(m["intrinsics"], w, h)
        x_dp = resize(x.permute(0, 3, 1, 2), (img_size, img_size)).permute(0, 2, 3, 1)
        d = depth_pro35_infer(depth_pro, x_dp, f_px=k_pix[:, 0, 0] * (img_size / w))
        metric = resize(d["depth"][:, None], (h, w))[:, 0]
    return {"relative_depth": m["depth"], "metric_depth": metric, "depth_mask": m["mask"],
            "K_pixels": k_pix}
