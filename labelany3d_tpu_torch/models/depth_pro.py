"""DepthPro-equivalent metric monocular depth (2x2-tile multi-scale ViT).

Counterpart of `labelany3d_tpu/models/depth_pro.py::DepthProModel` and
`depth_pro_infer`: the global view (downsampled, antialiased) and the 2x2
half-size tiling run as one batched ViT call, then a small conv fusion
decoder predicts canonical inverse depth, made metric by the focal length.
The checkpoint-faithful `DepthPro35` is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, resize_bilinear
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    backbone: ViTConfig = dataclasses.field(default_factory=ViTConfig.large)
    fusion_width: int = 256
    input_size: int = 768
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "DepthProConfig":
        return DepthProConfig(backbone=ViTConfig.tiny_test(), fusion_width=32, input_size=64)


class FusionBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype, skip: bool = False):
        super().__init__()
        if skip:
            self.skip_proj = Conv(features, features, 1, dtype)
        self.c1 = Conv(features, features, 3, dtype)
        self.c2 = Conv(features, features, 3, dtype)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.skip_proj(skip)
        x = x + self.c2(F.gelu(self.c1(x)))
        return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))


class DepthProModel(nn.Module):
    """Image (B, H, W, 3) -> canonical inverse depth (B, H, W), float32."""

    def __init__(self, cfg: DepthProConfig, image_hw: tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        p = cfg.backbone.patch_size
        c, fw = cfg.backbone.width, cfg.fusion_width
        self.encoder = ViT(cfg.backbone, (image_hw[0] // 2 // p, image_hw[1] // 2 // p))
        self.global_proj = Conv(c, fw, 1, cfg.dtype)
        self.local_proj = Conv(c, fw, 1, cfg.dtype)
        self.fuse_global = FusionBlock(fw, cfg.dtype)
        self.fuse_local = FusionBlock(fw, cfg.dtype, skip=True)
        self.head1 = Conv(fw, fw // 2, 3, cfg.dtype)
        self.head2 = Conv(fw // 2, 1, 3, torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images.shape
        th, tw = h // 2, w // 2
        half = resize_bilinear(images.permute(0, 3, 1, 2), (th, tw), antialias=True)
        tiles = torch.cat([
            images[:, :th, :tw], images[:, :th, tw:],
            images[:, th:, :tw], images[:, th:, tw:],
            half.permute(0, 2, 3, 1).to(images.dtype),
        ], dim=0)  # (5B, th, tw, 3)
        enc = self.encoder(tiles)
        gh, gw = enc["grid"]
        tok = enc["tokens"].transpose(1, 2).reshape(5 * b, -1, gh, gw)  # NCHW
        t00, t01, t10, t11, g = tok.split(b, dim=0)
        local = torch.cat([torch.cat([t00, t01], dim=3), torch.cat([t10, t11], dim=3)], dim=2)

        x = self.fuse_global(self.global_proj(g))              # -> 2gh
        x = self.fuse_local(x, skip=self.local_proj(local))    # -> 4gh
        x = resize_bilinear(x, (h, w))
        x = self.head2(F.gelu(self.head1(x)))
        return F.softplus(x[:, 0].float())


def depth_pro_infer(
    model: DepthProModel,
    images: torch.Tensor,
    f_px: torch.Tensor,
    max_depth: float = 1e4,
) -> dict:
    """Metric depth = 1 / clip(canonical * (W / f_px), 1/max_depth, 1e4),
    with W the width of `images`."""
    canonical = model(images)
    b, h, w = canonical.shape
    f_px = torch.as_tensor(f_px, dtype=torch.float32, device=canonical.device).expand(b)
    inverse_depth = canonical * (w / f_px)[:, None, None]
    depth = 1.0 / inverse_depth.clamp(1.0 / max_depth, 1e4)
    return {"depth": depth, "canonical_inverse_depth": canonical}
