"""MoGe-equivalent monocular geometry model: affine point map + intrinsics.

Counterpart of `labelany3d_tpu/models/moge.py` with the `'tpu'` head style
(`MoGeHead`): multi-level token fusion -> conv pyramid -> point map + mask,
then focal/shift recovery and projection-consistent depth (`moge_infer`).
The checkpoint-faithful `MoGeCheckpointHead` is not ported yet.
Activations run NCHW inside the head; public tensors are NHWC as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.geometry.focal import (
    intrinsics_from_diag_focal,
    recover_focal_shift,
)
from labelany3d_tpu_torch.models.layers import Conv, Dense, resize_bilinear
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    backbone: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig.large(out_indices=(5, 11, 17, 23)))
    head_width: int = 256
    num_upsamples: int = 2
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "MoGeConfig":
        return MoGeConfig(backbone=ViTConfig.tiny_test(out_indices=(0, 1)),
                          head_width=32, num_upsamples=1)


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(in_ch, features, 3, dtype)
        self.conv2 = Conv(features, features, 3, dtype)

    def forward(self, x):
        return F.gelu(self.conv2(F.gelu(self.conv1(x))))


class MoGeHead(nn.Module):
    def __init__(self, cfg: MoGeConfig):
        super().__init__()
        self.cfg = cfg
        hw, c = cfg.head_width, cfg.backbone.width
        for i in range(len(cfg.backbone.out_indices)):
            self.add_module(f"level{i}", Dense(c, hw, cfg.dtype))
        self.fuse = ConvBlock(hw, hw, cfg.dtype)
        for i in range(cfg.num_upsamples):
            self.add_module(f"up{i}", ConvBlock(hw, hw, cfg.dtype))
        self.out_conv = Conv(hw, hw // 2, 3, cfg.dtype)
        self.out = Conv(hw // 2, 4, 3, torch.float32)  # points (3) + mask logit

    def forward(self, hiddens, grid, out_hw):
        cfg = self.cfg
        gh, gw = grid
        feats = 0.0
        for i, h in enumerate(hiddens):
            feats = feats + getattr(self, f"level{i}")(h)
        x = feats.transpose(1, 2).reshape(feats.shape[0], cfg.head_width, gh, gw)
        x = self.fuse(x)
        for i in range(cfg.num_upsamples):
            x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
            x = getattr(self, f"up{i}")(x)
        x = resize_bilinear(x, tuple(out_hw))
        x = F.gelu(self.out_conv(x))
        return self.out(x).permute(0, 2, 3, 1)  # NHWC, float32


def _remap_points(raw: torch.Tensor) -> torch.Tensor:
    """The 'exp' remap: z = exp(raw_z), xy = raw_xy * z."""
    z = torch.exp(raw[..., 2:])
    return torch.cat([raw[..., :2] * z, z], dim=-1)


class MoGeModel(nn.Module):
    """Image (B, H, W, 3) -> affine point map and mask probability."""

    def __init__(self, cfg: MoGeConfig, image_hw: tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        p = cfg.backbone.patch_size
        self.backbone = ViT(cfg.backbone, (image_hw[0] // p, image_hw[1] // p))
        self.head = MoGeHead(cfg)

    def forward(self, images: torch.Tensor) -> dict:
        b, h, w, _ = images.shape
        enc = self.backbone(images)
        out = self.head(enc["hiddens"], enc["grid"], (h, w))
        return {"points": _remap_points(out[..., :3].float()),
                "mask": torch.sigmoid(out[..., 3].float())}


def moge_infer(
    model: MoGeModel,
    images: torch.Tensor,
    apply_mask: bool = True,
    fov_x_degrees: torch.Tensor | None = None,
) -> dict:
    """Batched MoGe inference: points, depth, normalized intrinsics, mask.
    Points are re-projected through the recovered intrinsics (the JAX
    package's default `force_projection=True`)."""
    out = model(images)
    points, mask = out["points"], out["mask"]
    b, h, w, _ = points.shape
    dev = points.device
    aspect = w / h

    mask_bool = mask > 0.5
    if fov_x_degrees is None:
        focal, shift = recover_focal_shift(points, mask_bool)
    else:
        fov = torch.deg2rad(torch.as_tensor(fov_x_degrees, dtype=torch.float32, device=dev))
        focal = (aspect / (1 + aspect**2) ** 0.5 / torch.tan(fov / 2)).expand(b)
        _, shift = recover_focal_shift(points, mask_bool, focal=focal)

    intrinsics = intrinsics_from_diag_focal(focal, w, h)
    depth = points[..., 2] + shift[:, None, None]

    us = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    vs = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    points = torch.stack([(uu[None] - 0.5) / fx * depth,
                          (vv[None] - 0.5) / fy * depth, depth], dim=-1)

    final_mask = (depth > 0) & mask_bool
    if apply_mask:
        inf = torch.tensor(float("inf"), device=dev)
        points = torch.where(final_mask[..., None], points, inf)
        depth = torch.where(final_mask, depth, inf)
    return {"points": points, "intrinsics": intrinsics, "depth": depth, "mask": final_mask}


def pixel_intrinsics_from_normalized(intrinsics: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Normalized (c=0.5) -> pixel intrinsics."""
    scale = torch.tensor([[width, 1.0, width], [1.0, height, height], [1.0, 1.0, 1.0]],
                         dtype=torch.float32, device=intrinsics.device)
    return intrinsics * scale
