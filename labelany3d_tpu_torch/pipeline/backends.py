"""Depth backends for the pipeline stages (real models or an analytic fake).

Counterpart of `labelany3d_tpu/pipeline/backends.py`: `TorchDepthBackend`
mirrors `JaxDepthBackend` (MoGe gives relative depth and intrinsics;
DepthPro, conditioned on MoGe's focal, gives metric depth), and
`FakeDepthBackend` serves pre-registered analytic depth for tests.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from labelany3d_tpu_torch.models.depth_pro import DepthProConfig, DepthProModel, depth_pro_infer
from labelany3d_tpu_torch.models.moge import (
    MoGeConfig,
    MoGeModel,
    moge_infer,
    pixel_intrinsics_from_normalized,
)
from labelany3d_tpu_torch.models.registry import ModelRegistry
from labelany3d_tpu_torch.models.vit import ViTConfig
from labelany3d_tpu_torch.models.weights import cast_inference_params_, init_params_
from labelany3d_tpu_torch.utils.device import resolve_device


class DepthBackend(Protocol):
    """Batch depth inference: (B, H, W, 3) uint8 or float images in [0, 1] ->
    dict(relative_depth, metric_depth, depth_mask, K_pixels) on the device."""

    device: torch.device

    def infer(self, images: np.ndarray) -> dict: ...


class TorchDepthBackend:
    """MoGe -> DepthPro at one pinned resolution bucket.

    Models are built on first use at that bucket (`pin_hw`, else the first
    batch's size) with random weights from a `torch.Generator` seeded with
    `seed` (MoGe) and `seed + 1` (DepthPro), whose Dense/Conv weights are
    then cast to bf16 once, as the JAX backend does for its random init.
    Converted checkpoints wait for the ported checkpoint models.
    """

    def __init__(
        self,
        moge_cfg: MoGeConfig | None = None,
        depth_pro_cfg: DepthProConfig | None = None,
        seed: int = 0,
        pin_hw: tuple | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.moge_cfg = moge_cfg or MoGeConfig()
        self.dp_cfg = depth_pro_cfg or DepthProConfig()
        self._seed = seed
        self._hw = tuple(pin_hw) if pin_hw is not None else None
        self.moge: MoGeModel | None = None
        self.depth_pro: DepthProModel | None = None

    def _build(self, model: torch.nn.Module, seed: int) -> torch.nn.Module:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cast_inference_params_(init_params_(model, gen))
        return model.eval().requires_grad_(False)

    def _ensure_models(self, h: int, w: int) -> None:
        if self.moge is not None:
            return
        from labelany3d_tpu_torch.utils.logging import warn_once

        warn_once("depth_random",
                  "depth backend runs with random-initialized weights (no "
                  "converted MoGe/DepthPro checkpoint): depth maps and "
                  "intrinsics are not meaningful")
        hw = self._hw or (h, w)
        self._hw = hw
        with torch.device(self.device):
            self.moge = self._build(MoGeModel(self.moge_cfg, hw), self._seed)
            self.depth_pro = self._build(DepthProModel(self.dp_cfg, hw), self._seed + 1)

    @torch.inference_mode()
    def infer(self, images) -> dict:
        b, h, w, _ = images.shape
        self._ensure_models(h, w)
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        # uint8 batches normalise on the device: 4x fewer bytes to copy.
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        m = moge_infer(self.moge, x, apply_mask=True)
        K_pix = pixel_intrinsics_from_normalized(m["intrinsics"], w, h)
        d = depth_pro_infer(self.depth_pro, x, f_px=K_pix[:, 0, 0])
        return {
            "relative_depth": m["depth"],
            "metric_depth": d["depth"],
            "depth_mask": m["mask"],
            "K_pixels": K_pix,
        }


class FakeDepthBackend:
    """Analytic backend for hermetic tests: rows of `infer` calls consume the
    pre-registered true depth maps in order."""

    def __init__(self, depths: np.ndarray, K: np.ndarray, relative_scale: float = 0.5,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.depths = np.asarray(depths, np.float32)
        self.K = np.asarray(K, np.float32)
        self.relative_scale = relative_scale
        self._cursor = 0

    def infer(self, images) -> dict:
        b = images.shape[0]
        sel = torch.as_tensor(self.depths[self._cursor:self._cursor + b], device=self.device)
        self._cursor += b
        K = torch.as_tensor(np.broadcast_to(self.K, (b, 3, 3)).copy(), device=self.device)
        return {
            "relative_depth": sel * self.relative_scale,
            "metric_depth": sel,
            "depth_mask": torch.ones_like(sel, dtype=torch.bool),
            "K_pixels": K,
        }


def make_depth(preset: str = "large", **kw) -> TorchDepthBackend:
    """Depth backend presets, as `register_default_backends().make_depth`."""
    if preset == "tiny_test":
        return TorchDepthBackend(MoGeConfig.tiny_test(), DepthProConfig.tiny_test(), **kw)
    if preset in ("vitl_reference", "tiny_reference"):
        raise NotImplementedError(
            f"preset {preset!r} needs DepthPro35 and the MoGe checkpoint head, "
            "which are not ported yet")
    presets = {"small": ViTConfig.small, "base": ViTConfig.base, "large": ViTConfig.large}
    if preset not in presets:
        raise ValueError(f"Unknown models.moge.preset: {preset!r} (choose small | base | "
                         "large | tiny_test)")
    backbone = presets[preset]
    out_indices = (5, 11, 17, 23) if preset == "large" else (2, 5, 8, 11)
    return TorchDepthBackend(MoGeConfig(backbone=backbone(out_indices=out_indices)),
                             DepthProConfig(backbone=backbone()), **kw)


def default_registry() -> ModelRegistry:
    """A registry with the production depth factory under 'depth'."""
    reg = ModelRegistry()
    reg.register("depth", make_depth)
    return reg
