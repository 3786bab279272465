"""MoGe-equivalent monocular geometry model: affine point map + intrinsics.

Counterpart of `labelany3d_tpu/models/moge.py`: a ViT backbone, then
either the `'tpu'` head style (`MoGeHead`: multi-level token fusion -> conv
pyramid -> point map + mask) or the checkpoint-faithful `'reference'` head
(`MoGeCheckpointHead`, the released MoGe head's graph and parameter names),
then focal/shift recovery and projection-consistent depth (`moge_infer`).
Activations run NCHW inside the heads; public tensors are NHWC as in JAX.

The reference head's shape-only constants (the view-plane UV planes and the
resize's tap matrices) are built once per shape, dtype and device and kept
there (`_head_constant`), so a forward at a shape seen before copies nothing
from the host and never waits for the device.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.geometry.focal import (
    intrinsics_from_diag_focal,
    recover_focal_shift,
)
from labelany3d_tpu_torch.models.layers import (
    Conv,
    Conv3Replicate,
    ConvTranspose,
    Dense,
    GroupNorm32,
    replicate_pad,
    resize,
)
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig
from labelany3d_tpu_torch.ops.attention import LaunchCounter


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    backbone: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig.large(out_indices=(5, 11, 17, 23)))
    head_width: int = 256
    num_upsamples: int = 2
    remap_output: str = "exp"       # 'linear' | 'sinh' | 'exp' | 'sinh_exp'
    output_mask: bool = True
    dtype: torch.dtype = torch.bfloat16
    # 'tpu' = the JAX package's fused resize/conv pyramid; 'reference' = the
    # released MoGe head's graph, so converted torch weights load 1:1.
    head_style: str = "tpu"
    # reference-head hyperparameters (the released head's defaults)
    dim_proj: int = 512
    dim_upsample: tuple = (256, 128, 128)
    num_res_blocks: int = 1
    last_res_blocks: int = 0
    last_conv_channels: int = 32
    last_conv_size: int = 1
    split_head: bool = True         # dim_out [3, 1] rather than one 4-channel conv

    @staticmethod
    def tiny_test() -> "MoGeConfig":
        return MoGeConfig(backbone=ViTConfig.tiny_test(out_indices=(0, 1)),
                          head_width=32, num_upsamples=1)

    @staticmethod
    def vitl() -> "MoGeConfig":
        """Shape of the released `Ruicheng/moge-vitl` checkpoint: the last
        four blocks' normed outputs, split mask head, exp-remapped output,
        DINOv2-L/14 pos-embed grid of 37 x 37 (518 px)."""
        return MoGeConfig(
            backbone=ViTConfig.large(out_indices=(20, 21, 22, 23), norm_hiddens=True,
                                     pos_grid=(37, 37)),
            head_style="reference")

    @staticmethod
    def tiny_reference_test() -> "MoGeConfig":
        return MoGeConfig(
            backbone=ViTConfig.tiny_test(out_indices=(0, 1), norm_hiddens=True),
            head_style="reference", dim_proj=16, dim_upsample=(8, 8),
            last_conv_channels=8, dtype=torch.float32)


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
        self.out = Conv(hw // 2, 4 if cfg.output_mask else 3, 3, torch.float32)

    def forward(self, hiddens, grid, out_hw):
        cfg = self.cfg
        gh, gw = grid
        feats = 0.0
        for i, h in enumerate(hiddens):
            feats = feats + getattr(self, f"level{i}")(h)
        x = feats.transpose(1, 2).reshape(feats.shape[0], cfg.head_width, gh, gw)
        x = self.fuse(x)
        for i in range(cfg.num_upsamples):
            x = resize(x, (x.shape[2] * 2, x.shape[3] * 2))
            x = getattr(self, f"up{i}")(x)
        x = resize(x, tuple(out_hw))
        x = F.gelu(self.out_conv(x))
        return self.out(x).permute(0, 2, 3, 1)  # NHWC, float32


def _view_plane_uv(height: int, width: int, aspect: float) -> np.ndarray:
    """(H, W, 2) view-plane UV at pixel centres, corners at +-(w, h) over
    the diagonal (the released MoGe's `image_uv`)."""
    span_x = aspect / (1 + aspect**2) ** 0.5
    span_y = 1 / (1 + aspect**2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width)
    v = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height)
    uu, vv = np.meshgrid(u.astype("float32"), v.astype("float32"))
    return np.stack([uu, vv], axis=-1)


# The head's shape-only constants, built on first use and kept on their
# device, least recently used first out past `_HEAD_CONSTANTS_MAX`. Not
# buffers: `state_dict` and the converters never see them. The builds and
# the hits are counted (`HEAD_CONSTANT_BUILDS`, `HEAD_CONSTANT_HITS`); a
# warm forward only hits.
_HEAD_CONSTANTS_MAX = 64
_HEAD_CONSTANTS: collections.OrderedDict = collections.OrderedDict()
_HEAD_CONSTANTS_LOCK = threading.Lock()
HEAD_CONSTANT_BUILDS = LaunchCounter()
HEAD_CONSTANT_HITS = LaunchCounter()


def _head_constant(key: tuple, build) -> torch.Tensor:
    """The tensor kept under `key`, made by `build()` the first time. It is
    built outside any inference mode, so a training step can save it for
    its backward whoever asked first; no caller writes to it."""
    with _HEAD_CONSTANTS_LOCK:
        t = _HEAD_CONSTANTS.get(key)
        if t is not None:
            _HEAD_CONSTANTS.move_to_end(key)
            HEAD_CONSTANT_HITS.count += 1
            return t
        with torch.inference_mode(False):
            t = build()
        _HEAD_CONSTANTS[key] = t
        if len(_HEAD_CONSTANTS) > _HEAD_CONSTANTS_MAX:
            _HEAD_CONSTANTS.popitem(last=False)
        HEAD_CONSTANT_BUILDS.count += 1
        return t


def clear_head_constants() -> None:
    """Forget every kept constant (the counters stay)."""
    with _HEAD_CONSTANTS_LOCK:
        _HEAD_CONSTANTS.clear()


def _cat_uv(x: torch.Tensor, aspect: float, pad: int = 0) -> torch.Tensor:
    """NCHW x with the view-plane UV of its (unpadded) size appended as two
    channels; with `pad`, x is already edge-padded by `pad` and so is the
    UV."""
    h, w = x.shape[2] - 2 * pad, x.shape[3] - 2 * pad

    def build():
        uv = _view_plane_uv(h, w, aspect)
        if pad:
            uv = np.pad(uv, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        return torch.from_numpy(uv).to(x.device, x.dtype).permute(2, 0, 1)

    uv = _head_constant(("uv", h, w, aspect, pad, x.dtype, x.device), build)
    return torch.cat([x, uv.expand(x.shape[0], -1, -1, -1)], dim=1)


class ResidualConvBlock(nn.Module):
    """GroupNorm -> ReLU -> conv3 -> GroupNorm -> ReLU -> conv3 + skip, both
    convs after an edge pad (the released head's `ResidualConvBlock`)."""

    def __init__(self, in_ch: int, features: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        if in_ch != features:
            self.skip = Conv(in_ch, features, 1, dtype)
        self.norm1 = GroupNorm32(1, in_ch)
        self.conv1 = Conv3Replicate(in_ch, hidden, dtype)
        self.norm2 = GroupNorm32(max(hidden // 32, 1), hidden)
        self.conv2 = Conv3Replicate(hidden, features, dtype)

    def forward(self, x):
        skip = self.skip(x) if hasattr(self, "skip") else x
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h))) + skip


def _resize_matrix(in_size: int, out_size: int, pad: int) -> np.ndarray:
    """(out_size + 2 * pad, in_size) float32: each row the two tap weights
    of one output row of a bilinear resize (torch `align_corners=False`,
    no antialias, as the released head), the `pad` edge rows on each side
    repeating the first and last row's taps (the JAX package's
    `_resize_matrix`)."""
    pos = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(pos)
    w1 = (pos - base).astype(np.float32)
    i0 = np.clip(base, 0, in_size - 1).astype(np.int64)
    i1 = np.clip(base + 1, 0, in_size - 1).astype(np.int64)
    if pad:
        i0, i1, w1 = (np.concatenate([np.repeat(a[:1], pad), a, np.repeat(a[-1:], pad)])
                      for a in (i0, i1, w1))
    g = np.zeros((len(i0), in_size), np.float32)
    rows = np.arange(len(i0))
    np.add.at(g, (rows, i0), 1 - w1)
    np.add.at(g, (rows, i1), w1)
    return g


def _resize_bilinear_pad(x: torch.Tensor, out_hw: tuple[int, int], pad: int = 1) -> torch.Tensor:
    """NCHW bilinear resize with an edge pad of `pad` pixels fused in, as
    two products with the tap matrices (`_resize_matrix`), each rounded to
    `x.dtype`, as the JAX package computes it. Unlike `F.interpolate`,
    whose backward adds with atomics on CUDA, the products' backward is the
    same from run to run, so a training step repeats."""
    def taps(n, o):
        return _head_constant(("taps", n, o, pad, x.dtype, x.device), lambda: torch.as_tensor(
            _resize_matrix(n, o, pad), dtype=x.dtype, device=x.device))

    gh, gw = taps(x.shape[2], out_hw[0]), taps(x.shape[3], out_hw[1])
    return torch.matmul(torch.matmul(gh, x), gw.t())


class MoGeCheckpointHead(nn.Module):
    """The released MoGe head: per-level 1x1 projections summed, 2x
    ConvTranspose upsample blocks with UV concatenated and residual conv
    blocks, bilinear resize to the image size, then per-output conv blocks
    (points, then the mask). Parameter names are the JAX package's
    (`project{i}`, `up{i}_deconv`, `up{i}_conv`, `up{i}_res{r}`,
    `out{j}_conv_in`, `out{j}_res{r}`, `out{j}_conv_out`), so
    `convert.convert_moge_checkpoint` maps a release onto it. The JAX
    package fuses the two output heads and precomputes the UV channels'
    response; this head runs each conv plainly on the concatenated input."""

    def __init__(self, cfg: MoGeConfig):
        super().__init__()
        self.cfg = cfg
        dt, c = cfg.dtype, cfg.backbone.width
        for i in range(len(cfg.backbone.out_indices)):
            self.add_module(f"project{i}", Conv(c, cfg.dim_proj, 1, dt))
        ch = cfg.dim_proj
        for i, out_ch in enumerate(cfg.dim_upsample):
            self.add_module(f"up{i}_deconv", ConvTranspose(ch + 2, out_ch, 2, dt))
            self.add_module(f"up{i}_conv", Conv3Replicate(out_ch, out_ch, dt))
            for r in range(cfg.num_res_blocks):
                self.add_module(f"up{i}_res{r}", ResidualConvBlock(out_ch, out_ch, out_ch, dt))
            ch = out_ch
        cc, k = cfg.last_conv_channels, cfg.last_conv_size
        for j, d in enumerate(self.dim_out):
            self.add_module(f"out{j}_conv_in", Conv(ch + 2, cc, 3, dt, padding=0))
            for r in range(cfg.last_res_blocks):
                self.add_module(f"out{j}_res{r}", ResidualConvBlock(cc, cc, cc, dt))
            self.add_module(f"out{j}_conv_out", Conv(cc, d, k, torch.float32, padding=0))

    @property
    def dim_out(self) -> list[int]:
        cfg = self.cfg
        if cfg.output_mask and cfg.split_head:
            return [3, 1]
        return [4] if cfg.output_mask else [3]

    def forward(self, hiddens, grid, out_hw):
        cfg = self.cfg
        gh, gw = grid
        img_h, img_w = out_hw
        aspect = img_w / img_h
        x = 0.0
        for i, h in enumerate(hiddens):
            tok = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], gh, gw)
            x = x + getattr(self, f"project{i}")(tok)
        for i in range(len(cfg.dim_upsample)):
            x = getattr(self, f"up{i}_deconv")(_cat_uv(x, aspect))
            x = getattr(self, f"up{i}_conv")(x)
            for r in range(cfg.num_res_blocks):
                x = getattr(self, f"up{i}_res{r}")(x)
        xq = _cat_uv(_resize_bilinear_pad(x, (img_h, img_w)), aspect, pad=1)
        k = cfg.last_conv_size
        outs = []
        for j in range(len(self.dim_out)):
            h = getattr(self, f"out{j}_conv_in")(xq)
            for r in range(cfg.last_res_blocks):
                h = getattr(self, f"out{j}_res{r}")(h)
            h = F.relu(h)
            if k > 1:
                h = replicate_pad(h, k // 2)
            outs.append(getattr(self, f"out{j}_conv_out")(h))
        return torch.cat(outs, dim=1).permute(0, 2, 3, 1)  # NHWC, float32


def _remap_points(raw: torch.Tensor, mode: str) -> torch.Tensor:
    """Output-space remapping of the raw point channels."""
    if mode == "linear":
        return raw
    if mode == "sinh":
        return torch.sinh(raw)
    if mode == "exp":
        z = torch.exp(raw[..., 2:])
        return torch.cat([raw[..., :2] * z, z], dim=-1)
    if mode == "sinh_exp":
        return torch.cat([torch.sinh(raw[..., :2]), torch.exp(raw[..., 2:])], dim=-1)
    raise ValueError(f"Invalid remap mode: {mode}")


class MoGeModel(nn.Module):
    """Image (B, H, W, 3) -> affine point map and mask probability."""

    def __init__(self, cfg: MoGeConfig, image_hw: tuple[int, int]):
        super().__init__()
        if cfg.head_style not in ("tpu", "reference"):
            raise ValueError(f"Unknown head_style: {cfg.head_style!r} (expected 'tpu' or "
                             "'reference')")
        self.cfg = cfg
        p = cfg.backbone.patch_size
        self.backbone = ViT(cfg.backbone, (image_hw[0] // p, image_hw[1] // p))
        self.head = MoGeCheckpointHead(cfg) if cfg.head_style == "reference" else MoGeHead(cfg)

    def forward(self, images: torch.Tensor) -> dict:
        b, h, w, _ = images.shape
        enc = self.backbone(images)
        out = self.head(enc["hiddens"], enc["grid"], (h, w))
        result = {"points": _remap_points(out[..., :3].float(), self.cfg.remap_output)}
        if self.cfg.output_mask:
            result["mask"] = torch.sigmoid(out[..., 3].float())
        return result


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
    points, mask = out["points"], out.get("mask")
    b, h, w, _ = points.shape
    dev = points.device
    aspect = w / h

    mask_bool = None if mask is None else mask > 0.5
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

    result = {"points": points, "intrinsics": intrinsics, "depth": depth}
    if mask_bool is not None:
        final_mask = (depth > 0) & mask_bool
        if apply_mask:
            inf = torch.tensor(float("inf"), device=dev)
            result["points"] = torch.where(final_mask[..., None], points, inf)
            result["depth"] = torch.where(final_mask, depth, inf)
        result["mask"] = final_mask
    return result


def pixel_intrinsics_from_normalized(intrinsics: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Normalized (c=0.5) -> pixel intrinsics."""
    scale = torch.tensor([[width, 1.0, width], [1.0, height, height], [1.0, 1.0, 1.0]],
                         dtype=torch.float32, device=intrinsics.device)
    return intrinsics * scale
