"""Sparse-structure flow model and decoder: image -> 16^3 latent -> 64^3
occupancy.

Counterpart of `labelany3d_tpu/models/trellis/sparse_structure.py`
(TRELLIS `SparseStructureFlowModel` and `SparseStructureDecoder`): a DiT
flow model over a 16^3 x 8 structure latent, conditioned on DINOv2 tokens,
and a Conv3d decoder (res blocks + 3D pixel shuffle) to 64^3 occupancy
logits. The latent rides as (B, R^3, C) row-major tokens; the decoder runs
NCDHW with channel LayerNorms. `decode_occupancy` takes the top
`max_voxels` cells (fixed slots), ties broken by the lower flat index as
`jax.lax.top_k` does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv3d, Dense, GroupNorm32, LayerNorm32, layer_norm
from labelany3d_tpu_torch.models.trellis.dit import (
    AdaLNModulation,
    DiTBlock,
    DiTConfig,
    TimestepEmbedder,
    ape_3d,
)


@dataclasses.dataclass(frozen=True)
class SparseStructureConfig:
    """SS flow-model hyperparameters (ss_flow_img_dit_L_16l8_fp16 shapes)."""

    latent_res: int = 16
    latent_channels: int = 8
    out_channels: int = 8
    patch_size: int = 1
    grid_size: int = 64
    dit: DiTConfig = dataclasses.field(default_factory=lambda: DiTConfig(qk_rms_norm=True))
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "SparseStructureConfig":
        return SparseStructureConfig(latent_res=4, latent_channels=4, out_channels=4,
                                     grid_size=16, dit=DiTConfig.tiny_test())


def patchify_tokens(latent: torch.Tensor, res: int, p: int) -> torch.Tensor:
    """(B, R^3, C) row-major tokens -> (B, (R/p)^3, C p^3) patches, features
    [c, px, py, pz]."""
    b, _, c = latent.shape
    h = res // p
    x = latent.reshape(b, h, p, h, p, h, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, h ** 3, c * p ** 3)


def unpatchify_tokens(tokens: torch.Tensor, res: int, p: int, out_ch: int) -> torch.Tensor:
    """Inverse of `patchify_tokens`: -> (B, R^3, out_ch) row-major."""
    b = tokens.shape[0]
    h = res // p
    x = tokens.reshape(b, h, h, h, out_ch, p, p, p).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, res ** 3, out_ch)


def grid_coords(res: int, device=None) -> torch.Tensor:
    """(res^3, 3) row-major (x, y, z) integer coordinates."""
    g = torch.arange(res, device=device)
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


class SparseStructureFlowModel(nn.Module):
    """Velocity over the structure latent: latent (B, R^3, C) row-major, t
    (B,) already scaled by 1000, cond tokens (B, M, cond_dim)."""

    def __init__(self, cfg: SparseStructureConfig):
        super().__init__()
        self.cfg = cfg
        dit, p = cfg.dit, cfg.patch_size
        self.input_layer = Dense(cfg.latent_channels * p ** 3, dit.width, dit.dtype)
        self.t_embedder = TimestepEmbedder(dit.width)
        if dit.share_mod:
            self.adaln = AdaLNModulation(dit.width)
        for i in range(dit.depth):
            self.add_module(f"block{i}", DiTBlock(dit))
        self.out_layer = Dense(dit.width, cfg.out_channels * p ** 3, torch.float32)
        self.out_layer.zero_init = True

    def forward(self, latent: torch.Tensor, t: torch.Tensor, cond_tokens: torch.Tensor):
        cfg = self.cfg
        dit, p = cfg.dit, cfg.patch_size
        x = self.input_layer(patchify_tokens(latent, cfg.latent_res, p))
        x = x + ape_3d(grid_coords(cfg.latent_res // p, x.device), dit.width)[None].to(dit.dtype)
        t_emb = self.t_embedder(t)
        mods = self.adaln(t_emb) if dit.share_mod else None
        cond_tokens = cond_tokens.to(dit.dtype)
        for i in range(dit.depth):
            x = getattr(self, f"block{i}")(x, t_emb=t_emb, cond_tokens=cond_tokens, mods=mods)
        x = self.out_layer(layer_norm(x, 1e-5))
        return unpatchify_tokens(x, cfg.latent_res, p, cfg.out_channels)


@dataclasses.dataclass(frozen=True)
class SSDecoderConfig:
    """`SparseStructureDecoder` shapes (ss_dec_conv3d_16l8 defaults)."""

    latent_channels: int = 8
    out_channels: int = 1
    channels: Sequence[int] = (512, 128, 32)
    num_res_blocks: int = 2
    num_res_blocks_middle: int = 2
    norm_type: str = "layer"        # 'layer' (ChannelLayerNorm32) | 'group'
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "SSDecoderConfig":
        return SSDecoderConfig(latent_channels=4, channels=(16, 8, 8), num_res_blocks=1,
                               num_res_blocks_middle=1)


class ChannelLayerNorm(LayerNorm32):
    """NCDHW LayerNorm over channels in float32 (ChannelLayerNorm32)."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


def channel_norm(cfg: SSDecoderConfig, channels: int) -> nn.Module:
    """The decoder's norm, epsilon 1e-5: LayerNorm over channels, or
    GroupNorm with 32 groups."""
    if cfg.norm_type == "layer":
        return ChannelLayerNorm(channels, eps=1e-5)
    return GroupNorm32(32, channels)


class ResBlock3d(nn.Module):
    """norm-SiLU-conv3 twice (second conv zero-initialised) + 1x1 skip."""

    def __init__(self, cfg: SSDecoderConfig, channels: int, out_channels: int):
        super().__init__()
        self.dtype = cfg.dtype
        self.norm1 = channel_norm(cfg, channels)
        self.conv1 = Conv3d(channels, out_channels, 3, cfg.dtype)
        self.norm2 = channel_norm(cfg, out_channels)
        self.conv2 = Conv3d(out_channels, out_channels, 3, cfg.dtype)
        self.conv2.zero_init = True
        if out_channels != channels:
            self.skip = Conv3d(channels, out_channels, 1, cfg.dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(self.dtype))
        return h + (self.skip(x) if hasattr(self, "skip") else x)


def pixel_shuffle_3d(x: torch.Tensor, s: int) -> torch.Tensor:
    """NCDHW 3D pixel shuffle with channels (C', s, s, s), C' major."""
    b, c, d, h, w = x.shape
    c_ = c // s ** 3
    x = x.reshape(b, c_, s, s, s, d, h, w).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, c_, d * s, h * s, w * s)


class StructureDecoder(nn.Module):
    """16^3 latent (B, R^3, C) row-major -> (B, G, G, G) occupancy logits."""

    def __init__(self, cfg: SSDecoderConfig, latent_res: int = 16):
        super().__init__()
        self.cfg, self.latent_res = cfg, latent_res
        ch = cfg.channels
        self.input_layer = Conv3d(cfg.latent_channels, ch[0], 3, torch.float32)
        for m in range(cfg.num_res_blocks_middle):
            self.add_module(f"middle{m}", ResBlock3d(cfg, ch[0], ch[0]))
        for i, c in enumerate(ch):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"stage{i}_res{j}", ResBlock3d(cfg, c, c))
            if i < len(ch) - 1:
                self.add_module(f"stage{i}_up", Conv3d(c, ch[i + 1] * 8, 3, cfg.dtype))
        self.norm_out = channel_norm(cfg, ch[-1])
        self.out_layer = Conv3d(ch[-1], cfg.out_channels, 3, torch.float32)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        cfg, r = self.cfg, self.latent_res
        x = latent.reshape(latent.shape[0], r, r, r, cfg.latent_channels).permute(0, 4, 1, 2, 3)
        x = self.input_layer(x).to(cfg.dtype)
        for m in range(cfg.num_res_blocks_middle):
            x = getattr(self, f"middle{m}")(x)
        for i in range(len(cfg.channels)):
            for j in range(cfg.num_res_blocks):
                x = getattr(self, f"stage{i}_res{j}")(x)
            if i < len(cfg.channels) - 1:
                x = pixel_shuffle_3d(getattr(self, f"stage{i}_up")(x), 2)
        x = F.silu(self.norm_out(x.float()))
        return self.out_layer(x)[:, 0]


def decode_occupancy(logits: torch.Tensor, max_voxels: int, threshold: float = 0.0):
    """(B, G, G, G) logits -> the top `max_voxels` cells: coords
    (B, max_voxels, 3) int32 and valid (B, max_voxels) where above
    `threshold`. Cells are in descending logit order, equal logits by
    ascending flat index (`jax.lax.top_k`'s order)."""
    b, g = logits.shape[0], logits.shape[1]
    top, idx = torch.sort(logits.reshape(b, -1), dim=-1, descending=True, stable=True)
    top, idx = top[:, :max_voxels], idx[:, :max_voxels]
    coords = torch.stack([idx // (g * g), (idx // g) % g, idx % g], dim=-1).to(torch.int32)
    return coords, top > threshold
