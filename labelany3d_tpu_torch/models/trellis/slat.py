"""Structured-latent (SLat) flow model over active voxels.

Counterpart of `labelany3d_tpu/models/trellis/slat.py` (TRELLIS
`SLatFlowModel`): a sparse UNet (`SparseResBlock3d` stages with 2x
down/upsampling and skip concatenation) around a modulated cross-attention
DiT torso over the pooled voxels. Voxels ride fixed slots with a valid mask;
the convs are `ops/sparse_conv.py`'s submanifold conv, the pooling its
`sparse_pool_pair` / `sparse_unpool`, and the torso runs masked attention
(`("masked", valid)`, K2 with segment ids on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Dense, LayerNorm32, layer_norm
from labelany3d_tpu_torch.models.trellis.dit import (
    AdaLNModulation,
    DiTBlock,
    DiTConfig,
    TimestepEmbedder,
    ape_3d,
)
from labelany3d_tpu_torch.ops.sparse_conv import (
    sparse_pool_pair,
    sparse_unpool,
    subm_sparse_conv3d,
)


@dataclasses.dataclass(frozen=True)
class SLatConfig:
    """SLat flow hyperparameters (slat_flow_img_dit_L_64l8p2 shapes)."""

    resolution: int = 64
    latent_channels: int = 8
    out_channels: int = 8
    io_block_channels: Sequence[int] = (128,)
    num_io_res_blocks: int = 2
    use_skip_connection: bool = True
    dit: DiTConfig = dataclasses.field(default_factory=lambda: DiTConfig(qk_rms_norm=True))
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "SLatConfig":
        return SLatConfig(resolution=16, latent_channels=4, out_channels=4,
                          io_block_channels=(8,), num_io_res_blocks=2, dit=DiTConfig.tiny_test())


class SparseConv3d(nn.Module):
    """Submanifold sparse conv (spconv SubMConv3d's role) over a batch of
    slot sets. `weight` keeps the Flax layout (K, K, K, Cin, Cout), which the
    gathers read; `bias` (Cout,)."""

    keeps_flax_kernel = True

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, zero_init: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel, kernel, kernel, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.zero_init = zero_init

    def reset_parameters_(self, gen: torch.Generator) -> None:
        """Flax's init: lecun-normal kernel (fan-in K^3 Cin), or zeros."""
        from labelany3d_tpu_torch.models.weights import _lecun_normal_

        with torch.no_grad():
            self.bias.zero_()
            if self.zero_init:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, gen, math.prod(self.weight.shape[:-1]))

    def forward(self, feats, coords, valid, grid_size: int):
        return torch.stack([subm_sparse_conv3d(feats[b], coords[b], valid[b], self.weight,
                                               self.bias, grid_size=grid_size)
                            for b in range(feats.shape[0])])


class SparseResBlock3d(nn.Module):
    """Affine LN -> SiLU -> conv -> (non-affine LN * (1 + scale) + shift from
    the t embedding) -> SiLU -> zero-init conv, plus a linear skip when the
    width changes. Up/downsampling is the caller's, before this body."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.emb = Dense(emb_dim, 2 * out_channels, torch.float32)
        self.norm1 = LayerNorm32(channels)
        self.conv1 = SparseConv3d(channels, out_channels)
        self.conv2 = SparseConv3d(out_channels, out_channels, zero_init=True)
        if out_channels != channels:
            self.skip = Dense(channels, out_channels, dtype)

    def forward(self, feats, coords, valid, t_emb, grid_size: int):
        scale, shift = self.emb(F.silu(t_emb.float())).chunk(2, dim=-1)
        h = self.conv1(F.silu(self.norm1(feats)).to(self.dtype), coords, valid, grid_size)
        h = layer_norm(h, 1e-6) * (1 + scale[:, None, :]) + shift[:, None, :]
        h = self.conv2(F.silu(h).to(self.dtype), coords, valid, grid_size)
        return h + (self.skip(feats) if hasattr(self, "skip") else feats)


def _pool_pair(h, coords, valid, grid_size):
    """`sparse_pool_pair` (factor 2) over the batch."""
    outs = [sparse_pool_pair(h[b], coords[b], valid[b], 2, grid_size) for b in range(h.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


class SLatFlowModel(nn.Module):
    """Velocity over per-voxel latents: feats (B, N, C), coords (B, N, 3) or
    (N, 3), valid (B, N) or (N,), t (B,) scaled by 1000, cond (B, M, D) ->
    (B, N, C), invalid slots 0.

    `torso_slots` caps the slots entering the DiT torso: `sparse_pool_pair`
    puts the parents at the front, so slicing to the real parent count
    (bucketed by `TrellisPipeline.slat_buckets`) cuts the torso's work; an
    under-budgeted call unpools the lost parents' children to zero."""

    def __init__(self, cfg: SLatConfig):
        super().__init__()
        self.cfg = cfg
        dit = cfg.dit
        io = list(cfg.io_block_channels)
        self.input_layer = Dense(cfg.latent_channels, io[0], dit.dtype)
        self.t_embedder = TimestepEmbedder(dit.width)
        if dit.share_mod:
            self.adaln = AdaLNModulation(dit.width)
        bi = 0
        for chs, next_chs in zip(io, io[1:] + [dit.width]):
            for _ in range(cfg.num_io_res_blocks - 1):
                self.add_module(f"in{bi}", SparseResBlock3d(chs, chs, dit.width, dit.dtype))
                bi += 1
            self.add_module(f"in{bi}", SparseResBlock3d(chs, next_chs, dit.width, dit.dtype))
            bi += 1
        for i in range(dit.depth):
            self.add_module(f"block{i}", DiTBlock(dit))
        bo = 0
        skip = 2 if cfg.use_skip_connection else 1
        for chs, prev_chs in zip(reversed(io), [dit.width] + list(reversed(io[1:]))):
            self.add_module(f"out{bo}", SparseResBlock3d(prev_chs * skip, chs, dit.width,
                                                         dit.dtype))
            bo += 1
            for _ in range(cfg.num_io_res_blocks - 1):
                self.add_module(f"out{bo}", SparseResBlock3d(chs * skip, chs, dit.width,
                                                             dit.dtype))
                bo += 1
        self.out_layer = Dense(io[0], cfg.out_channels, torch.float32)
        self.out_layer.zero_init = True

    def forward(self, feats, coords, valid, t, cond_tokens, torso_slots: int | None = None):
        cfg = self.cfg
        dit = cfg.dit
        b = feats.shape[0]
        coords = coords if coords.dim() == 3 else coords.expand(b, *coords.shape)
        valid = valid if valid.dim() == 2 else valid.expand(b, *valid.shape)
        io = list(cfg.io_block_channels)
        h = self.input_layer(feats)
        t_emb = self.t_embedder(t)
        mods = self.adaln(t_emb) if dit.share_mod else None

        gs = cfg.resolution
        cur_coords, cur_valid = coords, valid
        skips, levels = [], []  # levels: (fine coords, fine valid, fine grid, child2parent)
        bi = 0
        for li in range(len(io)):
            for _ in range(cfg.num_io_res_blocks - 1):
                h = getattr(self, f"in{bi}")(h, cur_coords, cur_valid, t_emb, gs)
                skips.append(h)
                bi += 1
            fine = (cur_coords, cur_valid, gs)
            h, cur_coords, cur_valid, c2p = _pool_pair(h, cur_coords, cur_valid, gs)
            if li == len(io) - 1 and torso_slots and torso_slots < h.shape[1]:
                h = h[:, :torso_slots]
                cur_coords = cur_coords[:, :torso_slots]
                cur_valid = cur_valid[:, :torso_slots]
            levels.append((*fine, c2p))
            gs //= 2
            h = getattr(self, f"in{bi}")(h, cur_coords, cur_valid, t_emb, gs)
            skips.append(h)
            bi += 1

        h = h + ape_3d(cur_coords, dit.width).to(dit.dtype)
        spec = ("masked", cur_valid)
        cond_tokens = cond_tokens.to(dit.dtype)
        for i in range(dit.depth):
            h = getattr(self, f"block{i}")(h, t_emb=t_emb, cond_tokens=cond_tokens,
                                           attn_spec=spec, mods=mods)

        bo = 0
        for _ in range(len(io)):
            # Concatenate the level's skip, unpool to the finer level, then
            # the res bodies there.
            skip = skips.pop()
            if cfg.use_skip_connection:
                h = torch.cat([h, skip], dim=-1)
            cur_coords, cur_valid, gs, c2p = levels.pop()
            h = torch.stack([sparse_unpool(h[i], c2p[i]) for i in range(b)])
            h = getattr(self, f"out{bo}")(h, cur_coords, cur_valid, t_emb, gs)
            bo += 1
            for _ in range(cfg.num_io_res_blocks - 1):
                skip = skips.pop()
                if cfg.use_skip_connection:
                    h = torch.cat([h, skip], dim=-1)
                h = getattr(self, f"out{bo}")(h, cur_coords, cur_valid, t_emb, gs)
                bo += 1

        v = self.out_layer(layer_norm(h, 1e-5))
        return torch.where(valid[..., None], v, torch.zeros_like(v))
