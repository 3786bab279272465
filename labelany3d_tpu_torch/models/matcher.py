"""Two-view correspondence model (MASt3R-like), PyTorch.

Counterpart of `labelany3d_tpu/models/matcher.py` with the `pixelshuffle`
head: a shared ViT encoder over both views (K1 in every layer), two
cross-attending decoder streams with 2D RoPE whose self- and
cross-attention run `ops.attention.flash_sdpa` (K2), and per-view heads that
predict a 3D point map, a confidence and an L2-normalised descriptor map.
The descriptors feed `ops.reciprocal_nn.reciprocal_nn_match` (K3).

Module names follow the Flax tree (`dec0_block{i}.self_q`, `head0.proj`,
...), so `models/weights.py` carries a `TwoViewMatcher` parameter tree
across one to one. The checkpoint-faithful `catmlpdpt` head and the rope
encoder of `MatcherConfig.mast3r_vitl` are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Dense, LayerNorm32, resize_bilinear
from labelany3d_tpu_torch.models.vit import Mlp, ViT, ViTConfig
from labelany3d_tpu_torch.ops.attention import flash_sdpa
from labelany3d_tpu_torch.ops.reciprocal_nn import MatchResult, reciprocal_nn_match
from labelany3d_tpu_torch.ops.rope2d import apply_rope_2d, rope_2d_freqs


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    encoder: ViTConfig = dataclasses.field(default_factory=ViTConfig.large)
    dec_width: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    desc_dim: int = 24
    dtype: torch.dtype = torch.bfloat16
    head_style: str = "pixelshuffle"

    @staticmethod
    def tiny_test() -> "MatcherConfig":
        return MatcherConfig(encoder=ViTConfig.tiny_test(), dec_width=64, dec_depth=2,
                             dec_heads=2, desc_dim=8)


class CrossBlock(nn.Module):
    """Decoder block: self-attention, cross-attention to the other view, MLP;
    RoPE rotates the queries and keys of both attentions."""

    def __init__(self, cfg: MatcherConfig):
        super().__init__()
        w, dt = cfg.dec_width, cfg.dtype
        self.cfg = cfg
        for name in ("self", "cross"):
            for part in ("q", "k", "v", "proj"):
                setattr(self, f"{name}_{part}", Dense(w, w, dt))
        self.norm1 = LayerNorm32(w)
        self.norm2 = LayerNorm32(w)
        self.norm_other = LayerNorm32(w)
        self.norm3 = LayerNorm32(w)
        self.mlp = Mlp(ViTConfig(width=w, depth=1, num_heads=cfg.dec_heads, dtype=dt))

    def _attn(self, name: str, q_tokens, kv_tokens, rope):
        cfg = self.cfg
        d = cfg.dec_width // cfg.dec_heads

        def heads(t):
            return t.reshape(*t.shape[:-1], cfg.dec_heads, d)

        q = heads(getattr(self, f"{name}_q")(q_tokens))
        k = heads(getattr(self, f"{name}_k")(kv_tokens))
        v = heads(getattr(self, f"{name}_v")(kv_tokens))
        # RoPE in float32, then back to the compute dtype (matcher.py:107-108).
        q = apply_rope_2d(q.float(), *rope).to(cfg.dtype)
        k = apply_rope_2d(k.float(), *rope).to(cfg.dtype)
        out = flash_sdpa(q, k, v).reshape(*q_tokens.shape[:-1], cfg.dec_width)
        return getattr(self, f"{name}_proj")(out)

    def forward(self, x, other, rope):
        dt = self.cfg.dtype
        h = self.norm1(x).to(dt)
        x = x + self._attn("self", h, h, rope)
        h = self.norm2(x).to(dt)
        ho = self.norm_other(other).to(dt)
        x = x + self._attn("cross", h, ho, rope)
        return x + self.mlp(self.norm3(x).to(dt))


class MatcherHead(nn.Module):
    """Tokens -> per-pixel (pts3d, conf, desc) maps: a float32 linear
    projection to patch^2 x channels, pixel unshuffle, bilinear resize to
    the image size."""

    def __init__(self, cfg: MatcherConfig, patch: int):
        super().__init__()
        self.patch = patch
        self.channels = 4 + cfg.desc_dim  # xyz + conf + desc
        self.proj = Dense(cfg.dec_width, patch * patch * self.channels, torch.float32)

    def forward(self, tokens, grid, out_hw):
        gh, gw = grid
        p, ch = self.patch, self.channels
        b = tokens.shape[0]
        x = self.proj(tokens.float()).reshape(b, gh, gw, p, p, ch)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, ch)
        if (gh * p, gw * p) != tuple(out_hw):
            # Upsampling: half-pixel bilinear equals jax.image.resize's.
            x = resize_bilinear(x.permute(0, 3, 1, 2), tuple(out_hw)).permute(0, 2, 3, 1)
        pts = x[..., :3]
        conf = F.softplus(x[..., 3])
        desc = x[..., 4:]
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return pts, conf, desc


class TwoViewMatcher(nn.Module):
    """Shared encoder + two decoder streams + per-view heads.

    `grid` is the encoder's token grid (image size // patch)."""

    def __init__(self, cfg: MatcherConfig, grid: tuple[int, int]):
        super().__init__()
        if cfg.head_style != "pixelshuffle":
            raise NotImplementedError(f"head_style {cfg.head_style!r} is not ported yet")
        self.cfg = cfg
        self.encoder = ViT(cfg.encoder, grid)
        self.dec_embed = Dense(cfg.encoder.width, cfg.dec_width, cfg.dtype)
        for i in range(cfg.dec_depth):
            self.add_module(f"dec0_block{i}", CrossBlock(cfg))
            self.add_module(f"dec1_block{i}", CrossBlock(cfg))
        self.dec_norm = LayerNorm32(cfg.dec_width)
        self.head0 = MatcherHead(cfg, cfg.encoder.patch_size)
        self.head1 = MatcherHead(cfg, cfg.encoder.patch_size)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                ref_index: torch.Tensor | None = None) -> dict:
        """img0 (R, H, W, 3), img1 (P, H, W, 3) -> per-view maps of P pairs.

        Pair p matches img1[p] against img0[ref_index[p]]; without
        `ref_index`, a batch-1 img0 is broadcast to every img1 row, and
        otherwise pairs are row by row. The encoder runs R + P rows once."""
        cfg = self.cfg
        b, h, w, _ = img0.shape
        b1 = img1.shape[0]
        enc = self.encoder(torch.cat([img0, img1], dim=0))
        gh, gw = enc["grid"]
        t0, t1 = enc["tokens"][:b], enc["tokens"][b:]
        if ref_index is not None:
            t0 = t0[torch.as_tensor(ref_index, device=t0.device).long()]
        elif b == 1 and b1 > 1:
            t0 = t0.expand(b1, *t0.shape[1:])

        x0, x1 = self.dec_embed(t0), self.dec_embed(t1)
        ys = torch.arange(gh, device=x0.device)
        xs = torch.arange(gw, device=x0.device)
        pos = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(1, gh * gw, 2)
        rope = rope_2d_freqs(cfg.dec_width // cfg.dec_heads, pos)
        for i in range(cfg.dec_depth):
            blk0, blk1 = getattr(self, f"dec0_block{i}"), getattr(self, f"dec1_block{i}")
            x0, x1 = blk0(x0, x1, rope), blk1(x1, x0, rope)
        x0 = self.dec_norm(x0).to(cfg.dtype)
        x1 = self.dec_norm(x1).to(cfg.dtype)
        pts0, conf0, desc0 = self.head0(x0, (gh, gw), (h, w))
        pts1, conf1, desc1 = self.head1(x1, (gh, gw), (h, w))
        return {"pts3d0": pts0, "conf0": conf0, "desc0": desc0,
                "pts3d1": pts1, "conf1": conf1, "desc1": desc1}


def match_images(model: TwoViewMatcher, img0: torch.Tensor, img1: torch.Tensor,
                 subsample: int = 8) -> MatchResult:
    """Matcher + reciprocal NN on one (H, W, 3) image pair."""
    if img0.dim() != 3 or img1.dim() != 3:
        raise ValueError(f"match_images takes unbatched (H, W, 3) images; got "
                         f"{tuple(img0.shape)} / {tuple(img1.shape)}")
    out = model(img0[None], img1[None])
    return reciprocal_nn_match(out["desc0"][0], out["desc1"][0], subsample=subsample)
