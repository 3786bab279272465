# Frozen copy of labelany3d_tpu_torch/models/matcher.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py). Left
# out: `match_images` and the reciprocal-NN matching it calls (no cell trains them).
"""Two-view correspondence model (MASt3R-like), PyTorch.

Counterpart of `labelany3d_tpu/models/matcher.py`: a shared ViT encoder
over both views (learned positions with K1 in every layer, or CroCo's 2D
RoPE with K2, as in `MatcherConfig.mast3r_vitl`), two cross-attending
decoder streams with 2D RoPE whose self- and cross-attention run
`ops.attention.flash_sdpa` (K2), and per-view heads that predict a 3D point
map, a confidence and an L2-normalised descriptor map: the JAX package's
`pixelshuffle` head, or the released MASt3R head (`catmlpdpt`: a DPT branch
over the encoder and three decoder hooks for points and confidence, an MLP
+ pixel-shuffle branch for descriptors and their confidence).

Module names follow the Flax tree (`dec0_block{i}.self_q`, `head0.proj`,
`head0.refine1.res2.conv1`, ...), so `models/weights.py` carries a
`TwoViewMatcher` parameter tree across one to one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .attention import flash_sdpa
from .layers import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm32,
    resize,
)
from .rope2d import apply_rope_2d, rope_2d_freqs
from .vit import Mlp, ViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    encoder: ViTConfig = dataclasses.field(default_factory=ViTConfig.large)
    dec_width: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    desc_dim: int = 24
    dtype: torch.dtype = torch.bfloat16
    # 'pixelshuffle' = the JAX package's fast head; 'catmlpdpt' = the
    # released MASt3R head, so converted torch weights load 1:1.
    head_style: str = "pixelshuffle"
    # catmlpdpt hyperparameters (the released head factory's)
    feature_dim: int = 256
    last_dim: int = 128
    layer_dims: tuple = (96, 192, 384, 768)
    two_confs: bool = True
    conf_vmin: float = 1.0       # conf_mode ('exp', 1, inf)
    desc_conf_vmin: float = 0.0  # desc_conf_mode ('exp', 0, inf)

    @staticmethod
    def tiny_test() -> "MatcherConfig":
        return MatcherConfig(encoder=ViTConfig.tiny_test(), dec_width=64, dec_depth=2,
                             dec_heads=2, desc_dim=8)

    @staticmethod
    def tiny_catmlpdpt_test() -> "MatcherConfig":
        # The DPT resolution algebra needs a 16-px patch; the encoder mirrors
        # the CroCo checkpoint (rope, no class token, no LayerScale).
        return MatcherConfig(
            encoder=dataclasses.replace(ViTConfig.tiny_test(), patch_size=16,
                                        pos_embed="rope2d", use_class_token=False,
                                        layerscale_init=None),
            dec_width=32, dec_depth=4, dec_heads=2, desc_dim=8, head_style="catmlpdpt",
            feature_dim=16, last_dim=8, layer_dims=(8, 8, 8, 16))

    @staticmethod
    def mast3r_vitl() -> "MatcherConfig":
        """Shape of `MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric`: CroCo
        ViT-L/16 RoPE encoder, 12-block base decoder, catmlp+dpt head with
        24-wide descriptors."""
        return MatcherConfig(
            encoder=ViTConfig.large(patch_size=16, pos_embed="rope2d",
                                    use_class_token=False, layerscale_init=None),
            head_style="catmlpdpt")


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
            x = resize(x.permute(0, 3, 1, 2), tuple(out_hw)).permute(0, 2, 3, 1)
        pts = x[..., :3]
        conf = F.softplus(x[..., 3])
        desc = x[..., 4:]
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return pts, conf, desc


def _resize_bilinear_ac(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NCHW bilinear resize with `align_corners=True` (the DPT blocks' and
    the JAX package's `_resize_bilinear_ac`)."""
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


class _ResConvUnit(nn.Module):
    """DPT residual conv unit: ReLU-conv3 twice + identity."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(features, features, 3, dtype)
        self.conv2 = Conv(features, features, 3, dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _DPTFusion(nn.Module):
    """DPT feature fusion: optional skip through `res1`, `res2`, a 2x
    bilinear resize (align_corners=True), a 1x1 output conv. `refine4`
    takes no skip and has no `res1`."""

    def __init__(self, features: int, skip: bool, dtype: torch.dtype):
        super().__init__()
        if skip:
            self.res1 = _ResConvUnit(features, dtype)
        self.res2 = _ResConvUnit(features, dtype)
        self.out_conv = Conv(features, features, 1, dtype)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.res1(skip)
        x = self.res2(x)
        return self.out_conv(_resize_bilinear_ac(x, 2 * x.shape[2], 2 * x.shape[3]))


class CatMLPDPTHead(nn.Module):
    """The released MASt3R head: a DPT branch over [encoder tokens, three
    decoder hooks] regressing points and confidence, and an MLP +
    pixel-shuffle branch over cat(encoder, decoder) tokens giving
    descriptors and their confidence, post-processed as the release does
    (exp point and confidence modes, L2-normalised descriptors)."""

    def __init__(self, cfg: MatcherConfig, patch: int):
        super().__init__()
        self.cfg, self.patch = cfg, patch
        dt, ld, fd = cfg.dtype, cfg.layer_dims, cfg.feature_dim
        ew, dw = cfg.encoder.width, cfg.dec_width
        self.act0_proj = Conv(ew, ld[0], 1, dt)
        self.act0_deconv = ConvTranspose(ld[0], ld[0], 4, dt)
        self.act1_proj = Conv(dw, ld[1], 1, dt)
        self.act1_deconv = ConvTranspose(ld[1], ld[1], 2, dt)
        self.act2_proj = Conv(dw, ld[2], 1, dt)
        self.act3_proj = Conv(dw, ld[3], 1, dt)
        self.act3_conv = Conv(ld[3], ld[3], 3, dt, stride=2, padding=1)
        for i in range(4):
            self.add_module(f"rn{i}", Conv(ld[i], fd, 3, dt, bias=False))
        for k in range(1, 5):
            self.add_module(f"refine{k}", _DPTFusion(fd, skip=k != 4, dtype=dt))
        self.head_c1 = Conv(fd, fd // 2, 3, dt)
        self.head_c2 = Conv(fd // 2, cfg.last_dim, 3, dt)
        self.head_c3 = Conv(cfg.last_dim, 4, 1, torch.float32)
        idim = ew + dw
        self.n_out = cfg.desc_dim + int(cfg.two_confs)
        self.mlp_fc1 = Dense(idim, 4 * idim, dt)
        self.mlp_fc2 = Dense(4 * idim, self.n_out * patch * patch, dt)

    def forward(self, layers, enc_tokens, dec_tokens, grid, out_hw):
        cfg = self.cfg
        gh, gw = grid
        b = enc_tokens.shape[0]

        def g(t):  # (B, N, C) tokens -> NCHW
            return t.transpose(1, 2).reshape(b, t.shape[-1], gh, gw)

        l0 = self.act0_deconv(self.act0_proj(g(layers[0])))
        l1 = self.act1_deconv(self.act1_proj(g(layers[1])))
        l2 = self.act2_proj(g(layers[2]))
        l3 = self.act3_conv(self.act3_proj(g(layers[3])))
        rn = [getattr(self, f"rn{i}")(t) for i, t in enumerate((l0, l1, l2, l3))]
        # refine4's output cropped to layers[2]'s grid, as the release does.
        p4 = self.refine4(rn[3])[:, :, :rn[2].shape[2], :rn[2].shape[3]]
        p3 = self.refine3(p4, rn[2])
        p2 = self.refine2(p3, rn[1])
        p1 = self.refine1(p2, rn[0])
        h = self.head_c1(p1)
        h = self.head_c2(_resize_bilinear_ac(h, 2 * h.shape[2], 2 * h.shape[3]))
        pts_conf = self.head_c3(F.relu(h).float())

        p = self.patch
        cat = torch.cat([enc_tokens, dec_tokens], dim=-1)
        # Exact-erf GELU, as the port's ViT MLP (F1 in ROADMAP).
        feat = self.mlp_fc2(F.gelu(self.mlp_fc1(cat)))
        # torch pixel_shuffle layout: channel = c*p^2 + dy*p + dx.
        feat = feat.reshape(b, gh, gw, self.n_out, p, p).permute(0, 1, 4, 2, 5, 3)
        feat = feat.reshape(b, gh * p, gw * p, self.n_out)

        if pts_conf.shape[2:] != feat.shape[1:3]:
            pts_conf = resize(pts_conf, feat.shape[1:3])
        pts_conf = pts_conf.float().permute(0, 2, 3, 1)
        xyz = pts_conf[..., :3]
        d = xyz.norm(dim=-1, keepdim=True)
        pts = xyz / d.clamp_min(1e-8) * torch.expm1(d)
        conf = cfg.conf_vmin + torch.exp(pts_conf[..., 3])
        desc_raw = feat[..., :cfg.desc_dim].float()
        desc = desc_raw * torch.rsqrt((desc_raw * desc_raw).sum(-1, keepdim=True)
                                      .clamp_min(1e-16))
        if cfg.two_confs:
            desc_conf = cfg.desc_conf_vmin + torch.exp(feat[..., cfg.desc_dim].float())
        else:
            desc_conf = conf
        return pts, conf, desc, desc_conf


class TwoViewMatcher(nn.Module):
    """Shared encoder + two decoder streams + per-view heads.

    `grid` is the encoder's token grid (image size // patch)."""

    def __init__(self, cfg: MatcherConfig, grid: tuple[int, int]):
        super().__init__()
        if cfg.head_style not in ("pixelshuffle", "catmlpdpt"):
            raise ValueError(f"Unknown head_style: {cfg.head_style!r}")
        self.cfg = cfg
        self.encoder = ViT(cfg.encoder, grid)
        self.dec_embed = Dense(cfg.encoder.width, cfg.dec_width, cfg.dtype)
        for i in range(cfg.dec_depth):
            self.add_module(f"dec0_block{i}", CrossBlock(cfg))
            self.add_module(f"dec1_block{i}", CrossBlock(cfg))
        self.dec_norm = LayerNorm32(cfg.dec_width)
        head = CatMLPDPTHead if cfg.head_style == "catmlpdpt" else MatcherHead
        self.head0 = head(cfg, cfg.encoder.patch_size)
        self.head1 = head(cfg, cfg.encoder.patch_size)

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
        # DPT hooks over [enc, dec_1..dec_N] at [0, 2N/4, 3N/4, N]; the last
        # is the dec_norm-ed output.
        want = {cfg.dec_depth * 2 // 4, cfg.dec_depth * 3 // 4}
        hooks0, hooks1 = [t0], [t1]
        for i in range(cfg.dec_depth):
            blk0, blk1 = getattr(self, f"dec0_block{i}"), getattr(self, f"dec1_block{i}")
            x0, x1 = blk0(x0, x1, rope), blk1(x1, x0, rope)
            if i + 1 in want:
                hooks0.append(x0)
                hooks1.append(x1)
        x0 = self.dec_norm(x0).to(cfg.dtype)
        x1 = self.dec_norm(x1).to(cfg.dtype)
        if cfg.head_style == "catmlpdpt":
            pts0, conf0, desc0, dconf0 = self.head0([*hooks0, x0], t0, x0, (gh, gw), (h, w))
            pts1, conf1, desc1, dconf1 = self.head1([*hooks1, x1], t1, x1, (gh, gw), (h, w))
            return {"pts3d0": pts0, "conf0": conf0, "desc0": desc0, "desc_conf0": dconf0,
                    "pts3d1": pts1, "conf1": conf1, "desc1": desc1, "desc_conf1": dconf1}
        pts0, conf0, desc0 = self.head0(x0, (gh, gw), (h, w))
        pts1, conf1, desc1 = self.head1(x1, (gh, gw), (h, w))
        return {"pts3d0": pts0, "conf0": conf0, "desc0": desc0,
                "pts3d1": pts1, "conf1": conf1, "desc1": desc1}

