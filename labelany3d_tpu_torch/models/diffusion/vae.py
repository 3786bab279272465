"""SD-class KL autoencoder: images <-> 4-channel latents at 1/8 resolution.

Counterpart of `labelany3d_tpu/models/diffusion/vae.py`, graph-compatible
with diffusers' `AutoencoderKL` (SD-1.x): conv_in, per-level resnet pairs
with stride-2 downsamplers padded (0, 1) on the right and bottom, a mid
block with single-head spatial attention, quant/post_quant 1x1 convs.
Released weights convert through `convert.convert_sd_vae`. Public tensors
are NHWC, as in the JAX package; the convolutions run NCHW. GroupNorms
take Flax's default epsilon 1e-6 and run in float32, as do `out`,
`quant` and `post_quant`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, Dense, GroupNorm32, dense_attention

SD_LATENT_SCALE = 0.18215  # SD convention: latents multiplied by this


def num_groups(ch: int, target: int = 32) -> int:
    """Largest group count <= target dividing ch (GroupNorm constraint)."""
    g = min(target, ch)
    while ch % g:
        g -= 1
    return g


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    widths: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test(**kw) -> "VAEConfig":
        return VAEConfig(widths=(8, 16), layers_per_block=1, **kw)


class _Res(nn.Module):
    """diffusers ResnetBlock2D without time embedding (VAE flavour, eps 1e-6)."""

    def __init__(self, c_in: int, ch: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.n1 = GroupNorm32(num_groups(c_in), c_in, eps=1e-6)
        self.c1 = Conv(c_in, ch, 3, dtype)
        self.n2 = GroupNorm32(num_groups(ch), ch, eps=1e-6)
        self.c2 = Conv(ch, ch, 3, dtype)
        if c_in != ch:
            self.skip = Conv(c_in, ch, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c1(F.silu(self.n1(x)).to(self.dtype))
        h = self.c2(F.silu(self.n2(h)).to(self.dtype))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class _MidAttn(nn.Module):
    """Single-head spatial self-attention (diffusers VAE mid attention:
    GroupNorm, biased q/k/v/out projections, residual add), attention in
    float32."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.gn = GroupNorm32(num_groups(c), c, eps=1e-6)
        self.q, self.k, self.v, self.proj = (Dense(c, c, dtype) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.gn(x).flatten(2).transpose(1, 2).to(self.dtype)  # (B, HW, C)
        q, k, v = (m(t)[:, :, None] for m in (self.q, self.k, self.v))
        t = self.proj(dense_attention(q, k, v)[:, :, 0].to(self.dtype))
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class Encoder(nn.Module):
    """(B, H, W, 3) in [-1, 1] -> (mean, logvar), each (B, H/f, W/f, C)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        d, ws = cfg.dtype, cfg.widths
        self.add_module("in", Conv(3, ws[0], 3, d))
        c = ws[0]
        for i, w in enumerate(ws):
            for r in range(cfg.layers_per_block):
                self.add_module(f"res{i}_{r}", _Res(c, w, d))
                c = w
            if i < len(ws) - 1:
                self.add_module(f"ds{i}", Conv(w, w, 3, d, stride=2, padding=0))
        self.mid_res1 = _Res(c, c, d)
        self.mid_attn = _MidAttn(c, d)
        self.mid_res2 = _Res(c, c, d)
        self.n_out = GroupNorm32(num_groups(c), c, eps=1e-6)
        self.out = Conv(c, 2 * cfg.latent_channels, 3, torch.float32)
        self.quant = Conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, torch.float32)

    def forward(self, images: torch.Tensor):
        cfg = self.cfg
        h = getattr(self, "in")(images.permute(0, 3, 1, 2))
        for i in range(len(cfg.widths)):
            for r in range(cfg.layers_per_block):
                h = getattr(self, f"res{i}_{r}")(h)
            if i < len(cfg.widths) - 1:
                # diffusers Downsample2D: pad right/bottom by 1, VALID stride 2.
                h = getattr(self, f"ds{i}")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
        moments = self.quant(self.out(F.silu(self.n_out(h))))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30, 20)


class Decoder(nn.Module):
    """(B, h, w, C) latents -> (B, h*f, w*f, 3) float32 images."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        d, ws = cfg.dtype, cfg.widths
        lc = cfg.latent_channels
        self.post_quant = Conv(lc, lc, 1, torch.float32)
        self.add_module("in", Conv(lc, ws[-1], 3, d))
        c = ws[-1]
        self.mid_res1 = _Res(c, c, d)
        self.mid_attn = _MidAttn(c, d)
        self.mid_res2 = _Res(c, c, d)
        for j, w in enumerate(reversed(ws)):
            for r in range(cfg.layers_per_block + 1):
                self.add_module(f"res{j}_{r}", _Res(c, w, d))
                c = w
            if j < len(ws) - 1:
                self.add_module(f"us{j}", Conv(w, w, 3, d))
        self.n_out = GroupNorm32(num_groups(c), c, eps=1e-6)
        self.out = Conv(c, 3, 3, torch.float32)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = getattr(self, "in")(self.post_quant(latents.permute(0, 3, 1, 2)))
        h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
        for j in range(len(cfg.widths)):
            for r in range(cfg.layers_per_block + 1):
                h = getattr(self, f"res{j}_{r}")(h)
            if j < len(cfg.widths) - 1:
                h = getattr(self, f"us{j}")(F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.out(F.silu(self.n_out(h))).permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):
    """Paired encoder/decoder with SD latent scaling.

    `scaling_factor` defaults to SD-1.x's 0.18215. `encode(scale=False)`
    returns the raw posterior mean (or sample). Parameters load as
    `{"encoder": ..., "decoder": ...}` Flax trees."""

    def __init__(self, cfg: VAEConfig | None = None, scaling_factor: float = SD_LATENT_SCALE):
        super().__init__()
        self.cfg = cfg or VAEConfig()
        self.encoder = Encoder(self.cfg)
        self.decoder = Decoder(self.cfg)
        self.scaling_factor = scaling_factor

    @property
    def latent_factor(self) -> int:
        return 2 ** (len(self.cfg.widths) - 1)

    def encode(self, images: torch.Tensor, noise: torch.Tensor | None = None,
               scale: bool = True) -> torch.Tensor:
        """Images (B, H, W, 3) in [-1, 1] -> latents. With `noise` (a
        standard normal draw of the latents' shape), the posterior sample
        mean + exp(logvar / 2) * noise; else the mean."""
        mean, logvar = self.encoder(images)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.scaling_factor if scale else mean

    def decode(self, latents: torch.Tensor, scale: bool = True) -> torch.Tensor:
        if scale:
            latents = latents / self.scaling_factor
        return self.decoder(latents)
