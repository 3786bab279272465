"""SD-class conditional UNet.

Counterpart of `labelany3d_tpu/models/diffusion/unet.py`, Stable-Diffusion-
1.5-shaped: ResBlocks with timestep injection, transformer blocks (self and
cross attention on context tokens) at the attention levels, a stride-2
down/up path with skips. Activations in the config's dtype (bf16), norms in
float32, the output conv in float32 (zero-initialised, as the JAX
package's). `in_channels` serves txt2img (4) and image-conditioned editing
and Zero123 (8 = latent + image latent).

Public tensors are NHWC as in the JAX package; the convolutions run NCHW.
Attention is plain PyTorch (`layers.dense_attention`), as the JAX package
leaves it to XLA; the head dims are width / heads (40, 80 and 160 at the
SD-1.5 widths). The GEGLU feed-forward takes the tanh GELU of Flax's
`nn.gelu` (diffusers' is exact erf; ROADMAP.md F11).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.diffusion.vae import num_groups
from labelany3d_tpu_torch.models.layers import (
    Conv,
    Dense,
    GroupNorm32,
    LayerNorm32,
    dense_attention,
)
from labelany3d_tpu_torch.models.trellis.dit import timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    widths: Sequence[int] = (320, 640, 1280, 1280)
    # SD-1.5 layout: transformer blocks at down levels 0-2; the deepest
    # level (8x8 latents at 512 px) is conv-only.
    attn_levels: Sequence[int] = (0, 1, 2)
    num_res_blocks: int = 2
    num_heads: int = 8
    context_dim: int = 768
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test(**kw) -> "UNetConfig":
        return UNetConfig(widths=(16, 32), attn_levels=(1,), num_res_blocks=1, num_heads=2,
                          context_dim=16, **kw)


class ResBlock(nn.Module):
    """NCHW (B, C_in, H, W) and a (B, T) time embedding -> (B, C_out, H, W).
    GroupNorm eps 1e-5 (diffusers ResnetBlock2D)."""

    def __init__(self, c_in: int, out_ch: int, temb_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm32(num_groups(c_in), c_in, eps=1e-5)
        self.conv1 = Conv(c_in, out_ch, 3, dtype)
        self.temb_proj = Dense(temb_dim, out_ch, dtype)
        self.norm2 = GroupNorm32(num_groups(out_ch), out_ch, eps=1e-5)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype)
        if c_in != out_ch:
            self.skip = Conv(c_in, out_ch, 1, dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)).to(self.dtype))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)).to(self.dtype))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class TransformerBlock(nn.Module):
    """NCHW features and (B, M, context_dim) context -> NCHW: GroupNorm
    (eps 1e-6) -> 1x1 proj_in -> self attention -> cross attention (k, v
    straight from the context) -> GEGLU feed-forward -> 1x1 proj_out, with
    residuals; LayerNorms eps 1e-5 in float32."""

    def __init__(self, c: int, heads: int, context_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.heads = heads
        self.norm = GroupNorm32(num_groups(c), c, eps=1e-6)
        self.proj_in = Conv(c, c, 1, dtype)
        self.ln1 = LayerNorm32(c, eps=1e-5)
        self.ln2 = LayerNorm32(c, eps=1e-5)
        self.ln3 = LayerNorm32(c, eps=1e-5)
        for name, kv_dim in (("self", c), ("cross", context_dim)):
            self.add_module(f"{name}_q", Dense(c, c, dtype, bias=False))
            self.add_module(f"{name}_k", Dense(kv_dim, c, dtype, bias=False))
            self.add_module(f"{name}_v", Dense(kv_dim, c, dtype, bias=False))
            self.add_module(f"{name}_proj", Dense(c, c, dtype))
        self.geglu = Dense(c, c * 8, dtype)
        self.ff_out = Dense(c * 4, c, dtype)
        self.proj_out = Conv(c, c, 1, dtype)

    def _attn(self, q_in: torch.Tensor, kv_in: torch.Tensor, name: str) -> torch.Tensor:
        def heads(t):
            return t.reshape(*t.shape[:-1], self.heads, -1)

        m = lambda part: getattr(self, f"{name}_{part}")  # noqa: E731
        out = dense_attention(heads(m("q")(q_in)), heads(m("k")(kv_in)), heads(m("v")(kv_in)))
        return m("proj")(out.reshape(q_in.shape))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).to(self.dtype)).flatten(2).transpose(1, 2)  # (B, HW, C)
        tn = self.ln1(t).to(self.dtype)
        t = t + self._attn(tn, tn, "self")
        tn = self.ln2(t).to(self.dtype)
        t = t + self._attn(tn, context.to(self.dtype), "cross")
        tn = self.ln3(t).to(self.dtype)
        a, gate = self.geglu(tn).chunk(2, dim=-1)
        t = t + self.ff_out(a * F.gelu(gate, approximate="tanh"))
        t = t.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(t)


class UNet2D(nn.Module):
    """x (B, H, W, C_in) latents, t (B,) in [0, 1], context (B, M, D) ->
    (B, H, W, C_out) float32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        d, ws = cfg.dtype, list(cfg.widths)
        tdim = ws[0] * 4
        self.t1 = Dense(ws[0], tdim, d)
        self.t2 = Dense(tdim, tdim, d)
        self.in_conv = Conv(cfg.in_channels, ws[0], 3, d)
        skips, c = [ws[0]], ws[0]
        for lvl, width in enumerate(ws):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down{lvl}_res{i}", ResBlock(c, width, tdim, d))
                c = width
                if lvl in cfg.attn_levels:
                    self.add_module(f"down{lvl}_attn{i}",
                                    TransformerBlock(c, cfg.num_heads, cfg.context_dim, d))
                skips.append(c)
            if lvl < len(ws) - 1:
                # torch Conv2d(k=3, s=2, p=1): padding (1, 1).
                self.add_module(f"down{lvl}_ds", Conv(c, c, 3, d, stride=2, padding=1))
                skips.append(c)
        self.mid_res1 = ResBlock(c, c, tdim, d)
        self.mid_attn = TransformerBlock(c, cfg.num_heads, cfg.context_dim, d)
        self.mid_res2 = ResBlock(c, c, tdim, d)
        for lvl in reversed(range(len(ws))):
            width = ws[lvl]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up{lvl}_res{i}", ResBlock(c + skips.pop(), width, tdim, d))
                c = width
                if lvl in cfg.attn_levels:
                    self.add_module(f"up{lvl}_attn{i}",
                                    TransformerBlock(c, cfg.num_heads, cfg.context_dim, d))
            if lvl > 0:
                self.add_module(f"up{lvl}_us", Conv(c, c, 3, d))
        self.norm_out = GroupNorm32(num_groups(c), c, eps=1e-5)
        self.out_conv = Conv(c, cfg.out_channels, 3, torch.float32)
        self.out_conv.zero_init = True

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        d = cfg.dtype
        temb = self.t1(timestep_embedding(t, cfg.widths[0]).to(d))
        temb = self.t2(F.silu(temb))
        h = self.in_conv(x.permute(0, 3, 1, 2))
        skips = [h]
        for lvl in range(len(cfg.widths)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down{lvl}_res{i}")(h, temb)
                if lvl in cfg.attn_levels:
                    h = getattr(self, f"down{lvl}_attn{i}")(h, context)
                skips.append(h)
            if lvl < len(cfg.widths) - 1:
                h = getattr(self, f"down{lvl}_ds")(h)
                skips.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb), context), temb)
        for lvl in reversed(range(len(cfg.widths))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up{lvl}_res{i}")(torch.cat([h, skips.pop()], dim=1), temb)
                if lvl in cfg.attn_levels:
                    h = getattr(self, f"up{lvl}_attn{i}")(h, context)
            if lvl > 0:
                h = getattr(self, f"up{lvl}_us")(F.interpolate(h, scale_factor=2,
                                                               mode="nearest"))
        h = F.silu(self.norm_out(h))
        return self.out_conv(h).permute(0, 2, 3, 1)


@torch.no_grad()
def init_unet_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's initialisers (`init_params_`), then zeros for the layers the
    JAX package zero-initialises (the UNet's `out_conv`)."""
    from labelany3d_tpu_torch.models.weights import init_params_

    init_params_(model, gen)
    for m in model.modules():
        if getattr(m, "zero_init", False):
            m.weight.zero_()
            m.bias.zero_()
    return model
