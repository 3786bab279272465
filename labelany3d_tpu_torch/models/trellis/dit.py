"""DiT primitives for the image->3D flow models (dense 3D and sparse voxel).

Counterpart of `labelany3d_tpu/models/trellis/dit.py`, checkpoint-faithful to
TRELLIS's transformer modules (`ModulatedTransformerCrossBlock`,
`TransformerBlock`, `MultiHeadAttention`, `TimestepEmbedder`,
`AbsolutePositionEmbedder`). Module names follow the Flax tree (`self_attn.q`,
`adaln.mod`, `mlp.fc1`), so `models/weights.py` carries parameters across.

Dense attention, and attention with masked keys (`("masked", valid)`), run
through `ops.attention.flash_sdpa` (K2 on the card); the windowed and
serialized sparse modes through `ops.attention`'s plain versions.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Dense, LayerNorm32, layer_norm
from labelany3d_tpu_torch.ops.attention import (
    flash_sdpa,
    serialized_attention,
    windowed_attention_3d,
)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Transformer-torso hyperparameters shared by the flow models."""

    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    cond_dim: int = 1024           # image-conditioning token dim (DINOv2)
    qk_rms_norm: bool = False      # per-head RMS norm on self-attn q/k
    qk_rms_norm_cross: bool = False
    share_mod: bool = False        # one adaLN modulation shared by all blocks
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test(**kw) -> "DiTConfig":
        return DiTConfig(width=36, depth=2, num_heads=2, cond_dim=16, **kw)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] (glide convention). `t` is
    already scaled (the samplers pass 1000 * t)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[..., None].float() * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """256-dim sinusoid -> Linear -> SiLU -> Linear (t_embedder.mlp.{0,2})."""

    def __init__(self, width: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.fc1 = Dense(freq_dim, width, torch.float32)
        self.fc2 = Dense(width, width, torch.float32)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(timestep_embedding(t, self.freq_dim))))


def ape_3d(coords: torch.Tensor, channels: int) -> torch.Tensor:
    """Absolute sinusoidal position embedding of (..., 3) coordinates:
    [sin(x) | cos(x) | sin(y) | cos(y) | sin(z) | cos(z)] per point with
    freq_dim = channels // 6 frequencies 10000^-(i/freq_dim), zero-padded
    to `channels`. Float32."""
    in_ch = coords.shape[-1]
    freq_dim = channels // in_ch // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(freq_dim, dtype=torch.float32,
                                            device=coords.device) / freq_dim))
    x = coords[..., None].float() * freqs                      # (..., 3, fd)
    emb = torch.cat([torch.sin(x), torch.cos(x)], dim=-1)      # (..., 3, 2fd)
    emb = emb.reshape(*coords.shape[:-1], in_ch * 2 * freq_dim)
    return F.pad(emb, (0, channels - emb.shape[-1]))


class MultiHeadRMSNorm(nn.Module):
    """Per-head RMS q/k norm: normalize(x) * gamma * sqrt(head_dim)."""

    def __init__(self, head_dim: int, num_heads: int):
        super().__init__()
        self.head_dim = head_dim
        self.gamma = nn.Parameter(torch.ones(num_heads, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) + 1e-12)
        return (normed * self.gamma.float() * self.head_dim ** 0.5).to(x.dtype)


def _per_instance(fn, qh, kh, vh, coords, valid):
    """Apply a one-instance sparse attention over the batch."""
    return torch.stack([fn(qh[b], kh[b], vh[b], coords[b], valid[b])
                        for b in range(qh.shape[0])])


def run_attention(qh, kh, vh, attn_spec=None):
    """Heads (B, N, H, D) through the mode `attn_spec` selects:

      None                                  dense attention (K2)
      ("masked", valid)                     invalid keys masked (K2, segment ids)
      ("windowed", coords, valid, shift, grid, window)   3D swin windows
      ("serialized", coords, valid, shift, window)       space-filling curve
    """
    if attn_spec is None:
        return flash_sdpa(qh, kh, vh)
    mode = attn_spec[0]
    if mode == "masked":
        valid = attn_spec[1]
        return flash_sdpa(qh, kh, vh, segment_ids=(~valid).to(torch.int32))
    if mode == "windowed":
        _, coords, valid, shift, grid, window = attn_spec
        return _per_instance(lambda q, k, v, c, m: windowed_attention_3d(
            q, k, v, c, m, grid_size=grid, window_size=window, shift=shift),
            qh, kh, vh, coords, valid)
    if mode == "serialized":
        _, coords, valid, shift, window = attn_spec
        return _per_instance(lambda q, k, v, c, m: serialized_attention(
            q, k, v, c, m, window_size=window, shift=shift), qh, kh, vh, coords, valid)
    raise ValueError(f"unknown attention mode {mode}")


class Attention(nn.Module):
    """MultiHeadAttention: separate q/k/v projections (the converter splits
    the fused torch to_qkv / to_kv), optional per-head RMS norm, output
    projection. Cross-attention reads keys and values from `context` of
    width `cfg.cond_dim`."""

    def __init__(self, cfg: DiTConfig, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        w, hd = cfg.width, cfg.width // cfg.num_heads
        src = cfg.cond_dim if cross else w
        self.q = Dense(w, w, cfg.dtype)
        self.k = Dense(src, w, cfg.dtype)
        self.v = Dense(src, w, cfg.dtype)
        if cfg.qk_rms_norm_cross if cross else cfg.qk_rms_norm:
            self.q_rms = MultiHeadRMSNorm(hd, cfg.num_heads)
            self.k_rms = MultiHeadRMSNorm(hd, cfg.num_heads)
        self.proj = Dense(w, w, cfg.dtype)

    def forward(self, x, context=None, attn_spec=None):
        cfg = self.cfg
        src = x if context is None else context

        def heads(t):
            return t.reshape(*t.shape[:-1], cfg.num_heads, cfg.width // cfg.num_heads)

        qh, kh, vh = heads(self.q(x)), heads(self.k(src)), heads(self.v(src))
        if hasattr(self, "q_rms"):
            qh, kh = self.q_rms(qh), self.k_rms(kh)
        out = run_attention(qh, kh, vh, attn_spec)
        return self.proj(out.reshape(*x.shape[:-1], cfg.width))


class FeedForward(nn.Module):
    """Linear -> tanh-GELU -> Linear (mlp.mlp.{0,2})."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.fc1 = Dense(cfg.width, hidden, cfg.dtype)
        self.fc2 = Dense(hidden, cfg.width, cfg.dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class AdaLNModulation(nn.Module):
    """SiLU -> zero-initialised Linear(6 * width) (adaLN_modulation.{0,1});
    returns the six chunks."""

    def __init__(self, width: int):
        super().__init__()
        self.mod = Dense(width, 6 * width, torch.float32)
        self.mod.zero_init = True

    def forward(self, t_emb):
        return self.mod(F.silu(t_emb.float())).chunk(6, dim=-1)


class DiTBlock(nn.Module):
    """ModulatedTransformerCrossBlock: norm1 (non-affine) -> modulation ->
    self-attention -> gate; norm2 (affine) -> cross-attention (no gate);
    norm3 (non-affine) -> modulation -> MLP -> gate. With `cfg.share_mod`
    the six chunks come in through `mods`."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        if not cfg.share_mod:
            self.adaln = AdaLNModulation(cfg.width)
        self.self_attn = Attention(cfg)
        self.norm2 = LayerNorm32(cfg.width)
        self.cross_attn = Attention(cfg, cross=True)
        self.mlp = FeedForward(cfg)

    def forward(self, x, t_emb=None, cond_tokens=None, attn_spec=None, mods=None):
        dt = self.cfg.dtype
        if mods is None:
            mods = self.adaln(t_emb)
        shift_sa, scale_sa, gate_sa, shift_mlp, scale_mlp, gate_mlp = mods

        def mod(h, shift, scale):
            return (h * (1 + scale[..., None, :]) + shift[..., None, :]).to(dt)

        h = self.self_attn(mod(layer_norm(x, 1e-6), shift_sa, scale_sa), attn_spec=attn_spec)
        x = x + gate_sa[..., None, :] * h
        if cond_tokens is not None:
            x = x + self.cross_attn(self.norm2(x).to(dt), context=cond_tokens)
        h = self.mlp(mod(layer_norm(x, 1e-6), shift_mlp, scale_mlp))
        return x + gate_mlp[..., None, :] * h


class TransformerBlock(nn.Module):
    """Plain pre-LN block with non-affine norms (the SLat VAE decoders'
    `SparseTransformerBlock`)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg)
        self.mlp = FeedForward(cfg)

    def forward(self, x, attn_spec=None):
        dt = self.cfg.dtype
        x = x + self.attn(layer_norm(x, 1e-6).to(dt), attn_spec=attn_spec)
        return x + self.mlp(layer_norm(x, 1e-6).to(dt))
