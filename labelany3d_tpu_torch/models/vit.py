"""DINOv2-style Vision Transformer encoder (PyTorch).

Counterpart of `labelany3d_tpu/models/vit.py`. Module names follow the Flax
tree (`block{i}.attn.qkv`, ...) so `models/weights.py` carries parameters
across one to one.

The token sequence is padded once to a multiple of 128. With learned
position embeddings every layer's attention runs through
`ops.attention.packed_sdpa` (K1) with `n_real`; with 2D rotary positions
(CroCo/MASt3R, `pos_embed='rope2d'`) q and k are rotated and attention runs
through `ops.attention.flash_sdpa` (K2), pad keys masked by segment ids.
Both run on every device, so the CPU path masks exactly as the kernels do.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, Dense, LayerNorm32, resize
from labelany3d_tpu_torch.ops.attention import flash_sdpa, packed_sdpa
from labelany3d_tpu_torch.ops.rope2d import apply_rope_2d, rope_2d_freqs, rope_pair


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    use_class_token: bool = True
    layerscale_init: float | None = 1e-5
    swiglu: bool = False            # DINOv2-giant's SwiGLU MLP (w12, w3)
    pos_embed: str = "learned"      # 'learned' | 'rope2d' (CroCo/MASt3R)
    dtype: torch.dtype = torch.bfloat16
    out_indices: Sequence[int] = ()
    # Apply the final LayerNorm to each intermediate output (DINOv2
    # get_intermediate_layers(norm=True); the MoGe checkpoint head needs it).
    norm_hiddens: bool = False
    # Grid of the learned pos_embed (e.g. (37, 37) for DINOv2-L/14 at 518);
    # None = the grid the model is built for. Another live grid resizes it.
    pos_grid: tuple | None = None

    @staticmethod
    def small(**kw) -> "ViTConfig":
        return ViTConfig(width=384, depth=12, num_heads=6, **kw)

    @staticmethod
    def base(**kw) -> "ViTConfig":
        return ViTConfig(width=768, depth=12, num_heads=12, **kw)

    @staticmethod
    def large(**kw) -> "ViTConfig":
        return ViTConfig(width=1024, depth=24, num_heads=16, **kw)

    @staticmethod
    def giant(**kw) -> "ViTConfig":
        return ViTConfig(width=1536, depth=40, num_heads=24, swiglu=True, **kw)

    @staticmethod
    def tiny_test(**kw) -> "ViTConfig":
        return ViTConfig(width=64, depth=2, num_heads=2, patch_size=8, **kw)


def swiglu_hidden(cfg: ViTConfig) -> int:
    """DINOv2's SwiGLU hidden width: 2/3 of the GELU MLP's, rounded up to
    a multiple of 8 (4096 at width 1536)."""
    return (int(int(cfg.width * cfg.mlp_ratio) * 2 / 3) + 7) // 8 * 8


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.swiglu = cfg.swiglu
        if cfg.swiglu:
            hidden = swiglu_hidden(cfg)
            self.w12 = Dense(cfg.width, 2 * hidden, cfg.dtype)
            self.w3 = Dense(hidden, cfg.width, cfg.dtype)
        else:
            hidden = int(cfg.width * cfg.mlp_ratio)
            self.fc1 = Dense(cfg.width, hidden, cfg.dtype)
            self.fc2 = Dense(hidden, cfg.width, cfg.dtype)

    def forward(self, x):
        if self.swiglu:
            x1, x2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(x1) * x2)
        # Exact-erf GELU on every dtype (the JAX package's bf16 tanh form
        # clamps inputs at 10; the port keeps the checkpoint's activation).
        return self.fc2(F.gelu(self.fc1(x)))

    @staticmethod
    def stacked(mlps, x: torch.Tensor) -> torch.Tensor:
        """`forward` of each of `mlps` (GELU ones) over its slice of x
        (S, ..., width), through `Dense.stacked`."""
        h = Dense.stacked([m.fc1 for m in mlps], x)
        return Dense.stacked([m.fc2 for m in mlps], F.gelu(h))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.qkv = Dense(cfg.width, 3 * cfg.width, cfg.dtype)
        self.proj = Dense(cfg.width, cfg.width, cfg.dtype)

    def forward(self, x, n_real: int, rope=None, seg=None):
        qkv = self.qkv(x).contiguous()
        if rope is None:
            return self.proj(packed_sdpa(qkv, self.num_heads, n_real))
        b, n, w3 = qkv.shape
        qk, v = qkv.view(b, n, 3, self.num_heads, w3 // 3 // self.num_heads).split([2, 1], 2)
        # RoPE in float32, then back to the compute dtype (vit.py:166-167);
        # q and k rotate as one tensor, and K2 reads them through strides.
        q, k = apply_rope_2d(qk.float(), *rope_pair(rope)).to(self.dtype).unbind(2)
        return self.proj(flash_sdpa(q, k, v.squeeze(2), segment_ids=seg).reshape(b, n, w3 // 3))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.norm1 = LayerNorm32(cfg.width)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm32(cfg.width)
        self.mlp = Mlp(cfg)
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(cfg.width, cfg.layerscale_init)
            self.ls2 = LayerScale(cfg.width, cfg.layerscale_init)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x, n_real: int, rope=None, seg=None):
        x = x + self.ls1(self.attn(self.norm1(x).to(self.dtype), n_real, rope, seg))
        return x + self.ls2(self.mlp(self.norm2(x).to(self.dtype)))


def _pad_to(n: int, multiple: int = 128) -> int:
    return -(-n // multiple) * multiple


class ViT(nn.Module):
    """Patchify -> prefix tokens + transformer; returns final and requested
    block outputs.

    Input: (B, H, W, 3) NHWC images. `grid` is the token grid of the inputs
    the model is built for; it sizes the learned pos-embed unless
    `cfg.pos_grid` does, and a live grid that differs resizes the embedding
    (`resize_pos_embed`). Output dict as in the JAX package: tokens
    (B, N, C), grid (gh, gw), hiddens [(B, N, C)] (outputs of the
    `out_indices` blocks, final-normed with `norm_hiddens`), all_prenorm
    (B, n_prefix + N, C), and cls (B, C) with a class token.
    """

    def __init__(self, cfg: ViTConfig, grid: tuple[int, int]):
        super().__init__()
        if cfg.pos_embed not in ("learned", "rope2d"):
            raise ValueError(f"Unknown pos_embed mode: {cfg.pos_embed}")
        self.cfg = cfg
        c = cfg.width
        self.patch_embed = Conv(3, c, cfg.patch_size, cfg.dtype, stride=cfg.patch_size,
                                padding=0)
        if cfg.pos_embed == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, *(cfg.pos_grid or grid), c))
        if cfg.use_class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, c))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", Block(cfg))
        self.norm = LayerNorm32(c)

    def forward(self, images: torch.Tensor) -> dict:
        cfg = self.cfg
        b, h, w, _ = images.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(cfg.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C)

        if cfg.pos_embed == "learned":
            pos = self.pos_embed
            if tuple(pos.shape[1:3]) != (gh, gw):
                pos = resize_pos_embed(pos, gh, gw)
            x = x + pos.reshape(1, gh * gw, cfg.width).to(cfg.dtype)
        prefix = []
        if cfg.use_class_token:
            prefix.append(self.cls_token.to(cfg.dtype).expand(b, 1, cfg.width))
        if cfg.num_register_tokens:
            prefix.append(self.register_tokens.to(cfg.dtype).expand(
                b, cfg.num_register_tokens, cfg.width))
        n_prefix = sum(t.shape[1] for t in prefix)
        if prefix:
            x = torch.cat([*prefix, x], dim=1)

        # Pad once to a lane multiple; pad rows are masked as keys and
        # sliced off at every output.
        n_real = x.shape[1]
        n_full = _pad_to(n_real)
        if n_full != n_real:
            x = F.pad(x, (0, 0, 0, n_full - n_real))
        rope = seg = None
        if cfg.pos_embed == "rope2d":
            # Prefix and pad tokens sit at (0, 0), the identity rotation.
            ys, xs = torch.meshgrid(torch.arange(gh, device=x.device),
                                    torch.arange(gw, device=x.device), indexing="ij")
            pos = torch.zeros(1, n_full, 2, dtype=torch.long, device=x.device)
            pos[0, n_prefix:n_real] = torch.stack([ys, xs], dim=-1).reshape(-1, 2)
            rope = rope_2d_freqs(cfg.width // cfg.num_heads, pos)
            if n_full != n_real:
                seg = (torch.arange(n_full, device=x.device) >= n_real).to(
                    torch.int32).expand(b, n_full)

        want = {i % cfg.depth for i in cfg.out_indices}
        hiddens = []
        for i in range(cfg.depth):
            x = getattr(self, f"block{i}")(x, n_real, rope, seg)
            if i in want:
                hid = self.norm(x[:, :n_real]) if cfg.norm_hiddens else x[:, :n_real]
                hiddens.append(hid[:, n_prefix:])

        x_prenorm = x[:, :n_real]
        x = self.norm(x_prenorm).to(cfg.dtype)
        out = {"tokens": x[:, n_prefix:], "grid": (gh, gw), "hiddens": hiddens,
               "all_prenorm": x_prenorm.to(cfg.dtype)}
        if cfg.use_class_token:
            out["cls"] = x[:, 0]
        return out


def resize_pos_embed(pos: torch.Tensor, new_gh: int, new_gw: int) -> torch.Tensor:
    """(1, gh, gw, C) -> (1, new_gh, new_gw, C): antialiased bicubic
    interpolation between resolution buckets, as the JAX package's
    `jax.image.resize(..., 'bicubic', antialias=True)` (Keys a = -0.5)."""
    return resize(pos.permute(0, 3, 1, 2), (new_gh, new_gw), "bicubic").permute(0, 2, 3, 1)
