"""DINOv2-style Vision Transformer encoder (PyTorch).

Counterpart of `labelany3d_tpu/models/vit.py` for learned position
embeddings. Module names follow the Flax tree (`block{i}.attn.qkv`, ...)
so `models/weights.py` carries parameters across one to one.

The token sequence is padded once to a multiple of 128 and every layer's
attention runs through `ops.attention.packed_sdpa` with `n_real`, on every
device, so the CPU path masks exactly as the CUDA kernel does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, Dense, LayerNorm32
from labelany3d_tpu_torch.ops.attention import packed_sdpa


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    out_indices: Sequence[int] = ()

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
    def tiny_test(**kw) -> "ViTConfig":
        return ViTConfig(width=64, depth=2, num_heads=2, patch_size=8, **kw)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.fc1 = Dense(cfg.width, hidden, cfg.dtype)
        self.fc2 = Dense(hidden, cfg.width, cfg.dtype)

    def forward(self, x):
        # Exact-erf GELU on every dtype (the JAX package's bf16 tanh form
        # clamps inputs at 10; the port keeps the checkpoint's activation).
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = Dense(cfg.width, 3 * cfg.width, cfg.dtype)
        self.proj = Dense(cfg.width, cfg.width, cfg.dtype)

    def forward(self, x, n_real: int):
        qkv = self.qkv(x).contiguous()
        return self.proj(packed_sdpa(qkv, self.num_heads, n_real))


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
        self.ls1 = LayerScale(cfg.width, cfg.layerscale_init)
        self.ls2 = LayerScale(cfg.width, cfg.layerscale_init)

    def forward(self, x, n_real: int):
        x = x + self.ls1(self.attn(self.norm1(x).to(self.dtype), n_real))
        return x + self.ls2(self.mlp(self.norm2(x).to(self.dtype)))


def _pad_to(n: int, multiple: int = 128) -> int:
    return -(-n // multiple) * multiple


class ViT(nn.Module):
    """Patchify -> class token + transformer; returns final and requested
    block outputs.

    Input: (B, H, W, 3) NHWC images. The pos-embed grid is fixed at
    construction: `grid` is the token grid of the inputs the model will see.
    Output dict as in the JAX package: tokens (B, N, C), grid (gh, gw),
    hiddens [(B, N, C)] (pre-norm outputs of the `out_indices` blocks),
    cls (B, C).
    """

    def __init__(self, cfg: ViTConfig, grid: tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        c = cfg.width
        self.patch_embed = Conv(3, c, cfg.patch_size, cfg.dtype, stride=cfg.patch_size,
                                padding=0)
        self.pos_embed = nn.Parameter(torch.zeros(1, *grid, c))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
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

        pos = self.pos_embed
        if tuple(pos.shape[1:3]) != (gh, gw):
            pos = resize_pos_embed(pos, gh, gw)
        x = x + pos.reshape(1, gh * gw, cfg.width).to(cfg.dtype)
        x = torch.cat([self.cls_token.to(cfg.dtype).expand(b, 1, cfg.width), x], dim=1)

        # Pad once to a lane multiple; pad rows are masked as keys and
        # sliced off at every output.
        n_real = x.shape[1]
        n_full = _pad_to(n_real)
        if n_full != n_real:
            x = F.pad(x, (0, 0, 0, n_full - n_real))

        want = {i % cfg.depth for i in cfg.out_indices}
        hiddens = []
        for i in range(cfg.depth):
            x = getattr(self, f"block{i}")(x, n_real)
            if i in want:
                hiddens.append(x[:, 1:n_real])

        x = self.norm(x[:, :n_real]).to(cfg.dtype)
        return {"tokens": x[:, 1:], "grid": (gh, gw), "hiddens": hiddens, "cls": x[:, 0]}


def resize_pos_embed(pos: torch.Tensor, new_gh: int, new_gw: int) -> torch.Tensor:
    """Antialiased bicubic pos-embed interpolation between buckets. Not
    ported yet: the port runs at one pinned bucket."""
    raise NotImplementedError(
        f"resize_pos_embed ({tuple(pos.shape[1:3])} -> ({new_gh}, {new_gw})) is not "
        "ported yet; pin the bucket (pin_hw) so the pos-embed grid matches")
