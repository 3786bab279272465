"""2D rotary position embeddings over (y, x) token positions.

Counterpart of `labelany3d_tpu/ops/rope2d.py`: the head dim splits in half,
the first half rotated by y-position frequencies and the second by x, each
half in the rotate-half convention. Plain elementwise PyTorch; callers
compute in float32 and cast, as the matcher decoder does.
"""

from __future__ import annotations

import torch


def rope_2d_freqs(dim: int, positions: torch.Tensor,
                  base: float = 100.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., N, dim) for integer (..., N, 2) (y, x) positions."""
    if dim % 4:
        raise ValueError(f"2D RoPE needs dim divisible by 4, got {dim}")
    quarter = dim // 4
    inv_freq = 1.0 / (base ** (torch.arange(quarter, dtype=torch.float32,
                                            device=positions.device) / quarter))
    y = positions[..., 0:1].float() * inv_freq
    x = positions[..., 1:2].float() * inv_freq
    cos = torch.cat([torch.cos(y), torch.cos(y), torch.cos(x), torch.cos(x)], dim=-1)
    sin = torch.cat([torch.sin(y), torch.sin(y), torch.sin(x), torch.sin(x)], dim=-1)
    return cos, sin


def _rotate_half_sectioned(t: torch.Tensor) -> torch.Tensor:
    """Rotate-half applied independently to the y-half and the x-half."""
    q = t.shape[-1] // 4
    a, b, c, d = t.split(q, dim=-1)
    return torch.cat([-b, a, -d, c], dim=-1)


def rope_pair(rope: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., N, D) shaped to rotate tokens (..., N, 2, H, D):
    q and k stacked on a pair axis, rotated by one call."""
    return tuple(t[..., :, None, None, :] for t in rope)


def apply_rope_2d(tokens: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """tokens (..., N, H, D) or (..., N, D) with cos/sin (..., N, D), which
    broadcast over the heads axis."""
    if tokens.dim() == cos.dim() + 1:
        cos = cos[..., :, None, :]
        sin = sin[..., :, None, :]
    return tokens * cos + _rotate_half_sectioned(tokens) * sin
