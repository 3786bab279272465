# Frozen copy of labelany3d_tpu_torch/geometry/backproject.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Depth back-projection and per-instance point sampling, batched.

Counterpart of `labelany3d_tpu/geometry/backproject.py`. The instance
sampler keeps the JAX package's semantics exactly: draw `num_samples`
uniform ranks among a mask's pixels (with replacement) and take the pixel
of each rank in 4x4-block-major order, so that the same ranks give the same
points. Where the JAX package searches a two-level block CDF, the port
runs one `torch.searchsorted` over the block-major prefix count.
"""

from __future__ import annotations

import torch

from .precision import f32_precision


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    """(H, W, 3) homogeneous pixel coordinates [u, v, 1] (integer corners)."""
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([u, v, torch.ones_like(u)], dim=-1)


@f32_precision
def backproject_directions(K: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-pixel ray directions K^-1 [u, v, 1]; (..., H, W, 3).

    A singular K (zero focal from a degenerate depth map) gives non-finite
    rays, as `jnp.linalg.inv` does, instead of raising; the box fit then
    marks those instances as failed."""
    Kinv = torch.linalg.inv_ex(K.float())[0]
    grid = pixel_grid(height, width, K.device)
    return torch.einsum("...ij,hwj->...hwi", Kinv, grid)


@f32_precision
def depth_to_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project (..., H, W) depth to (..., H, W, 3) camera-space points."""
    depth = depth.float()
    dirs = backproject_directions(K, depth.shape[-2], depth.shape[-1])
    return depth[..., None] * dirs


def draw_instance_ranks(counts: torch.Tensor, num_samples: int,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform ranks in [0, max(count, 1)) per instance; (..., I, S) int64."""
    u = torch.rand((*counts.shape, num_samples), generator=generator, device=counts.device)
    hi = counts.clamp_min(1)[..., None].to(u.dtype)
    return torch.minimum((u * hi).long(), counts.clamp_min(1)[..., None] - 1)


def gather_instance_points(
    points: torch.Tensor,
    masks: torch.Tensor,
    num_samples: int,
    draws: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size per-instance point sets from a batch of point maps.

    points (B, H, W, 3), masks (B, I, H, W) bool, draws (B, I, S) ranks or
    None (drawn from `generator`). Returns pts (B, I, S, 3), valid (B, I).
    H and W must be multiples of 4.
    """
    b, n_inst, h, w = masks.shape
    bs = 4
    gh, gw = h // bs, w // bs
    # Block-major pixel order: pixel (by*4+py, bx*4+px) at rank position
    # ((by*gw + bx)*16 + py*4 + px).
    mb = (masks.reshape(b, n_inst, gh, bs, gw, bs).permute(0, 1, 2, 4, 3, 5)
          .reshape(b, n_inst, h * w))
    cdf = torch.cumsum(mb.to(torch.int64), dim=-1)  # (B, I, HW)
    n_valid = cdf[..., -1]
    valid = n_valid > 0
    if draws is None:
        draws = draw_instance_ranks(n_valid, num_samples, generator)
    draws = draws.to(device=cdf.device, dtype=torch.int64)
    # First position whose prefix count exceeds the rank: the (rank+1)-th pixel.
    pos = torch.searchsorted(cdf, draws, right=True).clamp_max(h * w - 1)
    blk, inner = pos // (bs * bs), pos % (bs * bs)
    row = (blk // gw) * bs + inner // bs
    col = (blk % gw) * bs + inner % bs
    idx = (row * w + col).reshape(b, -1)  # (B, I*S)
    flat = points.reshape(b, h * w, 3)
    pts = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 3))
    return pts.reshape(b, n_inst, -1, 3), valid
