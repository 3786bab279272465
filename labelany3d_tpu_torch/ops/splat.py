"""Tile-based 3D Gaussian splat rasterizer (forward).

Counterpart of `labelany3d_tpu/ops/splat.py` (diff-gaussian-rasterization's
role in TRELLIS's texture bake), plain PyTorch:

  1. project the Gaussians (EWA splatting: 2D covariance J W S W^T J^T plus
     the 0.3 px low-pass);
  2. coarse: per-tile lists of the `gaussians_per_tile` nearest Gaussians
     whose 3-sigma boxes overlap the tile, front to back;
  3. fine: per-pixel alpha compositing front to back via cumulative
     transmittance.

The fine phase's intermediates are (tiles x pixels x list); tiles go in
chunks of at most `_FINE_ELEMENTS` elements.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from labelany3d_tpu_torch.utils.precision import f32_precision

_FINE_ELEMENTS = 1 << 24


class SplatOut(NamedTuple):
    rgb: torch.Tensor     # (H, W, 3)
    alpha: torch.Tensor   # (H, W)
    depth: torch.Tensor   # (H, W) alpha-weighted expected depth


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotations."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


@f32_precision
def rasterize_gaussians(means, scales, rotations, opacities, colors, R, t, K,
                        image_size: tuple[int, int], tile: int = 16,
                        gaussians_per_tile: int = 256, sigma_cutoff: float = 3.0) -> SplatOut:
    """Render N Gaussians with an OpenCV camera (x right, y down, z forward):
    means (N, 3) world, scales (N, 3) stddevs, rotations (N, 4) wxyz,
    opacities (N,), colors (N, 3) in [0, 1]; X_cam = R X + t."""
    h, w = image_size
    dev = means.device
    means, R, t, K = means.float(), R.float(), t.float(), K.float()
    n = means.shape[0]
    cam = means @ R.T + t
    z = cam[:, 2].clamp_min(1e-6)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * cam[:, 0] / z + cx
    v = fy * cam[:, 1] / z + cy
    in_front = cam[:, 2] > 1e-4

    Rq = quat_to_rotmat(rotations.float())
    cov3 = torch.einsum("nij,nj,nkj->nik", Rq, scales.float() ** 2, Rq)
    covw = torch.einsum("ij,njk,lk->nil", R, cov3, R)
    invz = 1.0 / z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx * invz, zero, -fx * cam[:, 0] * invz ** 2], -1),
                     torch.stack([zero, fy * invz, -fy * cam[:, 1] * invz ** 2], -1)], dim=-2)
    cov2 = torch.einsum("nij,njk,nlk->nil", J, covw, J) + 0.3 * torch.eye(2, device=dev)
    det = (cov2[:, 0, 0] * cov2[:, 1, 1] - cov2[:, 0, 1] * cov2[:, 1, 0]).clamp_min(1e-12)
    ia, ib, ic = cov2[:, 1, 1] / det, -cov2[:, 0, 1] / det, cov2[:, 0, 0] / det  # inverse
    mid = 0.5 * (cov2[:, 0, 0] + cov2[:, 1, 1])
    lam = mid + torch.sqrt((mid ** 2 - det).clamp_min(0.0))
    radius = sigma_cutoff * torch.sqrt(lam.clamp_min(0.0))

    big = torch.tensor(1e9, device=dev)
    x0 = torch.where(in_front, u - radius, big)
    x1 = torch.where(in_front, u + radius, -big)
    y0 = torch.where(in_front, v - radius, big)
    y1 = torch.where(in_front, v + radius, -big)
    ty, tx = h // tile, w // tile
    tiles_y0 = torch.arange(ty, dtype=torch.float32, device=dev) * tile
    tiles_x0 = torch.arange(tx, dtype=torch.float32, device=dev) * tile
    ov_y = (y0[None] <= tiles_y0[:, None] + tile) & (y1[None] >= tiles_y0[:, None])
    ov_x = (x0[None] <= tiles_x0[:, None] + tile) & (x1[None] >= tiles_x0[:, None])
    overlap = (ov_y[:, None, :] & ov_x[None, :, :]).reshape(ty * tx, n)

    cap = min(gaussians_per_tile, n)
    # Nearest first; equal depths by ascending index, as `jax.lax.top_k`.
    score = torch.where(overlap, -z[None], torch.tensor(float("-inf"), device=dev))
    top_score, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_score, top_idx = top_score[:, :cap], top_idx[:, :cap]
    tile_valid = torch.isfinite(top_score)
    g_idx = torch.where(tile_valid, top_idx, torch.zeros_like(top_idx))

    cols, op = colors.float(), opacities.float()
    p = tile * tile
    offs = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    pyy = offs[:, None].expand(tile, tile).reshape(1, p, 1)
    pxx = offs[None, :].expand(tile, tile).reshape(1, p, 1)
    t_ids = torch.arange(ty * tx, device=dev)
    chunk = max(1, _FINE_ELEMENTS // (p * cap))
    rgbs, accs, deps = [], [], []
    for c0 in range(0, ty * tx, chunk):
        tid, idx, ok = t_ids[c0:c0 + chunk], g_idx[c0:c0 + chunk], tile_valid[c0:c0 + chunk]
        py = (tid // tx).float()[:, None, None] * tile + pyy      # (T, P, 1)
        px = (tid % tx).float()[:, None, None] * tile + pxx
        du = px - u[idx][:, None, :]                               # (T, P, C)
        dv = py - v[idx][:, None, :]
        power = -0.5 * (ia[idx][:, None] * du * du + 2 * ib[idx][:, None] * du * dv
                        + ic[idx][:, None] * dv * dv)
        alpha = torch.minimum(op[idx][:, None] * torch.exp(power), torch.tensor(0.999, device=dev))
        alpha = torch.where(ok[:, None, :] & (power > -0.5 * sigma_cutoff ** 2), alpha,
                            torch.zeros_like(alpha))
        trans = torch.cumprod(1.0 - alpha, dim=-1)
        wgt = alpha * torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
        rgbs.append(torch.einsum("tpc,tck->tpk", wgt, cols[idx]))
        accs.append(wgt.sum(-1))
        deps.append(torch.einsum("tpc,tc->tp", wgt, z[idx]))

    def untile(x):
        x = torch.cat(x).reshape(ty, tx, tile, tile, *x[0].shape[2:]).transpose(1, 2)
        return x.reshape(h, w, *x.shape[4:])

    return SplatOut(rgb=untile(rgbs), alpha=untile(accs), depth=untile(deps))
