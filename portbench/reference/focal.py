# Frozen copy of labelany3d_tpu_torch/geometry/focal.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Focal-length and z-shift recovery from affine point maps (MoGe-style).

Counterpart of `labelany3d_tpu/geometry/focal.py`: a dense candidate grid
over the shift (bracketing z + shift > 0), then a fixed number of
golden-section refinements, batched over images. The `lax.scan` of the JAX
package is a Python loop here.
"""

from __future__ import annotations

import torch

from .camera import intrinsics_from_focal_center


def normalized_view_plane_uv(width: int, height: int, device=None) -> torch.Tensor:
    """(H, W, 2) uv with corners at +-(w, h)/diagonal (MoGe convention)."""
    aspect = width / height
    span_x = aspect / (1.0 + aspect**2) ** 0.5
    span_y = 1.0 / (1.0 + aspect**2) ** 0.5
    u = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width,
                       width, dtype=torch.float32, device=device)
    v = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height,
                       height, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def _nearest_index(size: int, target: int, device) -> torch.Tensor:
    """torch `F.interpolate(mode='nearest')` source rows: floor(dst * s/d)."""
    return torch.floor(torch.arange(target, device=device) * (size / target)).long()


def _objective(shift, xy, z, uv, w, focal=None):
    """Masked SSE of f * xy/(z+shift) - uv; returns (cost, focal).
    shift: (...,) broadcasting against z (..., N)."""
    denom = z + shift[..., None]
    safe = denom.abs() > 1e-12
    denom = torch.where(safe, denom, torch.full_like(denom, 1e-12))
    proj = xy / denom[..., None]
    proj = torch.where((safe & (w > 0))[..., None], proj, torch.zeros_like(proj))
    uv_m = torch.where((w > 0)[..., None], uv, torch.zeros_like(uv))
    if focal is None:
        num = (proj * uv_m).sum(dim=(-2, -1))
        den = (proj * proj).sum(dim=(-2, -1)).clamp_min(1e-12)
        focal = num / den
    err = focal[..., None, None] * proj - uv_m
    return (err * err).sum(dim=(-2, -1)), focal


def recover_focal_shift(
    points: torch.Tensor,
    mask: torch.Tensor | None = None,
    focal: torch.Tensor | None = None,
    downsample_size: tuple[int, int] = (64, 64),
    num_candidates: int = 64,
    refine_iters: int = 24,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Recover (focal, shift) from (B, H, W, 3) affine point maps; `focal`
    is relative to half the image diagonal. With `focal` given, only the
    shift is solved."""
    points = points.float()
    dev = points.device
    b, height, width = points.shape[0], points.shape[-3], points.shape[-2]
    ys = _nearest_index(height, downsample_size[0], dev)
    xs = _nearest_index(width, downsample_size[1], dev)
    pts_lr = points[:, ys[:, None], xs[None, :], :]
    uv_lr = normalized_view_plane_uv(width, height, dev)[ys[:, None], xs[None, :], :]
    if mask is None:
        wgt = torch.ones(pts_lr.shape[:-1], device=dev)
    else:
        wgt = (mask.float()[:, ys[:, None], xs[None, :]] > 0).float()

    p = pts_lr.reshape(b, -1, 3)
    uv = uv_lr.reshape(1, -1, 2).expand(b, -1, -1)
    wf = wgt.reshape(b, -1)
    xy, z = p[..., :2], p[..., 2]

    big = 3.4e38
    zmin = torch.where(wf > 0, z, torch.full_like(z, big)).amin(dim=-1)
    zmax = torch.where(wf > 0, z, torch.full_like(z, -big)).amax(dim=-1)
    zrange = (zmax - zmin).clamp_min(1e-3)
    lo = -zmin + 1e-4
    hi = lo + 10.0 * zrange
    ts = torch.linspace(0.0, 1.0, num_candidates, device=dev)
    cands = lo[:, None] + (hi - lo)[:, None] * ts**2  # denser near the bound

    def cost(s):  # s: (B, K) -> (B, K)
        f = None if focal is None else focal[:, None].expand_as(s)
        c, _ = _objective(s, xy[:, None], z[:, None], uv[:, None], wf[:, None], focal=f)
        return c

    best = cost(cands).argmin(dim=-1)
    a = cands.gather(-1, (best - 1).clamp_min(0)[:, None])[:, 0]
    bb = cands.gather(-1, (best + 1).clamp_max(num_candidates - 1)[:, None])[:, 0]
    a = torch.maximum(a, lo)

    gr = 0.6180339887498949
    for _ in range(refine_iters):
        x1 = bb - gr * (bb - a)
        x2 = a + gr * (bb - a)
        c = cost(torch.stack([x1, x2], dim=-1))
        left = c[:, 0] < c[:, 1]
        a, bb = torch.where(left, a, x1), torch.where(left, x2, bb)
    shift = 0.5 * (a + bb)
    _, focal_out = _objective(shift, xy, z, uv, wf, focal=focal)
    if focal is not None:
        focal_out = torch.as_tensor(focal, dtype=torch.float32, device=dev).expand(shift.shape)
    return focal_out, shift


def intrinsics_from_diag_focal(focal: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Normalized intrinsics from a half-diagonal-relative focal, principal
    point (0.5, 0.5)."""
    aspect = width / height
    diag = (1.0 + aspect**2) ** 0.5
    fx = focal / 2.0 * diag / aspect
    fy = focal / 2.0 * diag
    half = torch.full_like(fx, 0.5)
    return intrinsics_from_focal_center(fx, fy, half, half)
