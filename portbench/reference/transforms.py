# Frozen copy of labelany3d_tpu_torch/geometry/transforms.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Rotation primitives, batched over leading dims; counterpart of
`labelany3d_tpu/geometry/transforms.py`."""

from __future__ import annotations

import torch

from .precision import tensors_on
from .precision import f32_precision

_EPS = 1e-12


def normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Normalize along the last axis; zero vectors pass through."""
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.where(norm > eps, v / norm.clamp_min(eps), v)


def rotate_y(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about +y; `yaw` (...) -> (..., 3, 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [
        torch.stack([c, zero, s], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([-s, zero, c], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix of (..., 3) vectors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


@f32_precision
def rotation_matrix_from_vectors(vec1: torch.Tensor, vec2: torch.Tensor) -> torch.Tensor:
    """Rotation mapping unit(vec1) onto unit(vec2) (Rodrigues), with the
    parallel (identity) and anti-parallel (180 degrees about a stable
    orthogonal axis) cases handled exactly."""
    a = normalize(vec1.float())
    b = normalize(vec2.float())
    axis = torch.linalg.cross(a, b, dim=-1)
    cos_theta = (a * b).sum(-1)[..., None, None]
    s2 = (axis * axis).sum(-1)[..., None, None]
    k = skew(axis)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(k.shape)
    general = eye + k + (k @ k) / (1.0 + cos_theta).clamp_min(_EPS)
    ex = torch.tensor([1.0, 0.0, 0.0], device=a.device).expand(a.shape)
    ey = torch.tensor([0.0, 1.0, 0.0], device=a.device).expand(a.shape)
    helper = torch.where(a[..., 0:1].abs() < 0.9, ex, ey)
    ortho = normalize(torch.linalg.cross(a, helper, dim=-1))
    flip = 2.0 * ortho[..., :, None] * ortho[..., None, :] - torch.eye(3, device=a.device)
    degenerate = s2 < 1e-10
    return torch.where(degenerate, torch.where(cos_theta < 0.0, flip, eye), general)


@f32_precision
def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) for (..., 3) rotation vectors."""
    norm = torch.linalg.norm(w, dim=-1, keepdim=True)
    theta = norm.clamp_min(_EPS)
    k = skew(w / theta)
    t = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    r = eye + torch.sin(t) * k + (1.0 - torch.cos(t)) * (k @ k)
    return torch.where(norm[..., None] < 1e-8, eye + skew(w), r)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3); returns (..., 3) rotation vectors
    (first order near theta = 0)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    theta = torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))
    axis_unnorm = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                               r[..., 0, 2] - r[..., 2, 0],
                               r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)[..., None]
    scale = torch.where(sin_theta.abs() > 1e-6,
                        theta[..., None] / (2.0 * sin_theta).clamp_min(_EPS),
                        0.5 + theta[..., None] ** 2 / 12.0)
    return axis_unnorm * scale


def compose_transform(r, t, scale=None, *, device=None) -> torch.Tensor:
    """(..., 4, 4) homogeneous transforms from rotations (..., 3, 3) (times
    an optional (...) scale) and translations (..., 3), broadcast together."""
    r, t, scale = tensors_on(r, t, scale, device=device)
    if scale is not None:
        r = r * scale[..., None, None]
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    out = torch.eye(4, dtype=r.dtype, device=r.device).expand(*batch, 4, 4).clone()
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    return out
