# Frozen copy of labelany3d_tpu_torch/geometry/camera.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Camera math: look-at frames, orbit poses, intrinsics, projection.

Counterpart of `labelany3d_tpu/geometry/camera.py`, batched over leading
dims, float32 with TF32 off. A function given tensors computes where they
live; one given numpy arrays computes on the card unless `device="cpu"`.
"""

from __future__ import annotations

import torch

from .transforms import normalize
from .precision import tensors_on
from .precision import f32_precision


@f32_precision
def look_at(campos, target, opengl: bool = True, *, device=None) -> torch.Tensor:
    """Camera rotation whose columns are (right, up, forward), (..., 3, 3).
    With `opengl` the camera's forward axis points from the target toward
    the camera (+z); otherwise toward the target (-z)."""
    campos, target = tensors_on(campos, target, device=device)
    world_up = torch.tensor([0.0, 1.0, 0.0], device=campos.device)
    if opengl:
        forward = normalize(campos - target)
        right = normalize(torch.linalg.cross(world_up.expand(forward.shape), forward, dim=-1))
        up = normalize(torch.linalg.cross(forward, right, dim=-1))
    else:
        forward = normalize(target - campos)
        right = normalize(torch.linalg.cross(forward, world_up.expand(forward.shape), dim=-1))
        up = normalize(torch.linalg.cross(right, forward, dim=-1))
    return torch.stack([right, up, forward], dim=-1)


@f32_precision
def orbit_camera(elevation, azimuth, radius=1.0, is_degree: bool = True, target=None,
                 opengl: bool = True, *, device=None) -> torch.Tensor:
    """Elevation/azimuth -> camera-to-world pose (..., 4, 4). Elevation in
    (-90, 90), from +y toward -y; azimuth in (-180, 180), from +z toward +x."""
    elevation, azimuth, radius, target = tensors_on(elevation, azimuth, radius, target,
                                                    device=device)
    if is_degree:
        elevation, azimuth = torch.deg2rad(elevation), torch.deg2rad(azimuth)
    x = radius * torch.cos(elevation) * torch.sin(azimuth)
    y = -radius * torch.sin(elevation)
    z = radius * torch.cos(elevation) * torch.cos(azimuth)
    offset = torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)
    if target is None:
        target = torch.zeros(3, device=offset.device)
    campos = offset + target
    rot = look_at(campos, target.expand(campos.shape), opengl)
    pose = torch.eye(4, device=rot.device).expand(*rot.shape[:-2], 4, 4).clone()
    pose[..., :3, :3] = rot
    pose[..., :3, 3] = campos
    return pose


@f32_precision
def project_points(points, K, eps: float = 1e-9, *, device=None) -> torch.Tensor:
    """Pinhole projection of (..., N, 3) camera-space points to (..., N, 2);
    a depth within `eps` of 0 is replaced by +-eps (its sign kept)."""
    points, K = tensors_on(points, K, device=device)
    uvw = torch.einsum("...ij,...nj->...ni", K, points)
    z = uvw[..., 2:3]
    z = torch.where(z.abs() > eps, z, torch.where(z >= 0, eps, -eps))
    return uvw[..., :2] / z


def point_to_plane_distance(plane, points, *, device=None) -> torch.Tensor:
    """Unsigned distance from (..., N, 3) points to planes [a, b, c, d]."""
    plane, points = tensors_on(plane, points, device=device)
    n, d = plane[..., :3], plane[..., 3:]
    num = (torch.einsum("...j,...nj->...n", n, points) + d).abs()
    return num / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)


def intrinsics_from_focal_center(fx, fy, cx, cy) -> torch.Tensor:
    """Build (..., 3, 3) pinhole intrinsics from focal lengths and center."""
    fx, fy, cx, cy = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.float32)
                                               for v in (fx, fy, cx, cy)))
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = [
        torch.stack([fx, zero, cx], dim=-1),
        torch.stack([zero, fy, cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def scale_intrinsics(K, scale_x, scale_y, *, device=None) -> torch.Tensor:
    """Rescale intrinsics for a resized image (fx, cx *= sx; fy, cy *= sy)."""
    K, sx, sy = tensors_on(K, scale_x, scale_y, device=device)
    out = K.clone()
    out[..., 0, :] = K[..., 0, :] * sx[..., None]
    out[..., 1, :] = K[..., 1, :] * sy[..., None]
    return out


def normalized_to_pixel_intrinsics(K_norm, width, height, *, device=None) -> torch.Tensor:
    """MoGe-style normalized intrinsics (principal point 0.5) to pixels: row 0
    times the image width, row 1 times its height."""
    return scale_intrinsics(K_norm, width, height, device=device)
