"""Synthetic two-view training pairs, ray-cast on the device from a seed.

Each pair views one scene: a ground plane under the camera, a back wall
at `far_depth`, and `rects_per_scene` textured rectangles standing on
neither, each at a depth between `near_depth` and the wall, turned about
the vertical by up to `max_yaw_deg`. View 0's camera sits at the origin
looking down +z (x right, y down; focal `focal_share` of the image size,
principal point at the centre), so world coordinates are view 0's frame.
View 1's camera is view 0's turned by an angle in `rotation_deg` (either
sign) about the vertical axis through the scene centre, a point on view
0's optical axis at a depth in `centre_depths`, still looking at it.

Every pixel's ray (through the pixel's centre) takes the nearest surface
it meets; its colour is the surface's texture (a colour of its own under
a checker and a stripe over the surface's own coordinates, so both views
see the same paint) with a little noise. A share `invalid_share` of each
view's pixels is invalid. The ground-truth pointmaps of both views are
the hit points in view 0's frame.

Correspondences: view 0's valid pixels whose point projects into view 1
onto a valid pixel whose own point lies at the same depth in view 1's
camera (within `depth_tol` of it: a point hidden behind another surface
fails this); each view-1 pixel keeps one of the view-0 pixels that land on
it, and `matches` of the pairs left are drawn without replacement. Both
index lists are flat (y * size + x) and hold distinct pixels.

Parameters (the traffic file): pool (pairs held on the device),
rects_per_scene (cycled over each batch, each batch in its own order),
near_depth, far_depth, centre_depths, rotation_deg, max_yaw_deg,
focal_share, invalid_share, depth_tol.
"""

from __future__ import annotations

import math

import torch


def _cycled(values: list, batch: int, n: int, g, device) -> torch.Tensor:
    """`values` repeated to fill each batch of `batch` rows, each batch
    permuted: (n,)."""
    base = torch.tensor([values[i % len(values)] for i in range(batch)], device=device)
    return torch.cat([base[torch.randperm(batch, generator=g, device=device)]
                      for _ in range(n // batch)])


def _uniform(lo: float, hi: float, shape, g, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about the y axis."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _texture(u: torch.Tensor, v: torch.Tensor, colour: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """(..., 3) paint at surface coordinates (u, v) (m): a checker of
    `scale` m and a stripe over `colour`."""
    checker = ((torch.floor(u / scale) + torch.floor(v / scale)) % 2)[..., None]
    stripe = (0.5 + 0.5 * torch.sin(6.0 * (u + 0.5 * v) / scale))[..., None]
    return colour * (0.55 + 0.3 * checker + 0.15 * stripe)


class Scene:
    """One scene's surfaces: plane point, normal, in-plane axes (u, v),
    half extents (inf for ground and wall), colour and checker scale."""

    def __init__(self, point, normal, axis_u, axis_v, half_u, half_v, colour, scale):
        self.point, self.normal, self.axis_u, self.axis_v = point, normal, axis_u, axis_v
        self.half_u, self.half_v, self.colour, self.scale = half_u, half_v, colour, scale

    def cast(self, origin: torch.Tensor, dirs: torch.Tensor):
        """Rays origin + t dirs (dirs (N, 3), unit depth along the camera's
        axis): (t (N,), hit point (N, 3), colour (N, 3)); t is inf where no
        surface is met."""
        denom = dirs @ self.normal.T                                     # (N, S)
        t = ((self.point - origin) * self.normal).sum(-1) / torch.where(
            denom.abs() > 1e-9, denom, torch.full_like(denom, 1e-9))
        hit = origin + t[..., None] * dirs[:, None, :]                   # (N, S, 3)
        rel = hit - self.point
        u = (rel * self.axis_u).sum(-1)
        v = (rel * self.axis_v).sum(-1)
        ok = (t > 1e-4) & (u.abs() <= self.half_u) & (v.abs() <= self.half_v)
        t = torch.where(ok, t, torch.full_like(t, math.inf))
        t_min, which = t.min(-1)
        pick = which[:, None]
        pts = hit.gather(1, pick[..., None].expand(-1, 1, 3))[:, 0]
        paint = _texture(u.gather(1, pick)[:, 0], v.gather(1, pick)[:, 0],
                         self.colour[which], self.scale[which])
        return t_min, pts, paint


def _scene(rects: int, r_max: int, params: dict, focal: float, size: int, g, device) -> Scene:
    near, far = float(params["near_depth"]), float(params["far_depth"])
    height = float(_uniform(1.2, 2.0, (), g, device))
    x = torch.tensor([1.0, 0.0, 0.0], device=device)
    y = torch.tensor([0.0, 1.0, 0.0], device=device)
    z = torch.tensor([0.0, 0.0, 1.0], device=device)
    # Ground (y = height, normal up) and back wall (z = far).
    points = [height * y, far * z]
    normals = [-y, -z]
    axes_u, axes_v = [x, x], [z, y]
    # Rectangles: depth log-uniform in [near + 0.5, 0.8 far], centre inside
    # view 0's frustum, half extents a sixteenth to a quarter of the view's
    # width at that depth.
    depth = torch.exp(_uniform(math.log(near + 0.5), math.log(0.8 * far), (r_max,), g, device))
    half_view = 0.5 * size / focal * depth
    cx = _uniform(-0.7, 0.7, (r_max,), g, device) * half_view
    cy = _uniform(-0.7, 0.5, (r_max,), g, device) * half_view
    cy = torch.minimum(cy, torch.full_like(cy, height - 0.05))
    yaw = torch.deg2rad(_uniform(-1.0, 1.0, (r_max,), g, device) * float(params["max_yaw_deg"]))
    rot = _rot_y(yaw)                                                    # (R, 3, 3)
    hu = _uniform(1 / 16, 1 / 4, (r_max,), g, device) * 2 * half_view
    hv = _uniform(1 / 16, 1 / 4, (r_max,), g, device) * 2 * half_view
    for i in range(rects):
        points.append(torch.stack([cx[i], cy[i], depth[i]]))
        normals.append(rot[i] @ -z)
        axes_u.append(rot[i] @ x)
        axes_v.append(y)
    n = len(points)
    inf = torch.full((2,), math.inf, device=device)
    half_u = torch.cat([inf, hu[:rects]])
    half_v = torch.cat([inf, hv[:rects]])
    colour = _uniform(0.15, 1.0, (n, 3), g, device)
    scale = torch.cat([torch.tensor([1.0, 2.0], device=device),
                       _uniform(0.2, 1.0, (rects,), g, device) * hu[:rects]])
    return Scene(torch.stack(points), torch.stack(normals), torch.stack(axes_u),
                 torch.stack(axes_v), half_u, half_v, colour, scale)


def _rays(size: int, focal: float, device) -> torch.Tensor:
    """(size * size, 3) camera-frame directions through the pixel centres,
    unit depth."""
    c = torch.arange(size, device=device, dtype=torch.float32) + 0.5 - 0.5 * size
    ys, xs = torch.meshgrid(c / focal, c / focal, indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)


def _correspondences(pts0, valid0, pts1, valid1, rot1, origin1, focal, size, matches,
                     depth_tol, g, device):
    """(corr0, corr1) flat pixel indices of `matches` distinct view-0 and
    view-1 pixels that see the same point."""
    cam = (pts0 - origin1) @ rot1                        # view 1's camera frame, (N, 3)
    zc = cam[:, 2]
    u = torch.floor(cam[:, 0] / zc.clamp_min(1e-6) * focal + 0.5 * size)
    v = torch.floor(cam[:, 1] / zc.clamp_min(1e-6) * focal + 0.5 * size)
    inside = valid0 & (zc > 1e-3) & (u >= 0) & (u < size) & (v >= 0) & (v < size)
    idx1 = torch.where(inside, v * size + u, torch.zeros_like(u)).long()
    z_seen = ((pts1[idx1] - origin1) @ rot1)[:, 2]
    ok = inside & valid1[idx1] & ((z_seen - zc).abs() <= depth_tol * zc)
    # One view-0 pixel a view-1 pixel: the one with the largest key.
    key = torch.rand(ok.shape, generator=g, device=device)
    key = torch.where(ok, key, torch.full_like(key, -1.0))
    best = torch.full((size * size,), -1.0, device=device).scatter_reduce(
        0, idx1, key, reduce="amax")
    ok &= key == best[idx1]
    found = int(ok.sum())
    if found < matches:
        raise ValueError(f"a pair holds {found} correspondences, fewer than {matches}")
    pick = torch.where(ok, key, torch.full_like(key, -1.0)).topk(matches).indices
    return pick, idx1[pick]


def make(params: dict, size: int, batch: int, matches: int, seed: int, device,
         cameras: bool = False):
    """(img0, img1 (P, S, S, 3) in [0, 1], pts0, pts1 (P, S, S, 3) in view
    0's frame, valid0, valid1 (P, S, S) bool, corr0, corr1 (P, M) int64);
    with `cameras`, also view 1's camera-to-world rotations (P, 3, 3) and
    centres (P, 3)."""
    n = int(params["pool"]) // batch * batch
    g = torch.Generator(device=device).manual_seed(seed)
    per_scene = _cycled(params["rects_per_scene"], batch, n, g, device).tolist()
    r_max = max(params["rects_per_scene"])
    focal = float(params["focal_share"]) * size
    rays = _rays(size, focal, device)
    lo, hi = params["rotation_deg"]
    out = [[] for _ in range(10)]
    for i in range(n):
        scene = _scene(per_scene[i], r_max, params, focal, size, g, device)
        centre = float(_uniform(*params["centre_depths"], (), g, device))
        sign = 1.0 if float(torch.rand((), generator=g, device=device)) < 0.5 else -1.0
        angle = torch.deg2rad(_uniform(lo, hi, (), g, device)) * sign
        rot1 = _rot_y(angle)                                   # camera 1 to world
        pivot = torch.tensor([0.0, 0.0, centre], device=device)
        origin1 = pivot - rot1 @ pivot
        views = []
        for rot, origin in ((torch.eye(3, device=device), torch.zeros(3, device=device)),
                            (rot1, origin1)):
            t, pts, paint = scene.cast(origin, rays @ rot.T)
            noise = 0.03 * torch.randn(paint.shape, generator=g, device=device)
            image = (paint + noise).clamp(0.0, 1.0)
            valid = torch.isfinite(t) & (
                torch.rand(t.shape, generator=g, device=device) >= params["invalid_share"])
            pts = torch.where(torch.isfinite(t)[:, None], pts, torch.zeros_like(pts))
            views.append((image, pts, valid))
        (im0, p0, v0), (im1, p1, v1) = views
        c0, c1 = _correspondences(p0, v0, p1, v1, rot1, origin1, focal, size, matches,
                                  float(params["depth_tol"]), g, device)
        for lst, t in zip(out, (im0, im1, p0, p1, v0, v1, c0, c1, rot1, origin1)):
            lst.append(t)
    shapes = [(size, size, 3)] * 4 + [(size, size)] * 2 + [(matches,)] * 2 + [(3, 3), (3,)]
    pool = tuple(torch.stack(lst).reshape(n, *shp).contiguous()
                 for lst, shp in zip(out, shapes))
    return pool if cameras else pool[:8]
