"""Perspective-n-Point: batched DLT + Gauss-Newton + hypothesis-batch RANSAC.

Counterpart of `labelany3d_tpu/geometry/pnp.py`: T minimal 6-point subsets
are solved at once by DLT (the near-null vector of a 12x12 normal matrix by
shifted inverse iteration from an all-ones start), scored by a (T, N)
reprojection-error matrix, and the winner's inliers are polished by a
fixed-iteration damped Gauss-Newton on SE(3). Every function broadcasts
over leading batch dims, so `solve_pnp_ransac` solves all of an image's
objects in one call.

The RANSAC draws come in as a tensor (parity tests compute them with
`jax.random` from the JAX package's keys) or from a `torch.Generator`.
Factorisations that can fail (`cholesky_ex`, `solve_ex`) report instead of
raising, as XLA's do: a degenerate sample gives a non-finite hypothesis that
scores no inliers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from labelany3d_tpu_torch.geometry.transforms import so3_exp
from labelany3d_tpu_torch.utils.precision import f32_precision


def _smallest_eigvec_12(ata: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Near-null eigenvector of batched PSD (..., 12, 12) matrices: one
    Cholesky factorisation, then `iters` inverse-iteration sweeps of two
    triangular solves each, from an all-ones start."""
    n = ata.shape[-1]
    eye = torch.eye(n, dtype=ata.dtype, device=ata.device)
    eps = 1e-6 * ata.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-12
    chol, _ = torch.linalg.cholesky_ex(ata + eps * eye)
    x = torch.ones(*ata.shape[:-1], 1, dtype=ata.dtype, device=ata.device)
    for _ in range(iters):
        y = torch.linalg.solve_triangular(chol, x, upper=False)
        x = torch.linalg.solve_triangular(chol.mT, y, upper=True)
        x = x / x.norm(dim=-2, keepdim=True).clamp_min(1e-20)
    return x[..., 0]


class PnPResult(NamedTuple):
    rotation: torch.Tensor     # (..., 3, 3) world->camera
    translation: torch.Tensor  # (..., 3)
    inliers: torch.Tensor      # (..., N) bool
    error: torch.Tensor        # mean reprojection error, cv2.norm semantics
    ok: torch.Tensor           # (...) bool


def _project(points: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    cam = torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]
    z = cam[..., 2:3]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    xy = cam[..., :2] / z
    fx, fy = K[..., 0, 0][..., None], K[..., 1, 1][..., None]
    cx, cy = K[..., 0, 2][..., None], K[..., 1, 2][..., None]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


@f32_precision
def reprojection_error(obj_pts, img_pts, K, R, t, valid=None) -> torch.Tensor:
    """cv2-style error: ||all residuals||_2 / N over the valid points."""
    diff = _project(obj_pts, K, R, t) - img_pts
    if valid is not None:
        diff = torch.where(valid[..., None], diff, torch.zeros_like(diff))
        n = valid.sum(-1).clamp_min(1)
    else:
        n = obj_pts.shape[-2]
    return torch.sqrt((diff * diff).sum(dim=(-2, -1))) / n


@f32_precision
def solve_pnp_dlt(obj_pts: torch.Tensor, img_pts: torch.Tensor, K: torch.Tensor,
                  weights: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """DLT for the projection matrix from (..., N, 3) object and (..., N, 2)
    pixel points (N >= 6); returns (R, t). The rotation is orthonormalised by
    SVD (R = U diag(1, 1, det) V^T, which does not depend on the factors'
    signs) and the global sign of the null vector is fixed by majority
    cheirality."""
    obj, img = obj_pts.float(), img_pts.float()
    Kinv = torch.linalg.inv_ex(K.float())[0]
    ones = torch.ones(*img.shape[:-1], 1, dtype=torch.float32, device=img.device)
    norm = torch.einsum("...ij,...nj->...ni", Kinv, torch.cat([img, ones], dim=-1))
    u, v = norm[..., 0], norm[..., 1]

    xh = torch.cat([obj, ones], dim=-1)                            # (..., N, 4)
    zero = torch.zeros_like(xh)
    row_u = torch.cat([xh, zero, -u[..., None] * xh], dim=-1)      # (..., N, 12)
    row_v = torch.cat([zero, xh, -v[..., None] * xh], dim=-1)
    a = torch.cat([row_u, row_v], dim=-2)                          # (..., 2N, 12)
    if weights is not None:
        w = weights.float()
        a = a * torch.cat([w, w], dim=-1)[..., None]
    ata = torch.einsum("...ni,...nj->...ij", a, a)
    P = _smallest_eigvec_12(ata).reshape(*ata.shape[:-2], 3, 4)

    M = P[..., :3]
    # A non-finite system (a zero focal makes K^-1 infinite) has no pose: its
    # R and t are NaN, as the JAX SVD returns them, where torch's would raise.
    bad = ~torch.isfinite(M).flatten(-2).all(-1)
    uM, sM, vMt = torch.linalg.svd(torch.where(bad[..., None, None], torch.zeros_like(M), M))
    scale = sM.mean(-1).clamp_min(1e-12)
    det = torch.linalg.det(uM @ vMt)
    ones2 = torch.ones(*det.shape, 2, dtype=torch.float32, device=det.device)
    d_pos = torch.cat([ones2, det[..., None]], dim=-1)
    R_pos = torch.einsum("...ik,...k,...kj->...ij", uM, d_pos, vMt)
    t_pos = P[..., 3] / scale[..., None]
    d_neg = torch.cat([ones2, -det[..., None]], dim=-1)
    R_neg = torch.einsum("...ik,...k,...kj->...ij", -uM, d_neg, vMt)
    t_neg = -t_pos

    def front_count(R, t):
        cam_z = (torch.einsum("...ij,...nj->...ni", R, obj) + t[..., None, :])[..., 2]
        return (cam_z > 0).sum(-1)

    use_neg = front_count(R_neg, t_neg) > front_count(R_pos, t_pos)
    nan = torch.tensor(float("nan"), device=M.device)
    return (torch.where(bad[..., None, None], nan,
                        torch.where(use_neg[..., None, None], R_neg, R_pos)),
            torch.where(bad[..., None], nan, torch.where(use_neg[..., None], t_neg, t_pos)))


@f32_precision
def refine_pose_gauss_newton(obj_pts, img_pts, K, R0, t0, weights=None, iterations: int = 10,
                             damping: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton on SE(3) (left-multiplicative so(3) update)
    minimising the weighted reprojection error, a fixed number of steps."""
    obj, img, K = obj_pts.float(), img_pts.float(), K.float()
    w = torch.ones(obj.shape[:-1], device=obj.device) if weights is None else weights.float()
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    eye6 = torch.eye(6, device=obj.device)
    R, t = R0.float(), t0.float()
    for _ in range(iterations):
        cam = torch.einsum("...ij,...nj->...ni", R, obj) + t[..., None, :]
        z = torch.where(cam[..., 2].abs() > 1e-9, cam[..., 2], torch.full_like(cam[..., 2], 1e-9))
        inv_z = 1.0 / z
        px, py = cam[..., 0], cam[..., 1]
        u = fx[..., None] * px * inv_z + K[..., 0, 2][..., None]
        v = fy[..., None] * py * inv_z + K[..., 1, 2][..., None]
        r_u, r_v = u - img[..., 0], v - img[..., 1]
        zeros = torch.zeros_like(inv_z)
        du_dp = torch.stack([fx[..., None] * inv_z, zeros, -fx[..., None] * px * inv_z ** 2],
                            dim=-1)
        dv_dp = torch.stack([zeros, fy[..., None] * inv_z, -fy[..., None] * py * inv_z ** 2],
                            dim=-1)
        # cam' = exp(w) cam + dt: d cam / d w = -[cam]_x, d cam / d dt = I.
        J_u = torch.cat([-torch.linalg.cross(du_dp, cam, dim=-1), du_dp], dim=-1)
        J_v = torch.cat([-torch.linalg.cross(dv_dp, cam, dim=-1), dv_dp], dim=-1)
        J = torch.cat([J_u, J_v], dim=-2)                           # (..., 2N, 6)
        r = torch.cat([r_u, r_v], dim=-1)
        ww = torch.cat([w, w], dim=-1)
        JtJ = torch.einsum("...ni,...n,...nj->...ij", J, ww, J)
        Jtr = torch.einsum("...ni,...n,...n->...i", J, ww, r)
        lam = damping * (JtJ.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / 6.0
                         ).clamp_min(1e-12)
        delta = -torch.linalg.solve_ex(JtJ + lam * eye6, Jtr[..., None])[0][..., 0]
        dR = so3_exp(delta[..., :3])
        R, t = dR @ R, torch.einsum("...ij,...j->...i", dR, t) + delta[..., 3:]
    return R, t


def draw_pnp_samples(n_valid: torch.Tensor, num_trials: int = 256, sample_size: int = 6,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """(...) valid counts -> (..., T, S) RANSAC draws in [0, max(n_valid, 1))."""
    hi = n_valid.clamp_min(1).to(torch.float64)[..., None, None]
    u = torch.rand(*n_valid.shape, num_trials, sample_size, generator=generator,
                   dtype=torch.float64, device=n_valid.device)
    return (u * hi).floor().long()


@f32_precision
def solve_pnp_ransac(obj_pts: torch.Tensor, img_pts: torch.Tensor, K: torch.Tensor,
                     valid: torch.Tensor, draws: torch.Tensor | None = None, *,
                     generator: torch.Generator | None = None, num_trials: int = 256,
                     sample_size: int = 6, reproj_threshold: float = 20.0,
                     refine_iterations: int = 10, min_inliers: int = 6) -> PnPResult:
    """Hypothesis-batch RANSAC PnP over (B, N) correspondence sets sharing
    one K. `draws` (B, T, S) are ranks among each set's valid points, in
    [0, max(n_valid, 1)); without them they come from `generator`."""
    obj, img, valid = obj_pts.float(), img_pts.float(), valid.bool()
    K = K.float()
    n_valid = valid.sum(-1)
    if draws is None:
        draws = draw_pnp_samples(n_valid, num_trials, sample_size, generator)
    b, t, s = draws.shape
    # Rank among the valid points -> point index (searchsorted side='right').
    cdf = valid.long().cumsum(-1)
    idx = torch.searchsorted(cdf, draws.reshape(b, t * s).to(cdf.device), right=True)
    idx = idx.clamp_max(obj.shape[-2] - 1).reshape(b, t, s)
    rows = torch.arange(b, device=obj.device)[:, None, None]
    R_t, t_t = solve_pnp_dlt(obj[rows, idx], img[rows, idx], K)     # (B, T, ...)

    proj = _project(obj[:, None], K, R_t, t_t)                     # (B, T, N, 2)
    err = (proj - img[:, None]).norm(dim=-1)
    inl = (err < reproj_threshold) & valid[:, None]
    score = inl.sum(-1)
    best = score.argmax(-1)                                        # first maximum
    ar = torch.arange(b, device=obj.device)
    R_best, t_best, best_inliers = R_t[ar, best], t_t[ar, best], inl[ar, best]

    enough = score[ar, best] >= min_inliers
    R_ref, t_ref = refine_pose_gauss_newton(obj, img, K, R_best, t_best,
                                            weights=best_inliers.float(),
                                            iterations=refine_iterations)
    err_ref = (_project(obj, K, R_ref, t_ref) - img).norm(dim=-1)
    inliers = (err_ref < reproj_threshold) & valid
    error = reprojection_error(obj, img, K, R_ref, t_ref, valid=valid)
    ok = enough & (n_valid >= sample_size)
    return PnPResult(rotation=R_ref, translation=t_ref, inliers=inliers, error=error, ok=ok)
