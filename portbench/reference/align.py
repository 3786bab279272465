# Frozen copy of labelany3d_tpu_torch/geometry/align.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Robust 1-D linear depth alignment (hypothesis-batch RANSAC), batched.

Counterpart of `labelany3d_tpu/geometry/align.py`: all trials are drawn,
fitted in closed form and scored at once, then the best hypothesis' inliers
are refit by least squares over the full valid set. The inlier threshold is
the MAD of the targets (sklearn's default). Functions take a leading batch
axis; the random draws come in as `RansacDraws` (parity tests pass the JAX
package's draws) or from a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .reductions import masked_mad, masked_median

DEPTH_SENTINEL = 10000.0


class RansacDraws(NamedTuple):
    sub_idx: torch.Tensor    # (B, max_points) pixel indices in [0, N)
    trial_idx: torch.Tensor  # (B, T, S) subsample indices in [0, max_points)


def draw_ransac(batch: int, n: int, *, num_trials: int = 64, samples_per_trial: int = 64,
                max_points: int = 16384, generator: torch.Generator | None = None,
                device=None) -> RansacDraws:
    return RansacDraws(
        torch.randint(0, n, (batch, max_points), generator=generator, device=device),
        torch.randint(0, max_points, (batch, num_trials, samples_per_trial),
                      generator=generator, device=device),
    )


def fit_linear_1d(x, y, w, intercept: bool = True):
    """Weighted least squares y ~= a x (+ b) along the last axis.

    Zero-weight points are dropped before the products, so a non-finite
    value there (MoGe's inf outside its mask) cannot turn the sums into NaN.
    The JAX package multiplies first (0 * inf = NaN) and then falls back to
    a = 0, which zeroes the aligned depth of any image whose relative depth
    has a masked pixel; see ROADMAP.md, fault F4.
    """
    w = w.float()
    x = torch.where(w > 0, x, torch.zeros_like(x))
    y = torch.where(w > 0, y, torch.zeros_like(y))
    n = w.sum(-1).clamp_min(1e-12)
    sx = (w * x).sum(-1)
    sy = (w * y).sum(-1)
    sxx = (w * x * x).sum(-1)
    sxy = (w * x * y).sum(-1)
    zero = torch.zeros_like(sx)
    if intercept:
        denom = n * sxx - sx * sx
        a = torch.where(denom.abs() > 1e-12, (n * sxy - sx * sy) / denom, zero)
        b = (sy - a * sx) / n
    else:
        a = torch.where(sxx > 1e-12, sxy / sxx, zero)
        b = zero
    return a, b


class LinearFit(NamedTuple):
    scale: torch.Tensor
    shift: torch.Tensor
    inliers: torch.Tensor
    ok: torch.Tensor


def ransac_linear_1d(x, y, valid, draws: RansacDraws, *, intercept: bool = True) -> LinearFit:
    """Hypothesis-batch RANSAC for y ~= a x (+ b) over (B, N) masked arrays."""
    n_valid = valid.sum(-1)
    xs = x.gather(-1, draws.sub_idx)
    ys = y.gather(-1, draws.sub_idx)
    sub_ok = valid.gather(-1, draws.sub_idx) & (n_valid > 0)[:, None]
    thresh = masked_mad(ys, sub_ok).clamp_min(1e-12)

    b, t, s = draws.trial_idx.shape
    flat = draws.trial_idx.reshape(b, t * s)
    tx = xs.gather(-1, flat).reshape(b, t, s)
    ty = ys.gather(-1, flat).reshape(b, t, s)
    tw = sub_ok.gather(-1, flat).reshape(b, t, s).float()
    a_t, b_t = fit_linear_1d(tx, ty, tw, intercept=intercept)  # (B, T)

    resid = (ys[:, None, :] - (a_t[..., None] * xs[:, None, :] + b_t[..., None])).abs()
    score = ((resid < thresh[:, None, None]) & sub_ok[:, None, :]).sum(-1)
    best = score.argmax(-1, keepdim=True)  # first maximum, as jnp.argmax
    a0, b0 = a_t.gather(-1, best)[:, 0], b_t.gather(-1, best)[:, 0]

    full_inliers = ((y - (a0[:, None] * x + b0[:, None])).abs() < thresh[:, None]) & valid
    enough = full_inliers.sum(-1) >= 2
    a, bb = fit_linear_1d(x, y, full_inliers, intercept=intercept)
    a = torch.where(enough, a, a0)
    bb = torch.where(enough, bb, b0)
    ok = n_valid >= 2
    a = torch.where(ok, a, torch.ones_like(a))
    bb = torch.where(ok, bb, torch.zeros_like(bb))
    return LinearFit(scale=a, shift=bb, inliers=full_inliers, ok=ok)


def align_depth_affine(
    relative_depth: torch.Tensor,
    metric_depth: torch.Tensor,
    mask: torch.Tensor | None,
    draws: RansacDraws | None = None,
    *,
    intercept: bool = False,
    max_valid_depth: float | None = 400.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Align (B, H, W) scale-invariant depth to metric depth; (B, H, W).

    Sentinel 10000 outside the prediction mask; metric-depth fallback when
    an image has fewer than two valid points."""
    rel = relative_depth.float()
    met = metric_depth.float()
    b = rel.shape[0]
    finite_rel = torch.isfinite(rel)
    fit_valid = finite_rel
    if max_valid_depth is not None:
        fit_valid = fit_valid & (met < max_valid_depth)
    if mask is not None:
        mask = mask.bool()
        fit_valid = fit_valid & mask
        predict_region = mask
    else:
        predict_region = finite_rel
    if draws is None:
        draws = draw_ransac(b, rel[0].numel(), generator=generator, device=rel.device)
    fit = ransac_linear_1d(rel.reshape(b, -1), met.reshape(b, -1), fit_valid.reshape(b, -1),
                           draws, intercept=intercept)
    aligned = fit.scale[:, None, None] * rel + fit.shift[:, None, None]
    out = torch.where(predict_region, aligned, torch.full_like(aligned, DEPTH_SENTINEL))
    return torch.where(fit.ok[:, None, None], out, met)


def median_ratio_scale(scene_depth: torch.Tensor, render_depth: torch.Tensor,
                       overlap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Robust scale median(scene / render) over an overlap mask; returns
    (scale, has_overlap). Leading dims of `render_depth` and `overlap`
    batch over objects against one (H, W) scene depth."""
    render = render_depth.float()
    ratios = scene_depth.float() / torch.where(render != 0, render, torch.ones_like(render))
    overlap = overlap.bool() & (render != 0)
    scale = masked_median(ratios.flatten(-2), overlap.flatten(-2))
    return scale, overlap.flatten(-2).any(-1)
