"""Closed-form rigid and similarity registration (Kabsch, Umeyama), weighted
and batched over leading dims; counterpart of
`labelany3d_tpu/geometry/procrustes.py`. No route calls it: it solves the
registration problem when 3D-3D correspondences are known. Float32 with
TF32 off; numpy inputs go to the card unless `device="cpu"`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from labelany3d_tpu_torch.utils.device import tensors_on
from labelany3d_tpu_torch.utils.precision import f32_precision


class SimilarityTransform(NamedTuple):
    rotation: torch.Tensor     # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)
    scale: torch.Tensor        # (...)


def _weighted_centroid(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    wsum = w.sum(-1, keepdim=True).clamp_min(1e-12)
    return (pts * w[..., None]).sum(-2) / wsum


def _centred(src, dst, weights, device):
    src, dst, w = tensors_on(src, dst, weights, device=device)
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=torch.float32, device=src.device)
    mu_s, mu_d = _weighted_centroid(src, w), _weighted_centroid(dst, w)
    cs, cd = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", cd * w[..., None], cs)
    return w, mu_s, mu_d, cs, cov


def _rotation(cov: torch.Tensor):
    """U diag(1, 1, det(U Vt)) Vt from the SVD of `cov`, the singular values
    and the diagonal."""
    u, s_vals, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(*det.shape, 2, dtype=det.dtype, device=det.device),
                   det[..., None]], dim=-1)
    return torch.einsum("...ik,...k,...kj->...ij", u, d, vt), s_vals, d


@f32_precision
def kabsch(src, dst, weights=None, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment: R, t minimizing ||w (R src + t - dst)||^2.
    src, dst: (..., N, 3); weights: (..., N) or None."""
    _, mu_s, mu_d, _, cov = _centred(src, dst, weights, device)
    r, _, _ = _rotation(cov)
    return r, mu_d - torch.einsum("...ij,...j->...i", r, mu_s)


@f32_precision
def umeyama(src, dst, weights=None, *, device=None) -> SimilarityTransform:
    """Weighted similarity alignment: s, R, t minimizing
    ||w (s R src + t - dst)||^2 (Umeyama 1991)."""
    w, mu_s, mu_d, cs, cov = _centred(src, dst, weights, device)
    wsum = w.sum(-1).clamp_min(1e-12)
    cov = cov / wsum[..., None, None]
    var_s = (w * (cs * cs).sum(-1)).sum(-1) / wsum
    r, s_vals, d = _rotation(cov)
    scale = (s_vals * d).sum(-1) / var_s.clamp_min(1e-12)
    t = mu_d - scale[..., None] * torch.einsum("...ij,...j->...i", r, mu_s)
    return SimilarityTransform(rotation=r, translation=t, scale=scale)
