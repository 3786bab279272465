"""The two-view matcher's training objective: MASt3R's pointmap and
matching losses on view pairs, for `parallel/train.py::make_train_step`.

A batch is (img0, img1, pts0, pts1, valid0, valid1, corr0, corr1): images
(P, H, W, 3); ground-truth pointmaps (P, H, W, 3) of both views in view
0's camera frame; valid masks (P, H, W); `corr0`, `corr1` (P, M) flat pixel
indices (y * W + x) of M ground-truth correspondences. Each pair's loss is
its own and the batch loss is their mean, so a batch may be split by pairs.
Per pair, with X the predicted points, X̄ the ground truth, C the point
confidence, D the descriptors and Q their confidence (the `catmlpdpt`
head's eight outputs):

  * regression (DUSt3R eq. 2): l_i = ||X_i / z - X̄_i / z̄||, z and z̄ the
    mean norm of the predicted and ground-truth points over the valid
    pixels of both views (`avg_dis`);
  * confidence (eq. 3): L_conf = sum over both views' valid pixels of
    (C_i l_i - ALPHA log C_i), over the number of valid pixels;
  * matching (MASt3R eq. 4, InfoNCE): S = D0[corr0] D1[corr1]^T / TAU,
    l_k = (CE(S[k, :], k) + CE(S[:, k], k)) / 2, c_k = (Q0[corr0_k] +
    Q1[corr1_k]) / 2, L_match = mean_k (c_k l_k - ALPHA_MATCH log c_k);
  * L = L_conf + BETA L_match.

Every pixel enters the sums, masks acting as weights, and the
correspondences are fixed-count index tensors, so the loss waits for the
card nowhere (no boolean indexing, no `.item()`).
"""

from __future__ import annotations

import torch

from labelany3d_tpu_torch.parallel.mesh import axis_size
from labelany3d_tpu_torch.utils.profiling import annotate

ALPHA = 0.2          # confidence regulariser of the pointmap loss
TAU = 0.05           # InfoNCE temperature
ALPHA_MATCH = 10.0   # confidence regulariser of the matching loss
BETA = 0.075         # weight of the matching loss


def _masked_mean_norm(pts0, pts1, w0, w1, n) -> torch.Tensor:
    """(P,) mean point norm over both views' weighted pixels."""
    s = (pts0.norm(dim=-1) * w0).sum((1, 2)) + (pts1.norm(dim=-1) * w1).sum((1, 2))
    return s / n


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P, H, W, C) or (P, H, W) maps at (P, M) flat pixel indices."""
    flat = t.reshape(t.shape[0], -1, *t.shape[3:])
    if flat.dim() == 2:
        return flat.gather(1, idx)
    return flat.gather(1, idx[..., None].expand(-1, -1, flat.shape[-1]))


def pair_losses(out: dict, pts0, pts1, valid0, valid1, corr0, corr1) -> torch.Tensor:
    """(P,) float32: each pair's L_conf + BETA L_match from the matcher's
    outputs `out`."""
    w0, w1 = valid0.float(), valid1.float()
    n = (w0.sum((1, 2)) + w1.sum((1, 2))).clamp_min(1.0)
    x0, x1 = out["pts3d0"].float(), out["pts3d1"].float()
    g0, g1 = pts0.float(), pts1.float()
    z = _masked_mean_norm(x0, x1, w0, w1, n).clamp_min(1e-8)[:, None, None, None]
    zg = _masked_mean_norm(g0, g1, w0, w1, n).clamp_min(1e-8)[:, None, None, None]
    conf = 0.0
    for x, g, c, w in ((x0, g0, out["conf0"], w0), (x1, g1, out["conf1"], w1)):
        err = torch.linalg.vector_norm(x / z - g / zg, dim=-1)
        c = c.float()
        conf = conf + ((c * err - ALPHA * torch.log(c)) * w).sum((1, 2))
    conf = conf / n

    d0 = _gather(out["desc0"].float(), corr0)
    d1 = _gather(out["desc1"].float(), corr1)
    s = torch.bmm(d0, d1.transpose(1, 2)) / TAU                     # (P, M, M)
    diag = s.diagonal(dim1=1, dim2=2)
    nce = 0.5 * ((torch.logsumexp(s, dim=2) - diag) + (torch.logsumexp(s, dim=1) - diag))
    ck = 0.5 * (_gather(out["desc_conf0"].float(), corr0)
                + _gather(out["desc_conf1"].float(), corr1))
    match = (ck * nce - ALPHA_MATCH * torch.log(ck)).mean(1)
    return conf + BETA * match


def pair_objective(model, img0, img1, pts0, pts1, valid0, valid1, corr0, corr1,
                   mesh=None) -> torch.Tensor:
    """The mean over pairs of `pair_losses` of `model(img0, img1)`: the
    objective `make_train_step(..., objective=pair_objective)` takes. Span
    `train.loss` around the loss. It runs without a data axis over 1: the
    step sums the ranks' gradients, and a mean over each rank's pairs would
    need dividing by the data axis first."""
    if mesh is not None and axis_size(mesh, "data") > 1:
        raise ValueError("the pair objective runs without a data axis over 1, got "
                         f"{axis_size(mesh, 'data')}")
    out = model(img0, img1)
    with annotate("train.loss"):
        return pair_losses(out, pts0, pts1, valid0, valid1, corr0, corr1).mean()
