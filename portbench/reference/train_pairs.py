"""Plain fine-tuning step of the reference for the two-view matcher:
MASt3R's pointmap and matching losses written from the equations, a loop
over pairs in float32 with TF32 off, and AdamW (`reference/train.py`).

A batch is (img0, img1, pts0, pts1, valid0, valid1, corr0, corr1) (see
`gen/view_pairs.py`); both ground-truth pointmaps lie in view 0's frame.
Per pair, over the valid pixels of both views (boolean selections here):

  * regression (DUSt3R, arXiv:2312.14132, eq. 2): l_i = ||X_i / z -
    X̄_i / z̄||, z and z̄ the mean norm of the predicted and ground-truth
    points over both views' valid pixels (`avg_dis`);
  * confidence (eq. 3): L_conf = sum_i (C_i l_i - ALPHA log C_i) / n, over
    both views' n valid pixels;
  * matching (MASt3R, arXiv:2406.09756, eq. 4, InfoNCE): S = D0[corr0]
    D1[corr1]^T / TAU, l_k the mean of the cross entropies of row k and of
    column k against k, c_k = (Q0[corr0_k] + Q1[corr1_k]) / 2, L_match =
    mean_k (c_k l_k - ALPHA_MATCH log c_k);
  * L = L_conf + BETA L_match; the batch loss is the mean over pairs.

Departures from the papers: the release averages the regression and
confidence terms over the valid pixels of the whole batch, view by view,
and sums the views; here each pair's terms are pooled over its two views
and the pairs averaged, so that a batch splits exactly by pairs. The
release's metric rule (z := z̄ on metric data) is left out. The
coefficients follow the training command of the MASt3R repository's
README (ALPHA 0.2, TAU 0.05, ALPHA_MATCH 10, BETA 0.075).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import full_f32
from .train import AdamW

ALPHA, TAU, ALPHA_MATCH, BETA = 0.2, 0.05, 10.0, 0.075


def pair_loss(out: dict, p: int, pts0, pts1, valid0, valid1, corr0, corr1) -> torch.Tensor:
    """Pair `p`'s loss from the matcher's outputs `out` over a batch whose
    row `p` the ground truth (one pair's: (H, W, 3), (H, W), (M,)) is."""
    preds = [out["pts3d0"][p].float(), out["pts3d1"][p].float()]
    gts = [pts0.float(), pts1.float()]
    confs = [out["conf0"][p].float(), out["conf1"][p].float()]
    valid = [valid0.bool(), valid1.bool()]
    x = [t[v] for t, v in zip(preds, valid)]                  # (n_v, 3)
    g = [t[v] for t, v in zip(gts, valid)]
    c = [t[v] for t, v in zip(confs, valid)]
    n = sum(t.shape[0] for t in x)
    z = sum(t.norm(dim=1).sum() for t in x) / n
    zg = sum(t.norm(dim=1).sum() for t in g) / n
    l_conf = sum((ci * (xi / z - gi / zg).norm(dim=1) - ALPHA * torch.log(ci)).sum()
                 for xi, gi, ci in zip(x, g, c)) / n

    d = out["desc0"].shape[-1]
    d0 = out["desc0"][p].float().reshape(-1, d)[corr0]
    d1 = out["desc1"][p].float().reshape(-1, d)[corr1]
    s = d0 @ d1.T / TAU
    k = torch.arange(s.shape[0], device=s.device)
    nce = 0.5 * (F.cross_entropy(s, k, reduction="none")
                 + F.cross_entropy(s.T, k, reduction="none"))
    ck = 0.5 * (out["desc_conf0"][p].float().reshape(-1)[corr0]
                + out["desc_conf1"][p].float().reshape(-1)[corr1])
    l_match = (ck * nce - ALPHA_MATCH * torch.log(ck)).mean()
    return l_conf + BETA * l_match


def loss_and_grads(model, batch, micro: int) -> tuple[float, list]:
    """The batch loss and every parameter's gradient (zeros where the loss
    does not reach), `micro` pairs a forward."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    img0, img1, pts0, pts1, valid0, valid1, corr0, corr1 = batch
    n_pairs = img0.shape[0]
    total = 0.0
    with full_f32(), torch.enable_grad():
        for a in range(0, n_pairs, micro):
            b = min(a + micro, n_pairs)
            out = model(img0[a:b], img1[a:b])
            loss = sum(pair_loss(out, j - a, pts0[j], pts1[j], valid0[j], valid1[j],
                                 corr0[j], corr1[j]) for j in range(a, b)) / n_pairs
            loss.backward()
            total += float(loss.detach())
            del out, loss
    grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p in params:
        p.grad = None
    return total, grads


def run_steps(model, batches, lr: float, micro: int) -> dict:
    """AdamW steps over `batches`: each step's loss, the first gradient,
    and each parameter's change over the steps (float32, on the
    parameters' device)."""
    start = [p.detach().clone() for p in model.parameters()]
    opt = AdamW(model.parameters(), lr)
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grads(model, batch, micro)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(grads)
        del grads
    change = [p.detach() - s for p, s in zip(model.parameters(), start)]
    return {"losses": losses, "grad": first, "change": change}
