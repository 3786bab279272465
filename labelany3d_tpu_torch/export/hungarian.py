"""IoU-based bipartite matching: the exact host solver (scipy) and the
Jacobi auction on the device.

Counterpart of `labelany3d_tpu/export/hungarian.py`. `hungarian_match` is
the export stage's solver; it scores a pair with a non-finite IoU 0 where
the JAX version raises. `auction_assignment` computes the same matching as
a loop of tensor ops, within N * eps of the optimum, for one problem or a
batch of padded ones (a leading dim in place of the JAX package's `vmap`).
"""

from __future__ import annotations

import numpy as np
import torch

from labelany3d_tpu_torch.utils.device import tensors_on


def iou2d_matrix(boxes0, boxes1, *, device=None) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) x (..., M, 4) xyxy boxes -> (..., N, M),
    with a 1e-6 denominator epsilon and no clamping of degenerate boxes."""
    b0, b1 = tensors_on(boxes0, boxes1, device=device)
    b0, b1 = b0[..., :, None, :], b1[..., None, :, :]
    x1 = torch.maximum(b0[..., 0], b1[..., 0])
    y1 = torch.maximum(b0[..., 1], b1[..., 1])
    x2 = torch.minimum(b0[..., 2], b1[..., 2])
    y2 = torch.minimum(b0[..., 3], b1[..., 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    a0 = (b0[..., 2] - b0[..., 0]) * (b0[..., 3] - b0[..., 1])
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    return inter / (a0 + a1 - inter + 1e-6)


def hungarian_match(boxes0: np.ndarray, boxes1: np.ndarray) -> list[tuple[int, int, float]]:
    """Exact IoU matching of xyxy boxes; returns [(i, j, iou), ...]."""
    from scipy.optimize import linear_sum_assignment

    b0 = np.asarray(boxes0, np.float32)[:, None, :]
    b1 = np.asarray(boxes1, np.float32)[None, :, :]
    x1 = np.maximum(b0[..., 0], b1[..., 0])
    y1 = np.maximum(b0[..., 1], b1[..., 1])
    x2 = np.minimum(b0[..., 2], b1[..., 2])
    y2 = np.minimum(b0[..., 3], b1[..., 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    a0 = (b0[..., 2] - b0[..., 0]) * (b0[..., 3] - b0[..., 1])
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    iou = inter / (a0 + a1 - inter + 1e-6)
    # A box projected from corners behind the camera has non-finite edges;
    # it overlaps nothing (scipy refuses NaN, so the JAX version raises).
    iou = np.where(np.isfinite(iou), iou, 0.0)
    rows, cols = linear_sum_assignment(-iou)
    return [(int(i), int(j), float(iou[i, j])) for i, j in zip(rows, cols)]


@torch.inference_mode()
def auction_assignment(benefit, row_valid=None, col_valid=None, num_iters: int = 256,
                       eps: float = 1e-4, *, device=None) -> torch.Tensor:
    """Jacobi auction: assign each valid row a distinct valid column,
    maximising the total benefit (it terminates when valid rows are no more
    than valid columns).

    `benefit` is (N, M) or a batch (B, N, M); `row_valid` (..., N) and
    `col_valid` (..., M) mark padding slots. Each of `num_iters` rounds, every
    unassigned valid row bids for its best column by the margin over its
    second best plus `eps`; each column goes to its highest bid (the lowest
    row on a tie) and its price rises by that bid. Returns the assigned
    column per row (int64, the batch's shape); -1 for invalid rows and rows
    still unassigned.
    """
    b, row_valid, col_valid = tensors_on(benefit, row_valid, col_valid, device=device,
                                         dtype=None)
    b = b.float()
    single = b.dim() == 2
    if single:
        b = b[None]
    nb, n, m = b.shape
    dev = b.device
    row_valid = (torch.ones(n, dtype=torch.bool, device=dev) if row_valid is None
                 else row_valid.bool()).expand(nb, n)
    col_valid = (torch.ones(m, dtype=torch.bool, device=dev) if col_valid is None
                 else col_valid.bool()).expand(nb, m)
    neg = -1e30
    b = torch.where(col_valid[:, None, :], b, neg)
    cols = torch.arange(m, device=dev).expand(nb, m)
    prices = torch.zeros(nb, m, device=dev)
    assigned = torch.full((nb, n), -1, dtype=torch.long, device=dev)
    for _ in range(num_iters):
        net = b - prices[:, None, :]
        best_j = net.argmax(-1)  # the lowest column on a tie, as a stable argsort
        best = torch.nn.functional.one_hot(best_j, m).bool()
        best_v = net.gather(-1, best_j[..., None])[..., 0]
        second_v = (torch.where(best, float("-inf"), net).amax(-1) if m > 1
                    else best_v - eps)
        bid = best_v - second_v + eps
        bidding = (assigned < 0) & row_valid
        col_bid = torch.where(bidding[..., None] & best, bid[..., None], neg)
        win_bid, win_row = col_bid.amax(1), col_bid.argmax(1)  # the lowest row on a tie
        has_bid = win_bid > neg / 2
        prices = torch.where(has_bid, prices + win_bid, prices)
        # Rows whose column changed hands lose it; each winner takes its
        # column (a row bids for one column, so it wins at most one). Columns
        # without a bid write to a dropped slot n.
        lost = (assigned >= 0) & has_bid.gather(1, assigned.clamp(0, m - 1))
        assigned = torch.where(lost, -1, assigned)
        slots = torch.cat([assigned, assigned.new_zeros(nb, 1)], dim=1)
        slots.scatter_(1, torch.where(has_bid, win_row, n), cols)
        assigned = slots[:, :n]
    # A valid row may still hold a masked column (more valid rows than valid
    # columns): the result is gated on column validity too.
    ok = (assigned >= 0) & col_valid.gather(1, assigned.clamp(0, m - 1)) & row_valid
    out = torch.where(ok, assigned, -1)
    return out[0] if single else out
