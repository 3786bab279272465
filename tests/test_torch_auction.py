"""`export/hungarian.py`'s `iou2d_matrix` and `auction_assignment` against
the JAX package on the CPU.

The auction runs the same float32 arithmetic as the JAX `fori_loop` (the
best column by first-index argmax, the runner-up as the best of the rest,
each column to its highest bid, the lowest row on a tie), so assignments
must be equal, padding rows and invalid columns included, one problem or
a batch (the JAX side `vmap`ped). Against scipy's exact solver the total
benefit must be within N * eps. IoUs: 1e-6 absolute (float32, the same
formula).
"""

import jax
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from labelany3d_tpu.export import hungarian as jhungarian
from labelany3d_tpu_torch.export import hungarian

torch.set_num_threads(1)

IOU_TOL = 1e-6
EPS = 1e-4


def _boxes(rng, shape):
    xy = rng.uniform(0, 200, (*shape, 2))
    wh = rng.uniform(5, 80, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_iou2d_matrix_matches_jax(batch):
    rng = np.random.default_rng(0)
    b0, b1 = _boxes(rng, (*batch, 9)), _boxes(rng, (*batch, 6))
    b1[..., 0, :] = b0[..., 0, :]  # one exact overlap
    got = hungarian.iou2d_matrix(b0, b1, device="cpu").numpy()
    want = np.asarray(jhungarian.iou2d_matrix(b0, b1))
    assert got.shape == (*batch, 9, 6)
    np.testing.assert_allclose(got, want, atol=IOU_TOL)
    np.testing.assert_allclose(got[..., 0, 0], 1.0, atol=1e-6)


def _problem(seed, n, m, pad_rows, bad_cols):
    rng = np.random.default_rng(seed)
    iou = np.asarray(hungarian.iou2d_matrix(_boxes(rng, (n,)), _boxes(rng, (m,)),
                                            device="cpu"))
    iou = np.maximum(iou, rng.uniform(0, 0.3, (n, m)).astype(np.float32))
    row_valid = np.arange(n) < n - pad_rows
    col_valid = np.ones(m, bool)
    col_valid[rng.choice(m, bad_cols, replace=False)] = False
    return iou, row_valid, col_valid


@pytest.mark.parametrize("seed,n,m,pad_rows,bad_cols", [
    (1, 8, 8, 0, 0), (2, 12, 16, 3, 2), (3, 10, 7, 2, 3), (4, 16, 16, 5, 0), (5, 1, 4, 0, 1),
])
def test_auction_matches_jax(seed, n, m, pad_rows, bad_cols):
    iou, rv, cv = _problem(seed, n, m, pad_rows, bad_cols)
    got = hungarian.auction_assignment(iou, rv, cv, eps=EPS, device="cpu").numpy()
    want = np.asarray(jhungarian.auction_assignment(iou, rv, cv, eps=EPS))
    np.testing.assert_array_equal(got, want)
    assert (got[~rv] == -1).all() and not np.isin(np.flatnonzero(~cv), got).any()
    taken = got[got >= 0]
    assert len(taken) == len(set(taken.tolist()))
    if rv.sum() <= cv.sum():  # every valid row assigned, within N * eps of the optimum
        assert (got[rv] >= 0).all()
        rows, cols = linear_sum_assignment(-np.where(rv[:, None] & cv[None], iou, -1e6))
        best = sum(iou[r, c] for r, c in zip(rows, cols) if rv[r] and cv[c])
        total = sum(iou[r, c] for r, c in enumerate(got) if c >= 0)
        assert total >= best - n * EPS


def test_auction_batch_matches_vmapped_jax():
    probs = [_problem(10 + i, 12, 12, i, 2 - i % 3) for i in range(4)]
    iou, rv, cv = (np.stack(x) for x in zip(*probs))
    got = hungarian.auction_assignment(torch.from_numpy(iou), torch.from_numpy(rv),
                                       torch.from_numpy(cv), eps=EPS).numpy()
    want = np.asarray(jax.vmap(lambda b, r, c: jhungarian.auction_assignment(
        b, r, c, eps=EPS))(iou, rv, cv))
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got, want)
    for i, p in enumerate(probs):  # a batch row is its problem alone
        np.testing.assert_array_equal(got[i], hungarian.auction_assignment(
            *p, eps=EPS, device="cpu").numpy())


def test_auction_without_masks_and_few_iterations_matches_jax():
    iou, _, _ = _problem(20, 9, 9, 0, 0)
    for iters in (1, 3, 256):
        got = hungarian.auction_assignment(iou, num_iters=iters, device="cpu").numpy()
        want = np.asarray(jhungarian.auction_assignment(iou, num_iters=iters))
        np.testing.assert_array_equal(got, want)
