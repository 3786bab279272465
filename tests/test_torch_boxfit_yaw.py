"""Min-area yaw (K4) and the `minarea_pallas` box fit: the port against the
JAX package.

`yaw_minarea` (the port's plain version on the CPU) is held against
`yaw_minarea_pallas(..., interpret=True)`. Both evaluate the same fp32
footprint area at each of 512 angles, with cos/sin from two libraries, so
the yaws are equal wherever the least area beats the runner-up by more than
1e-6 relative, and elsewhere the port's yaw has an area within 1e-6
relative of the least. `fit_boxes_batch(method='minarea_pallas')` is held
against the JAX package's (its Pallas kernel in interpret mode) to 1e-4 on
centres, dimensions, rotations and vertices.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import labelany3d_tpu.ops.boxfit_pallas as jbp
from labelany3d_tpu.geometry.boxfit import fit_boxes_batch as jfit_boxes_batch
from labelany3d_tpu_torch.geometry.boxfit import fit_boxes_batch
from labelany3d_tpu_torch.ops import boxfit_yaw as by

REL_TOL = 1e-6
BOX_TOL = 1e-4


def _clouds(rng, i, n):
    """Elongated point sets at random yaws, with random masks and one
    instance without any valid point."""
    pts = rng.standard_normal((i, n, 2)).astype(np.float32) * np.array([2.0, 0.5], np.float32)
    ang = rng.uniform(0, np.pi, i)
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2).astype(np.float32)
    pts = np.einsum("inj,ikj->ink", pts, rot)
    valid = rng.uniform(size=(i, n)) > 0.3
    valid[0] = False
    return pts, valid


@pytest.mark.parametrize("i,n", [(16, 500), (9, 37)])
def test_yaw_minarea_matches_jax(i, n):
    rng = np.random.default_rng(i)
    pts, valid = _clouds(rng, i, n)
    want = np.asarray(jbp.yaw_minarea_pallas(jnp.asarray(pts), jnp.asarray(valid),
                                             interpret=True))
    by.PLAIN_CALLS.reset()
    got = by.yaw_minarea(torch.from_numpy(pts), torch.from_numpy(valid))
    assert by.PLAIN_CALLS.count == 1 and by.KERNEL_LAUNCHES.count == 0
    area = by.footprint_areas(torch.from_numpy(pts), torch.from_numpy(valid)).double()
    top2 = area.topk(2, dim=-1, largest=False).values
    finite = torch.isfinite(top2[:, 0])
    clear = (~finite | ((top2[:, 1] - top2[:, 0]) > REL_TOL * top2[:, 0].abs())).numpy()
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    step = (math.pi / 2) / 512
    at = area.gather(1, torch.round(got / step).long()[:, None])[:, 0]
    excess = ((at - top2[:, 0]) / top2[:, 0].abs().clamp_min(1e-30)).numpy()[~clear]
    assert excess.size == 0 or excess.max() <= REL_TOL
    assert got[0] == 0.0 and want[0] == 0.0  # no valid point: the first angle


def test_yaw_minarea_kernel_route_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        by.yaw_minarea_kernel(torch.zeros(2, 4, 2), torch.ones(2, 4, dtype=torch.bool))


def test_fit_boxes_batch_minarea_pallas_matches_jax(monkeypatch):
    orig = jbp.yaw_minarea_pallas
    monkeypatch.setattr(jbp, "yaw_minarea_pallas",
                        lambda p, v, num_angles=512, interpret=False:
                        orig(p, v, num_angles=num_angles, interpret=True))
    rng = np.random.default_rng(5)
    boxes = (rng.uniform(-0.5, 0.5, size=(6, 200, 3)) * np.array([3.0, 1.0, 1.2])).astype(
        np.float32)
    ang = rng.uniform(0, np.pi, 6)
    rot = np.zeros((6, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 2, 2] = np.cos(ang)
    rot[:, 0, 2], rot[:, 2, 0], rot[:, 1, 1] = np.sin(ang), -np.sin(ang), 1.0
    pts = np.einsum("inj,ikj->ink", boxes, rot) + rng.normal(size=(6, 1, 3)).astype(np.float32)
    valid = rng.uniform(size=(6, 200)) > 0.1
    valid[5] = False
    ups = np.tile(np.array([0.05, -0.99, 0.02], np.float32), (6, 1))
    for up in (None, ups):
        want = jfit_boxes_batch(jnp.asarray(pts), jnp.asarray(valid),
                                None if up is None else jnp.asarray(up),
                                method="minarea_pallas")
        by.PLAIN_CALLS.reset()
        got = fit_boxes_batch(torch.from_numpy(pts), torch.from_numpy(valid),
                              None if up is None else torch.from_numpy(up),
                              method="minarea_pallas")
        assert by.PLAIN_CALLS.count == 1  # one yaw search for the whole batch
        np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
        ok = np.asarray(want.ok)
        np.testing.assert_array_equal(got.yaw.numpy()[ok], np.asarray(want.yaw)[ok])
        for f in ("center_cam", "dimensions", "R_cam", "vertices"):
            np.testing.assert_allclose(getattr(got, f).numpy()[ok],
                                       np.asarray(getattr(want, f))[ok],
                                       atol=BOX_TOL, rtol=0, err_msg=f)
