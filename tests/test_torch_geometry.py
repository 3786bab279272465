"""Geometry core: the port against the JAX package on the same numpy inputs.

Random draws (RANSAC subsets, instance samples) are made with `jax.random`
from the JAX functions' own keys and injected into the port. Tolerances,
float32 throughout:
  * reductions, rotations, back-projection: 1e-6 / 1e-5 (same arithmetic);
  * RANSAC-aligned depth: 1e-4 relative (least-squares sums in another order);
  * box fits: 1e-4 on centres, dimensions and rotations; 2e-3 on vertices,
    which are rounded to float16 (one f16 ulp at unit scale is ~1e-3);
  * focal/shift recovery: 1e-3 relative (golden-section comparisons of
    near-equal costs may branch differently in the last refinements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.geometry import backproject as jbp
from labelany3d_tpu.geometry import boxfit as jbox
from labelany3d_tpu.geometry import focal as jfocal
from labelany3d_tpu.geometry import reductions as jred
from labelany3d_tpu.geometry import transforms as jtf
from labelany3d_tpu.pipeline.labeling import depth_fusion as jdepth_fusion
from labelany3d_tpu_torch.geometry import align, backproject, boxfit, focal, reductions, transforms
from tests.torch_parity import jax_ransac_draws

T = torch.from_numpy


def test_reductions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 33)).astype(np.float32)
    m = rng.uniform(size=x.shape) > 0.4
    m[0, 0] = False  # an empty row
    for name in ("masked_min", "masked_max"):
        want = getattr(jred, name)(jnp.asarray(x), jnp.asarray(m))
        got = getattr(reductions, name)(T(x), T(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("masked_median", "masked_mad"):
        want = getattr(jred, name)(jnp.asarray(x), jnp.asarray(m))
        got = getattr(reductions, name)(T(x), T(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jred.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=-2, keepdims=True)
    got = reductions.masked_mean(T(x), T(m), dim=-2, keepdim=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_rotations():
    rng = np.random.default_rng(1)
    yaw = rng.uniform(-3, 3, size=(5,)).astype(np.float32)
    np.testing.assert_allclose(transforms.rotate_y(T(yaw)).numpy(),
                               np.asarray(jtf.rotate_y(jnp.asarray(yaw))), atol=1e-6)
    a = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal((6, 3)).astype(np.float32)
    b[4] = 2 * a[4]     # parallel
    b[5] = -3 * a[5]    # anti-parallel
    want = np.asarray(jtf.rotation_matrix_from_vectors(jnp.asarray(a), jnp.asarray(b)))
    got = transforms.rotation_matrix_from_vectors(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_depth_to_points():
    rng = np.random.default_rng(2)
    depth = rng.uniform(1, 5, size=(2, 12, 16)).astype(np.float32)
    K = np.array([[[20, 0, 8], [0, 22, 6], [0, 0, 1]],
                  [[30, 0, 7], [0, 30, 5], [0, 0, 1]]], np.float32)
    want = np.asarray(jbp.depth_to_points(jnp.asarray(depth), jnp.asarray(K)))
    np.testing.assert_allclose(backproject.depth_to_points(T(depth), T(K)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_depth_to_points_singular_K():
    """A zero focal (from a degenerate depth map) gives the same non-finite
    rays as `jnp.linalg.inv`, and does not raise."""
    depth = np.full((2, 4, 6), 2.0, np.float32)
    K = np.array([[[0, 0, 3], [0, 0, 2], [0, 0, 1]],
                  [[30, 0, 3], [0, 30, 2], [0, 0, 1]]], np.float32)
    want = np.asarray(jbp.depth_to_points(jnp.asarray(depth), jnp.asarray(K)))
    got = backproject.depth_to_points(T(depth), T(K)).numpy()
    assert not np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


def _depth_pair(rng, b=2, h=32, w=40):
    rel = rng.uniform(0.5, 3.0, size=(b, h, w)).astype(np.float32)
    met = (2.5 * rel + 0.01 * rng.standard_normal(rel.shape)).astype(np.float32)
    met[:, :4, :6] = 50.0  # outliers
    mask = rng.uniform(size=rel.shape) > 0.2
    return rel, met, mask


def test_align_depth_matches_jax_with_injected_draws():
    rel, met, mask = _depth_pair(np.random.default_rng(3))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jdepth_fusion(jnp.asarray(rel), jnp.asarray(met), jnp.asarray(mask), key))
    draws = jax_ransac_draws(key, rel.shape[0], rel[0].size)
    got = align.align_depth_affine(T(rel), T(met), T(mask), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # No mask: the metric fallback and the finite-relative predict region.
    want = np.asarray(jdepth_fusion(jnp.asarray(rel), jnp.asarray(met), None, key))
    got = align.align_depth_affine(T(rel), T(met), None, draws).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_align_depth_ignores_inf_outside_mask():
    """Fault F4 of the JAX package: an inf relative depth at a masked pixel
    (MoGe's output there) turns its least-squares sums into NaN and the
    aligned depth into 0. The port drops zero-weight points first."""
    rel, met, mask = _depth_pair(np.random.default_rng(4), b=1)
    rel = np.where(mask, rel, np.inf).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jout = np.asarray(jdepth_fusion(jnp.asarray(rel), jnp.asarray(met), jnp.asarray(mask), key))
    assert np.all(jout[mask] == 0.0)  # the reference defect
    draws = jax_ransac_draws(key, 1, rel[0].size)
    got = align.align_depth_affine(T(rel), T(met), T(mask), draws).numpy()
    inl = mask.copy()
    inl[:, :4, :6] = False
    np.testing.assert_allclose(got[inl], met[inl], rtol=0.05)
    assert np.all(got[~mask] == align.DEPTH_SENTINEL)


def test_gather_instance_points_with_injected_draws():
    rng = np.random.default_rng(5)
    h, w, n_inst, s = 64, 128, 3, 50   # H*W/16 a multiple of 128, as JAX needs
    pts = rng.standard_normal((h, w, 3)).astype(np.float32)
    masks = rng.uniform(size=(n_inst, h, w)) > 0.7
    masks[2] = False  # an empty instance
    key = jax.random.PRNGKey(9)
    want_pts, want_valid = jbp.gather_instance_points(jnp.asarray(pts), jnp.asarray(masks), s, key)
    n_valid = jnp.asarray(masks.reshape(n_inst, -1).sum(-1), jnp.int32)
    draws = torch.from_numpy(np.array(
        jax.random.randint(key, (n_inst, s), 0, jnp.maximum(n_valid, 1)[:, None])))[None]
    got_pts, got_valid = backproject.gather_instance_points(T(pts)[None], T(masks)[None], s, draws)
    np.testing.assert_array_equal(got_valid[0].numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_pts[0, :2].numpy(), np.asarray(want_pts)[:2])


@pytest.mark.parametrize("method", ["pca", "minarea"])
def test_fit_boxes_batch(method):
    rng = np.random.default_rng(6)
    n_inst, n = 5, 64
    base = rng.standard_normal((n_inst, n, 3)).astype(np.float32) * [2.0, 0.5, 1.0]
    yaw = rng.uniform(-1, 1, size=n_inst)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.stack([np.stack([c, 0 * c, s], -1), np.stack([0 * c, 1 + 0 * c, 0 * c], -1),
                  np.stack([-s, 0 * c, c], -1)], -2).astype(np.float32)
    pts = np.einsum("iab,inb->ina", R, base) + rng.uniform(-3, 3, (n_inst, 1, 3))
    pts = pts.astype(np.float32)
    valid = rng.uniform(size=(n_inst, n)) > 0.2
    valid[4] = False  # no points: ok == False
    want = jbox.fit_boxes_batch(jnp.asarray(pts), jnp.asarray(valid), None, method=method)
    got = boxfit.fit_boxes_batch(T(pts), T(valid), None, method=method)
    ok = np.asarray(want.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_allclose(got.center_cam.numpy()[ok], np.asarray(want.center_cam)[ok],
                               atol=1e-4)
    np.testing.assert_allclose(got.dimensions.numpy()[ok], np.asarray(want.dimensions)[ok],
                               atol=1e-4)
    np.testing.assert_allclose(got.R_cam.numpy()[ok], np.asarray(want.R_cam)[ok], atol=1e-4)
    np.testing.assert_allclose(got.vertices.numpy()[ok], np.asarray(want.vertices)[ok],
                               atol=2e-3)


def test_recover_focal_shift():
    rng = np.random.default_rng(7)
    h, w = 48, 64
    uv = np.asarray(jfocal.normalized_view_plane_uv(w, h))
    z = rng.uniform(1.0, 3.0, size=(2, h, w)).astype(np.float32)
    f_true, s_true = np.array([1.3, 0.8]), np.array([0.5, -0.3])
    xy = uv[None] * (z[..., None] + s_true[:, None, None, None]) / f_true[:, None, None, None]
    points = np.concatenate([xy, z[..., None]], -1).astype(np.float32)
    mask = rng.uniform(size=(2, h, w)) > 0.1
    jf, js = jfocal.recover_focal_shift(jnp.asarray(points), jnp.asarray(mask))
    tf, ts = focal.recover_focal_shift(T(points), T(mask))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3, atol=1e-4)
    # Known focal: only the shift is solved.
    jf, js = jfocal.recover_focal_shift(jnp.asarray(points), jnp.asarray(mask),
                                        focal=jnp.asarray(f_true, jnp.float32))
    tf, ts = focal.recover_focal_shift(T(points), T(mask),
                                       focal=torch.tensor(f_true, dtype=torch.float32))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
