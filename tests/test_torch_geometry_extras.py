"""The host leftovers of the geometric core against the JAX package on the
CPU in float32: `geometry/transforms.py` (`so3_log`, `compose_transform`),
`geometry/procrustes.py` (`kabsch`, `umeyama`), `geometry/camera.py` (the six
camera functions; `scale_intrinsics` and `normalized_to_pixel_intrinsics`
called in JAX directly, since no JAX test covers them) and
`geometry/masks.py` (`MaskStats`, `mask_max_height`, `analyze_mask`,
`filter_instances`). One parametrised test a module, on seeded inputs.

Tolerances: 1e-5 absolute for closed-form float32 maths (the same formulas,
another summation order); 1e-4 for the SVD-based solvers (two LAPACK paths);
mask statistics exactly equal (integer counts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.geometry import camera as jcamera
from labelany3d_tpu.geometry import masks as jmasks
from labelany3d_tpu.geometry import procrustes as jprocrustes
from labelany3d_tpu.geometry import transforms as jtransforms
from labelany3d_tpu_torch.geometry import camera, masks, procrustes, transforms

torch.set_num_threads(1)

TOL = 1e-5
SVD_TOL = 1e-4


def _rotations(rng, n):
    """Rotations from seeded axis-angles, among them the identity, a tiny
    angle and angles near pi."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    ang = rng.uniform(0.0, np.pi, n)
    ang[:3] = (0.0, 1e-7, np.pi - 1e-3)
    return np.array(jtransforms.so3_exp(jnp.asarray(w * ang[:, None], jnp.float32)))


@pytest.mark.parametrize("case", ["so3_log", "compose", "compose_scaled_broadcast"])
def test_transforms_match_jax(case):
    rng = np.random.default_rng(1)
    r = _rotations(rng, 8)
    if case == "so3_log":
        got = transforms.so3_log(torch.from_numpy(r)).numpy()
        want = np.asarray(jtransforms.so3_log(jnp.asarray(r)))
        np.testing.assert_allclose(got, want, atol=TOL)
        return
    t = rng.normal(size=(8, 3)).astype(np.float32)
    if case == "compose":
        got = transforms.compose_transform(r, t, device="cpu").numpy()
        want = np.asarray(jtransforms.compose_transform(r, t))
    else:  # one rotation against a batch of translations, with scales
        s = rng.uniform(0.5, 2.0, 8).astype(np.float32)
        got = transforms.compose_transform(torch.from_numpy(r[0]), torch.from_numpy(t),
                                           torch.from_numpy(s)).numpy()
        want = np.asarray(jtransforms.compose_transform(r[0], t, s))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("solver", ["kabsch", "umeyama"])
@pytest.mark.parametrize("weighted", [False, True])
def test_procrustes_matches_jax(solver, weighted):
    rng = np.random.default_rng(2)
    b, n = 4, 50
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    r = _rotations(rng, b + 3)[3:]
    scale = rng.uniform(0.5, 2.0, b).astype(np.float32)
    t = rng.normal(size=(b, 3)).astype(np.float32)
    dst = (scale[:, None, None] * np.einsum("bij,bnj->bni", r, src) + t[:, None]
           + 0.01 * rng.normal(size=(b, n, 3))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (b, n)).astype(np.float32) if weighted else None
    if solver == "kabsch":
        got = procrustes.kabsch(src, dst, w, device="cpu")
        want = jprocrustes.kabsch(src, dst, w)
    else:
        got = procrustes.umeyama(src, dst, w, device="cpu")
        want = jprocrustes.umeyama(src, dst, w)
        np.testing.assert_allclose(got.scale.numpy(), scale, rtol=0.02)
        np.testing.assert_allclose(got.rotation.numpy(), r, atol=0.02)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=SVD_TOL)


@pytest.mark.parametrize("fn", ["look_at_opengl", "look_at_opencv", "orbit_camera",
                                "orbit_camera_radians_target", "project_points",
                                "point_to_plane_distance", "scale_intrinsics",
                                "normalized_to_pixel_intrinsics"])
def test_camera_matches_jax(fn):
    rng = np.random.default_rng(3)
    campos = rng.normal(size=(5, 3)).astype(np.float32) * 2
    target = rng.normal(size=(5, 3)).astype(np.float32) * 0.1
    K = np.array([[500.0, 0, 320.0], [0, 480.0, 240.0], [0, 0, 1]], np.float32)
    elev = rng.uniform(-80, 80, 6).astype(np.float32)
    azim = rng.uniform(-170, 170, 6).astype(np.float32)
    pts = rng.normal(size=(2, 7, 3)).astype(np.float32)
    pts[0, 0, 2] = 0.0  # a depth of exactly 0
    if fn.startswith("look_at"):
        opengl = fn == "look_at_opengl"
        got = camera.look_at(campos, target, opengl, device="cpu")
        want = jcamera.look_at(campos, target, opengl)
    elif fn == "orbit_camera":
        got = camera.orbit_camera(elev, azim, 2.5, device="cpu")
        want = jcamera.orbit_camera(elev, azim, 2.5)
    elif fn == "orbit_camera_radians_target":
        tgt = np.array([0.1, -0.2, 0.3], np.float32)
        got = camera.orbit_camera(np.deg2rad(elev), np.deg2rad(azim), 1.5, False,
                                  tgt, False, device="cpu")
        want = jcamera.orbit_camera(np.deg2rad(elev), np.deg2rad(azim), 1.5, False, tgt, False)
    elif fn == "project_points":
        got = camera.project_points(pts, K, device="cpu")
        want = jcamera.project_points(jnp.asarray(pts), jnp.asarray(K))
        np.testing.assert_allclose(got.numpy()[0, 1:], np.asarray(want)[0, 1:], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy()[1], np.asarray(want)[1], rtol=TOL, atol=TOL)
        assert np.isfinite(got.numpy()).all()
        return
    elif fn == "point_to_plane_distance":
        plane = np.array([[0.2, -1.0, 0.3, 1.5], [0.0, 0.0, 2.0, -1.0]], np.float32)
        got = camera.point_to_plane_distance(plane, pts, device="cpu")
        want = jcamera.point_to_plane_distance(jnp.asarray(plane), jnp.asarray(pts))
    elif fn == "scale_intrinsics":
        Kb = np.stack([K, 2 * K]).astype(np.float32)
        got = camera.scale_intrinsics(Kb, np.float32([0.5, 2.0]), np.float32([0.25, 3.0]),
                                      device="cpu")
        want = jcamera.scale_intrinsics(Kb, np.float32([0.5, 2.0]), np.float32([0.25, 3.0]))
    else:
        Kn = np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
        got = camera.normalized_to_pixel_intrinsics(Kn, 640, 480, device="cpu")
        want = jcamera.normalized_to_pixel_intrinsics(Kn, 640, 480)
        np.testing.assert_allclose(got.numpy()[:2, 2], [320.0, 240.0])
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _instance_masks(rng, n=12, hw=(96, 128)):
    """Rectangles of seeded sizes and places, some on the border, one empty
    and one a single row."""
    m = np.zeros((n, *hw), bool)
    for i in range(n):
        y0, x0 = rng.integers(0, hw[0] - 4), rng.integers(0, hw[1] - 4)
        h, w = rng.integers(1, 40), rng.integers(1, 50)
        m[i, y0:y0 + h, x0:x0 + w] = True
    m[0] = False
    m[1] = False
    m[1, 50, 10:90] = True
    m[2, :, :3] = True  # the left border band
    return m


@pytest.mark.parametrize("fn", ["mask_max_height", "analyze_mask", "analyze_mask_thresholds",
                                "filter_instances"])
def test_masks_match_jax(fn):
    m = _instance_masks(np.random.default_rng(4))
    if fn == "mask_max_height":
        got = masks.mask_max_height(m, device="cpu")
        want = jmasks.mask_max_height(m)
        assert got.dtype == torch.int32 and got[0] == 0 and got[1] == 1
    elif fn.startswith("analyze_mask"):
        kw = (dict(scale_threshold=30, boundary_threshold=4, truncation_count=3)
              if fn.endswith("thresholds") else {})
        got = masks.analyze_mask(torch.from_numpy(m), **kw)
        want = jmasks.analyze_mask(m, **kw)
        assert isinstance(got, masks.MaskStats) and got._fields == want._fields
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    else:
        got = masks.filter_instances(m, 96, device="cpu")
        want = jmasks.filter_instances(m, 96)
        assert got.dtype == torch.bool and 0 < int(got.sum()) < len(m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
