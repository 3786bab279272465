"""`registration/process.py::register_object` and `align_to_depth_match`
against the JAX package on the CPU, on the same RANSAC draws
(`tests/torch_parity.py::jax_pnp_draws`), at the registration tests' sizes
(the textured cube, 96-px orbit renders, an 80 x 96 scene, the geometry
oracle standing in for the matcher).

Tolerances as `tests/test_torch_registration.py`: the scene transforms
within 1e-2 (float32 PnP over renders whose edge pixels may differ), inlier
counts within 2; a failed registration is the identity in both.
"""

import jax
import numpy as np
import torch

from labelany3d_tpu.data import meshio as jmeshio
from labelany3d_tpu.registration import process as jprocess
from labelany3d_tpu.registration.renderer import OrbitRenderer as JOrbitRenderer
from labelany3d_tpu_torch.registration import process
from labelany3d_tpu_torch.registration.renderer import OrbitRenderer
from tests.oracles import rotate_y_np
from tests.test_torch_registration import K_RENDER, SIZE, TRANSFORM_TOL, _meshes
from tests.torch_parity import OracleMatcher, jax_pnp_draws

torch.set_num_threads(1)

K_IMG = np.array([[120.0, 0, 48.0], [0, 120.0, 40.0], [0, 0, 1]], np.float32)
HW = (80, 96)
CROP = (40.0, 10.0, 2.0)


def _world():
    jm, tm = _meshes()
    jr = JOrbitRenderer(image_size=SIZE, K=K_RENDER, faces_per_tile=256)
    tr = OrbitRenderer(image_size=SIZE, K=K_RENDER, faces_per_tile=256, device="cpu")
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = 0.8 * rotate_y_np(0.5), 0.8 * np.array([0.2, 0.1, 4.0])
    placed = jmeshio.Mesh(jm.vertices.copy(), jm.faces, jm.colors).apply_transform(T)
    depth = jr.render_pose(placed, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                           image_size=HW, K=K_IMG).depth
    scene_depth = np.where(depth > 0, depth, 6.0).astype(np.float32)
    return jm, tm, jr, tr, T, scene_depth, depth > 0


class NoMatches:
    def match(self, ref_rgba, view):
        z = np.zeros((64, 2), np.float32)
        return z, z, np.zeros(64, bool)


def test_register_object_and_align_match_jax():
    jm, tm, jr, tr, T, scene_depth, mask = _world()
    ref = np.zeros((SIZE, SIZE, 4), np.float32)
    oracle = OracleMatcher(K_IMG, T, HW, CROP, K_RENDER)
    key = jax.random.PRNGKey(5)
    want = jprocess.register_object(jm, ref, 0.0, CROP, K_IMG, HW, scene_depth, mask, oracle,
                                    key, renderer=jr)
    got = process.register_object(tm, ref, 0.0, CROP, K_IMG, HW, scene_depth, mask, oracle,
                                  renderer=tr, draws=jax_pnp_draws(key, 1))
    assert got.ok and want.ok
    np.testing.assert_allclose(got.transform, want.transform, atol=TRANSFORM_TOL)
    assert abs(got.num_inliers - want.num_inliers) <= 2
    np.testing.assert_allclose(got.transform, T, atol=0.3)
    # align_to_depth_match: the same placement as a bare 4x4.
    j_t = jprocess.align_to_depth_match(jm, mask, scene_depth, ref, 0.0, CROP, K_IMG, oracle,
                                        key, renderer=jr)
    t_t = process.align_to_depth_match(tm, mask, scene_depth, ref, 0.0, CROP, K_IMG, oracle,
                                       renderer=tr, draws=jax_pnp_draws(key, 1))
    assert t_t.shape == (4, 4)
    np.testing.assert_allclose(t_t, j_t, atol=TRANSFORM_TOL)
    np.testing.assert_allclose(t_t, got.transform, atol=1e-6)


def test_align_to_depth_match_is_identity_on_failure():
    jm, tm, jr, tr, _, scene_depth, mask = _world()
    ref = np.zeros((SIZE, SIZE, 4), np.float32)
    key = jax.random.PRNGKey(6)
    want = jprocess.align_to_depth_match(jm, mask, scene_depth, ref, 0.0, CROP, K_IMG,
                                         NoMatches(), key, renderer=jr)
    got = process.align_to_depth_match(tm, mask, scene_depth, ref, 0.0, CROP, K_IMG,
                                       NoMatches(), renderer=tr,
                                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(want, np.eye(4))
    np.testing.assert_array_equal(got, np.eye(4))
    res = process.register_object(tm, ref, 0.0, CROP, K_IMG, HW, scene_depth, mask,
                                  NoMatches(), renderer=tr, draws=jax_pnp_draws(key, 1))
    assert not res.ok and res.num_inliers == 0
