"""Fused labeling program: the port against the JAX package.

`fused_label_program` (RANSAC depth fusion, mask unpack, instance sampling,
PCA/min-area box fit) runs on the same inputs in both packages, with the
JAX package's random draws injected into the port. Tolerances, float32:
aligned depth 1e-4 relative (least-squares sums in another order); box
centres, dimensions and rotations 1e-3 absolute at scene scale 1-5 (they
inherit the depth's relative error); vertices 2e-3 (rounded to float16).
Mask unpacking is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.pipeline import labeling as jlab
from labelany3d_tpu.pipeline.stages.common import pack_instance_masks as jpack
from labelany3d_tpu_torch.pipeline import labeling
from labelany3d_tpu_torch.pipeline.stages.common import pack_instance_masks
from tests.torch_parity import depth_ok, jax_ransac_draws, jax_sample_draws


def _scene(rng, b=2, h=64, w=128, n_inst=6):
    rel = rng.uniform(0.8, 2.0, size=(b, h, w)).astype(np.float32)
    met = (2.0 * rel + 0.02 * rng.standard_normal(rel.shape)).astype(np.float32)
    dmask = rng.uniform(size=rel.shape) > 0.05
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    K = np.broadcast_to(K, (b, 3, 3)).copy()
    masks = np.zeros((b, n_inst, h, w), bool)
    for bi in range(b):
        for i in range(n_inst - 1):  # the last slot stays empty
            y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 30)
            masks[bi, i, y0:y0 + rng.integers(8, 20), x0:x0 + rng.integers(8, 30)] = True
    packed = np.stack([pack_instance_masks(m) for m in masks])
    return rel, met, dmask, K, packed, masks


@pytest.mark.parametrize("method", ["pca", "minarea"])
def test_fused_label_program_matches_jax(method):
    rel, met, dmask, K, packed, masks = _scene(np.random.default_rng(0))
    n_inst, n_pts = masks.shape[1], 64
    key = jax.random.PRNGKey(11)
    prog = jlab.fused_label_program(n_inst, n_pts, method)
    want_aligned, want = prog(*(jnp.asarray(a) for a in (rel, met, dmask, K, packed)), key)
    want_aligned = np.asarray(want_aligned)

    k1, k2 = jax.random.split(key)
    eff = masks & depth_ok(want_aligned)[:, None]
    draws = labeling.LabelingDraws(jax_ransac_draws(k1, rel.shape[0], rel[0].size),
                                   jax_sample_draws(k2, eff, n_pts))
    got_aligned, got = labeling.fused_label_program(
        *(torch.from_numpy(a) for a in (rel, met, dmask, K, packed)),
        max_instances=n_inst, num_points=n_pts, method=method, draws=draws)

    np.testing.assert_allclose(got_aligned.numpy(), want_aligned, rtol=1e-4)
    ok = np.asarray(want.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    assert ok.sum() == 10 and not ok[:, -1].any()
    for field, tol in (("center_cam", 1e-3), ("dimensions", 1e-3), ("R_cam", 1e-3),
                       ("vertices", 2e-3)):
        np.testing.assert_allclose(getattr(got, field).numpy()[ok],
                                   np.asarray(getattr(want, field))[ok], atol=tol, err_msg=field)


def test_labeling_step_matches_jax():
    """`labeling_step` takes boolean masks (no bit packing); same draws."""
    rel, met, dmask, K, _, masks = _scene(np.random.default_rng(2))
    n_pts = 48
    key = jax.random.PRNGKey(5)
    want_aligned, want = jlab.labeling_step(
        *(jnp.asarray(a) for a in (rel, met, dmask, K, masks)), key, num_points=n_pts)
    want_aligned = np.asarray(want_aligned)

    k1, k2 = jax.random.split(key)
    eff = masks & depth_ok(want_aligned)[:, None]
    draws = labeling.LabelingDraws(jax_ransac_draws(k1, rel.shape[0], rel[0].size),
                                   jax_sample_draws(k2, eff, n_pts))
    got_aligned, got = labeling.labeling_step(
        *(torch.from_numpy(a) for a in (rel, met, dmask, K, masks)), draws=draws,
        num_points=n_pts)

    np.testing.assert_allclose(got_aligned.numpy(), want_aligned, rtol=1e-4)
    ok = np.asarray(want.boxes.ok)
    np.testing.assert_array_equal(got.boxes.ok.numpy(), ok)
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.boxes.center_cam.numpy()[ok],
                               np.asarray(want.boxes.center_cam)[ok], atol=1e-3)


@pytest.mark.parametrize("n_inst", [5, 16, 32])
def test_unpack_instance_masks(n_inst):
    masks = np.random.default_rng(n_inst).uniform(size=(2, n_inst, 24, 40)) > 0.6
    packed = np.stack([pack_instance_masks(m) for m in masks])
    np.testing.assert_array_equal(packed, np.stack([jpack(m) for m in masks]))
    got = labeling.unpack_instance_masks(torch.from_numpy(packed.astype(np.int64)
                                                          if packed.dtype == np.uint32
                                                          else packed), n_inst).numpy()
    np.testing.assert_array_equal(got, masks)
    want = np.asarray(jlab.unpack_instance_masks(jnp.asarray(packed), n_inst))
    np.testing.assert_array_equal(got, want)


def test_generator_draws_are_seeded():
    rel, met, dmask, K, packed, masks = _scene(np.random.default_rng(1), b=1)
    args = [torch.from_numpy(a) for a in (rel, met, dmask, K, packed)]
    outs = [labeling.fused_label_program(*args, max_instances=masks.shape[1], num_points=32,
                                         method="pca",
                                         generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].center_cam, outs[1][1].center_cam)
    assert outs[0][1].ok[0, :-1].all()
