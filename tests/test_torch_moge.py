"""MoGe ('tpu' head) and `moge_infer`: the port against the JAX package.

Same Flax parameters carried across by `models/weights.py`, float32 on the
CPU. Tolerances: raw points and mask probability 1e-4 absolute (a few f32
conv/matmul layers in another summation order); after focal/shift recovery,
depth and intrinsics 1e-3 relative (golden-section search on a smooth 1-D
cost, 24 refinements); mask pixels may flip only where the probability is
within 1e-4 of the 0.5 threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from labelany3d_tpu.models import moge as jmoge
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu_torch.models import moge
from labelany3d_tpu_torch.models.vit import ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict


def _models(hw):
    jcfg = dataclasses.replace(
        jmoge.MoGeConfig.tiny_test(), dtype=jnp.float32,
        backbone=dataclasses.replace(JViTConfig.tiny_test(out_indices=(0, 1)), dtype=jnp.float32))
    tcfg = dataclasses.replace(
        moge.MoGeConfig.tiny_test(), dtype=torch.float32,
        backbone=dataclasses.replace(ViTConfig.tiny_test(out_indices=(0, 1)), dtype=torch.float32))
    jm = jmoge.MoGeModel(jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, *hw, 3)))["params"]
    tm = moge.MoGeModel(tcfg, hw)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    return jm, params, tm.eval()


def test_moge_forward_and_infer_match_jax():
    hw = (48, 64)
    jm, params, tm = _models(hw)
    images = np.random.default_rng(0).uniform(size=(2, *hw, 3)).astype(np.float32)
    x = torch.from_numpy(images)

    raw_j = jm.apply({"params": params}, jnp.asarray(images))
    with torch.no_grad():
        raw_t = tm(x)
    np.testing.assert_allclose(raw_t["points"].numpy(), np.asarray(raw_j["points"]), atol=1e-4)
    np.testing.assert_allclose(raw_t["mask"].numpy(), np.asarray(raw_j["mask"]), atol=1e-4)

    want = jmoge.moge_infer(jm, params, jnp.asarray(images))
    with torch.no_grad():
        got = moge.moge_infer(tm, x)
    np.testing.assert_allclose(got["intrinsics"].numpy(), np.asarray(want["intrinsics"]),
                               rtol=1e-3)
    prob = np.asarray(raw_j["mask"])
    flips = got["mask"].numpy() != np.asarray(want["mask"])
    assert np.all(np.abs(prob[flips] - 0.5) < 1e-4)
    both = got["mask"].numpy() & np.asarray(want["mask"])
    assert both.sum() > 0
    np.testing.assert_allclose(got["depth"].numpy()[both], np.asarray(want["depth"])[both],
                               rtol=1e-3)
    assert np.all(np.isinf(got["depth"].numpy()[~got["mask"].numpy()]))

    K_t = moge.pixel_intrinsics_from_normalized(got["intrinsics"], hw[1], hw[0])
    K_j = jmoge.pixel_intrinsics_from_normalized(want["intrinsics"], hw[1], hw[0])
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=1e-3)


def test_moge_infer_with_known_fov():
    hw = (32, 32)
    jm, params, tm = _models(hw)
    images = np.random.default_rng(1).uniform(size=(1, *hw, 3)).astype(np.float32)
    want = jmoge.moge_infer(jm, params, jnp.asarray(images), fov_x_degrees=60.0,
                            apply_mask=False)
    with torch.no_grad():
        got = moge.moge_infer(tm, torch.from_numpy(images), fov_x_degrees=60.0,
                              apply_mask=False)
    np.testing.assert_allclose(got["intrinsics"].numpy(), np.asarray(want["intrinsics"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=1e-3)
