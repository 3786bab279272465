"""The checkpoint-faithful DepthPro (`DepthPro35`, `depth_pro35_infer`): the
port against the JAX package on the CPU in float32 at
`DepthPro35Config.tiny_test()` (512 px, 128-px patches, 16-px tokens, all
three encoders), the JAX package's tree of parameter shapes filled from a
seed and carried across by `models/weights.py` (ConvTranspose kernels
flipped).

Tolerances: `split_overlap` / `merge_overlap` exact (slices); canonical
inverse depth, FoV and metric inverse depth 1e-4 relative (atol 1e-5, times
W / f_px for inverse depth: a dozen f32 conv and transformer layers in
another summation order); the focal from the FoV 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import depth_pro as jdp
from labelany3d_tpu_torch.models import depth_pro
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.torch_parity import random_flax_params

RTOL = 1e-4
ATOL = 1e-5


def _f32(cfg, dtype):
    return dataclasses.replace(
        cfg, dtype=dtype,
        **{k: dataclasses.replace(getattr(cfg, k), dtype=dtype)
           for k in ("patch_encoder", "image_encoder", "fov_encoder")})


@pytest.fixture(scope="module")
def models():
    jcfg = _f32(jdp.DepthPro35Config.tiny_test(), jnp.float32)
    tcfg = _f32(depth_pro.DepthPro35Config.tiny_test(), torch.float32)
    jm = jdp.DepthPro35(jcfg)
    s = jcfg.img_size
    params = random_flax_params(jm.init, jnp.zeros((1, s, s, 3)), seed=3)
    tm = depth_pro.DepthPro35(tcfg)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    images = np.random.default_rng(4).uniform(size=(1, s, s, 3)).astype(np.float32)
    return jm, params, tm.eval(), images


@pytest.mark.parametrize("size, patch, stride, pad", [(40, 16, 12, 2), (36, 16, 10, 3)])
def test_split_merge_match_jax(size, patch, stride, pad):
    x = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jdp.split_overlap(jnp.asarray(x), patch, stride))
    got = depth_pro.split_overlap(torch.from_numpy(x), patch, stride)
    np.testing.assert_array_equal(got.numpy(), want)
    merged = depth_pro.merge_overlap(got, 2, pad)
    np.testing.assert_array_equal(merged.numpy(),
                                  np.asarray(jdp.merge_overlap(jnp.asarray(want), 2, pad)))


def test_depth_pro35_forward_matches_jax(models):
    jm, params, tm, images = models
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert set(got) == set(want) == {"canonical_inverse_depth", "fov_deg"}
    assert got["canonical_inverse_depth"].shape == (1, 512, 512)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert float(got["canonical_inverse_depth"].max()) > 0


@pytest.mark.parametrize("f_px", [None, 300.0])
def test_depth_pro35_infer_matches_jax(models, f_px):
    jm, params, tm, images = models
    want = jax.jit(lambda p, x: jdp.depth_pro35_infer(jm, p, x, f_px=f_px))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = depth_pro.depth_pro35_infer(tm, torch.from_numpy(images), f_px=f_px)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["f_px"].numpy(), np.asarray(want["f_px"]), rtol=RTOL)
    if f_px is not None:
        assert float(got["f_px"][0]) == f_px
    # Depth is 1 / (canonical * W / f_px): compared as inverse depth, whose
    # absolute tolerance is the canonical map's scaled by W / f_px (near a
    # zero canonical value, depth itself magnifies any difference).
    scale = 512.0 / float(want["f_px"][0])
    np.testing.assert_allclose(1.0 / got["depth"].numpy(), 1.0 / np.asarray(want["depth"]),
                               rtol=RTOL, atol=ATOL * scale)


def test_depth_pro35_rejects_other_sizes(models):
    with pytest.raises(ValueError, match="512x512"):
        models[2](torch.zeros(1, 256, 256, 3))
