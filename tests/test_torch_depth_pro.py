"""DepthProModel and `depth_pro_infer`: the port against the JAX package.

Same Flax parameters carried across, float32 on the CPU. Tolerance 1e-4
relative on depth (a few f32 conv layers summed in another order). The
antialiased 2x downsample is also checked on its own: PyTorch's
`antialias=True` bilinear against `jax.image.resize`, borders included,
to 1e-5 (tap weights of a non-integer scale are computed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import depth_pro as jdp
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu_torch.models import depth_pro
from labelany3d_tpu_torch.models.layers import resize
from labelany3d_tpu_torch.models.vit import ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict


@pytest.mark.parametrize("src,dst,aa", [
    ((64, 48), (32, 24), True),    # DepthPro's `half`
    ((30, 22), (15, 11), True),
    ((9, 7), (18, 14), False),     # head 2x upsamples
    ((18, 20), (64, 48), False),   # final resize, non-integer factor
])
def test_resize_matches_jax_image_resize(src, dst, aa):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="bilinear",
                                       antialias=True))
    got = resize(torch.from_numpy(x).permute(0, 3, 1, 2), dst, antialias=aa)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_depth_pro_matches_jax():
    hw = (64, 48)
    jcfg = dataclasses.replace(jdp.DepthProConfig.tiny_test(), dtype=jnp.float32,
                               backbone=dataclasses.replace(JViTConfig.tiny_test(),
                                                            dtype=jnp.float32))
    tcfg = dataclasses.replace(depth_pro.DepthProConfig.tiny_test(), dtype=torch.float32,
                               backbone=dataclasses.replace(ViTConfig.tiny_test(),
                                                            dtype=torch.float32))
    jm = jdp.DepthProModel(jcfg)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, *hw, 3)))["params"]
    tm = depth_pro.DepthProModel(tcfg, hw)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    images = np.random.default_rng(3).uniform(size=(2, *hw, 3)).astype(np.float32)
    f_px = np.array([40.0, 55.0], np.float32)

    want = jdp.depth_pro_infer(jm, params, jnp.asarray(images), jnp.asarray(f_px))
    with torch.no_grad():
        got = depth_pro.depth_pro_infer(tm.eval(), torch.from_numpy(images),
                                        torch.from_numpy(f_px))
    np.testing.assert_allclose(got["canonical_inverse_depth"].numpy(),
                               np.asarray(want["canonical_inverse_depth"]), rtol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=1e-4)
