"""MoGe with the checkpoint-faithful head (`MoGeConfig.tiny_reference_test`)
and `moge_infer`: the port against the JAX package on the CPU in float32,
square and non-square, the JAX package's parameters carried across by
`models/weights.py` (ConvTranspose kernels flipped, GroupNorm scales).

Tolerances as in `tests/test_torch_moge.py`: raw points and mask probability
1e-4 relative (atol 1e-5); after focal/shift recovery, depth and intrinsics
1e-3 relative; mask pixels may flip only where the probability is within
1e-4 of the 0.5 threshold. The weights are random (`random_flax_params`)
from a seed whose point maps recover a positive focal at both shapes: where
random maps make the focal degenerate, the 1-D solve is ill-conditioned and
compares nothing. The view-plane UV field is held at 1e-5
absolute, the head's resize with its edge pad at 1e-5 absolute plus 1e-5
relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import moge as jmoge
from labelany3d_tpu_torch.models import moge
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.torch_parity import random_flax_params

RTOL = 1e-4
ATOL = 1e-5


def _models(hw, seed=2):
    jcfg = jmoge.MoGeConfig.tiny_reference_test()
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(jcfg.backbone,
                                                                  dtype=jnp.float32))
    tcfg = moge.MoGeConfig.tiny_reference_test()
    tcfg = dataclasses.replace(tcfg, backbone=dataclasses.replace(tcfg.backbone,
                                                                  dtype=torch.float32))
    jm = jmoge.MoGeModel(jcfg)
    params = random_flax_params(jm.init, jnp.zeros((1, *hw, 3)), seed=seed)
    tm = moge.MoGeModel(tcfg, hw)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    return jm, params, tm.eval()


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_moge_reference_forward_and_infer_match_jax(hw):
    jm, params, tm = _models(hw)
    images = np.random.default_rng(1).uniform(size=(2, *hw, 3)).astype(np.float32)
    x = torch.from_numpy(images)
    raw_j = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        raw_t = tm(x)
    for key in ("points", "mask"):
        np.testing.assert_allclose(raw_t[key].numpy(), np.asarray(raw_j[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)

    want = jax.jit(lambda p, x: jmoge.moge_infer(jm, p, x))(params, jnp.asarray(images))
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


@pytest.mark.parametrize("mode", ["linear", "sinh", "exp", "sinh_exp"])
def test_remap_points_matches_jax(mode):
    raw = np.random.default_rng(2).standard_normal((2, 3, 5, 3)).astype(np.float32)
    want = np.asarray(jmoge._remap_points(jnp.asarray(raw), mode))
    got = moge._remap_points(torch.from_numpy(raw), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)
    with pytest.raises(ValueError, match="remap"):
        moge._remap_points(torch.from_numpy(raw), "cosh")


@pytest.mark.parametrize("in_hw, out_hw", [((8, 8), (32, 32)), ((12, 16), (48, 64)),
                                           ((36, 36), (50, 50))])
def test_head_resize_pad_and_uv_match_jax(in_hw, out_hw):
    x = np.random.default_rng(3).standard_normal((2, *in_hw, 5)).astype(np.float32)
    want = np.asarray(jmoge._resize_bilinear_pad(jnp.asarray(x), out_hw))
    got = moge._resize_bilinear_pad(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=ATOL)
    aspect = out_hw[1] / out_hw[0]
    np.testing.assert_allclose(moge._view_plane_uv(*out_hw, aspect),
                               jmoge._view_plane_uv(*out_hw, aspect), atol=ATOL, rtol=0)


def test_reference_head_parameter_names():
    """The port's head carries the JAX package's parameter names, so the
    converters' trees load onto it."""
    _, params, tm = _models((32, 32))
    names = set(params["head"])
    assert {"project0", "project1", "up0_deconv", "up1_deconv", "up0_conv", "up0_res0",
            "out0_conv_in", "out0_conv_out", "out1_conv_in", "out1_conv_out"} <= names
    assert {n.split(".")[0] for n, _ in tm.head.named_parameters()} == names
