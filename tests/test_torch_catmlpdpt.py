"""The MASt3R-faithful matcher (`MatcherConfig.tiny_catmlpdpt_test`: a rope
encoder through K2's path, the 4-block decoder with its DPT hooks, and the
CatMLP+DPT heads): the port against the JAX package on the CPU in float32,
all eight outputs, in the broadcast, `ref_index` and row-by-row branches.

The config is bf16 by default; both sides are replaced to float32, where the
JAX package's `_gelu_fast` in `mlp_fc2` is exact erf, as the port's always
is. Parameters: the JAX tree of shapes filled from a seed
(`random_flax_params`), carried across by `models/weights.py`.
Tolerances: 1e-4 relative (atol 1e-5) on every output, for the 3D points
relative to each point's norm; the align-corners resize 1e-5 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import matcher as jmatcher
from labelany3d_tpu_torch.models import matcher
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.torch_parity import random_flax_params

RTOL = 1e-4
ATOL = 1e-5
KEYS = {"pts3d0", "conf0", "desc0", "desc_conf0", "pts3d1", "conf1", "desc1", "desc_conf1"}


def _f32(cfg, dtype):
    return dataclasses.replace(cfg, dtype=dtype,
                               encoder=dataclasses.replace(cfg.encoder, dtype=dtype))


@pytest.mark.parametrize("hw, r, p, ref_index", [
    ((64, 64), 1, 3, None),         # one reference broadcast to every view
    ((48, 64), 2, 3, [1, 0, 1]),    # many references by ref_index, non-square
    ((64, 64), 2, 2, None),         # pairs row by row
])
def test_catmlpdpt_matcher_matches_jax(hw, r, p, ref_index):
    jcfg = _f32(jmatcher.MatcherConfig.tiny_catmlpdpt_test(), jnp.float32)
    tcfg = _f32(matcher.MatcherConfig.tiny_catmlpdpt_test(), torch.float32)
    rng = np.random.default_rng(5)
    img0 = rng.uniform(size=(r, *hw, 3)).astype(np.float32)
    img1 = rng.uniform(size=(p, *hw, 3)).astype(np.float32)
    jm = jmatcher.TwoViewMatcher(jcfg)
    params = random_flax_params(jm.init, jnp.asarray(img0[:1]), jnp.asarray(img1[:1]), seed=6)
    idx = None if ref_index is None else np.asarray(ref_index, np.int32)
    want = jax.jit(lambda prm, a, b, i: jm.apply({"params": prm}, a, b, ref_index=i))(
        params, jnp.asarray(img0), jnp.asarray(img1), None if idx is None else jnp.asarray(idx))
    ps = tcfg.encoder.patch_size
    model = matcher.TwoViewMatcher(tcfg, (hw[0] // ps, hw[1] // ps))
    model.load_state_dict(flax_to_state_dict(params, model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img0), torch.from_numpy(img1),
                           ref_index=None if idx is None else torch.from_numpy(idx))
    assert set(got) == set(want) == KEYS
    for key in KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key.startswith("pts3d"):
            # expm1 of the raw norm magnifies it: a point's error is relative
            # to the point's norm, not to each of its components.
            err = np.linalg.norm(g - w, axis=-1)
            assert np.all(err <= RTOL * np.linalg.norm(w, axis=-1) + ATOL), key
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=key)
    assert got["desc0"].shape == (p, *hw, tcfg.desc_dim)
    np.testing.assert_allclose(got["desc1"].norm(dim=-1).numpy(), 1.0, atol=ATOL)


@pytest.mark.parametrize("src, dst", [((4, 4), (8, 8)), ((3, 5), (6, 10))])
def test_resize_align_corners_matches_jax(src, dst):
    x = np.random.default_rng(7).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jmatcher._resize_bilinear_ac(jnp.asarray(x), *dst))
    got = matcher._resize_bilinear_ac(torch.from_numpy(x).permute(0, 3, 1, 2), *dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


def test_mast3r_vitl_config():
    """The full-size config builds (meta tensors: no memory) with the
    released head's parameter names and the rope encoder's shape."""
    cfg = matcher.MatcherConfig.mast3r_vitl()
    assert (cfg.encoder.pos_embed, cfg.encoder.patch_size, cfg.head_style) == \
        ("rope2d", 16, "catmlpdpt")
    with torch.device("meta"):
        model = matcher.TwoViewMatcher(cfg, (32, 32))
    names = dict(model.named_parameters())
    assert "encoder.pos_embed" not in names and "encoder.cls_token" not in names
    assert names["head0.mlp_fc2.weight"].shape == ((24 + 1) * 16 * 16, 4 * (1024 + 768))
    assert names["head1.act0_deconv.weight"].shape == (96, 96, 4, 4)
    assert "head0.refine4.res1.conv1.weight" not in names
