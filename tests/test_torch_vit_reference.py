"""The checkpoint-faithful ViT features and new layers: the port against the
JAX package on the CPU in float32, the JAX package's parameters carried
across by `models/weights.py`.

  * a rope ViT (the `tiny_catmlpdpt_test` encoder: CroCo-style 2D RoPE, no
    class token, no LayerScale) at a grid that needs no pad and at one the
    port pads to 128 tokens (pad keys masked by segment ids in K2's plain
    version; the JAX encoder runs unpadded on the CPU);
  * register tokens with `norm_hiddens` and a pos-embed grid other than the
    live one (resized);
  * `resize_pos_embed`, `ConvTranspose`, `GroupNorm32` and `Conv3Replicate`
    against `jax.image.resize` and the Flax layers.

Tolerances: 1e-5 absolute for layers and resizes (f32, another summation
order), 1e-4 relative (atol 1e-5 at unit scale) for encoder outputs (two f32
blocks).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models.matcher import MatcherConfig as JMatcherConfig
from labelany3d_tpu.models.moge import _conv3_replicate as jconv3_replicate
from labelany3d_tpu.models.vit import ViT as JViT
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu.models.vit import resize_pos_embed as jresize_pos_embed
from labelany3d_tpu_torch.models.layers import Conv3Replicate, ConvTranspose, GroupNorm32
from labelany3d_tpu_torch.models.matcher import MatcherConfig
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig, resize_pos_embed
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from labelany3d_tpu_torch.ops import attention as att
from tests.torch_parity import random_flax_params

LAYER_TOL = 1e-5
MODEL_RTOL = 1e-4
MODEL_ATOL = 1e-5


def _perturbed(params, rng, scale=0.1):
    """Move every parameter off its constant init so each mapping counts."""
    return jax.tree_util.tree_map(
        lambda x: x + scale * jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)


def _compare(jcfg, tcfg, hw, grid=None, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    jm = JViT(jcfg)
    params = random_flax_params(jm.init, jnp.asarray(images), seed=seed)
    want = jax.jit(lambda prm, x: jm.apply({"params": prm}, x))(params, jnp.asarray(images))
    p = tcfg.patch_size
    model = ViT(tcfg, grid or (hw[0] // p, hw[1] // p))
    model.load_state_dict(flax_to_state_dict(params, model))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got["grid"] == tuple(want["grid"])
    keys = ["tokens", "all_prenorm"] + (["cls"] if jcfg.use_class_token else [])
    assert set(got) == set(keys) | {"grid", "hiddens"}
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL, err_msg=key)
    assert len(got["hiddens"]) == len(want["hiddens"]) > 0
    for g, w in zip(got["hiddens"], want["hiddens"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    return got


@pytest.mark.parametrize("hw, padded", [
    ((128, 256), False),  # 8 x 16 = 128 tokens: no pad rows
    ((48, 80), True),     # 3 x 5 = 15 tokens, padded to 128
])
def test_rope_vit_matches_jax(hw, padded):
    jenc = JMatcherConfig.tiny_catmlpdpt_test().encoder
    tenc = MatcherConfig.tiny_catmlpdpt_test().encoder
    jcfg = dataclasses.replace(jenc, dtype=jnp.float32, out_indices=(0, 1))
    tcfg = dataclasses.replace(tenc, dtype=torch.float32, out_indices=(0, 1))
    assert tcfg.pos_embed == "rope2d" and not tcfg.use_class_token
    att.FLASH_PLAIN_CALLS.reset()
    att.PLAIN_CALLS.reset()
    _compare(jcfg, tcfg, hw)
    # Every block's attention went through K2's path (the plain version on
    # the CPU), none through K1's.
    assert att.FLASH_PLAIN_CALLS.count == tcfg.depth and att.PLAIN_CALLS.count == 0


def test_rope_vit_pad_rows_do_not_leak():
    """In a padded rope sequence every block's K2 call gets segment ids that
    mask exactly the pad keys."""
    tcfg = dataclasses.replace(MatcherConfig.tiny_catmlpdpt_test().encoder,
                               dtype=torch.float32)
    model = ViT(tcfg, (3, 5))
    torch.manual_seed(0)
    for prm in model.parameters():
        prm.data.normal_(0.0, 0.2)
    x = torch.rand(1, 48, 80, 3)
    calls = []
    orig = att.flash_sdpa_reference

    def spy(q, k, v, segment_ids=None):
        calls.append(segment_ids)
        return orig(q, k, v, segment_ids)

    try:
        att.flash_sdpa_reference = spy
        with torch.no_grad():
            out = model(x)
    finally:
        att.flash_sdpa_reference = orig
    assert all(s is not None and s.shape == (1, 128) and int(s.sum()) == 128 - 15
               for s in calls)
    assert torch.isfinite(out["tokens"]).all() and out["tokens"].shape == (1, 15, 64)


def test_registers_norm_hiddens_and_pos_grid_match_jax():
    kw = dict(num_register_tokens=2, norm_hiddens=True, pos_grid=(5, 5), out_indices=(0, 1))
    jcfg = dataclasses.replace(JViTConfig.tiny_test(**kw), dtype=jnp.float32)
    tcfg = dataclasses.replace(ViTConfig.tiny_test(**kw), dtype=torch.float32)
    got = _compare(jcfg, tcfg, (32, 48), grid=(4, 6), seed=1)
    assert got["all_prenorm"].shape == (2, 1 + 2 + 24, 64)


@pytest.mark.parametrize("src, dst", [((37, 37), (36, 36)), ((37, 37), (40, 40)),
                                      ((5, 7), (6, 4))])
def test_resize_pos_embed_matches_jax(src, dst):
    pos = np.random.default_rng(2).standard_normal((1, *src, 16)).astype(np.float32)
    want = np.asarray(jresize_pos_embed(jnp.asarray(pos), *dst))
    got = resize_pos_embed(torch.from_numpy(pos), *dst).numpy()
    assert got.shape == want.shape == (1, *dst, 16)
    np.testing.assert_allclose(got, want, atol=LAYER_TOL, rtol=0)


class _Holder(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer


@pytest.mark.parametrize("k, bias", [(2, True), (4, True), (2, False)])
def test_conv_transpose_matches_flax(k, bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    ct = fnn.ConvTranspose(4, (k, k), strides=(k, k), use_bias=bias, dtype=jnp.float32)
    params = _perturbed(ct.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = np.asarray(ct.apply({"params": params}, jnp.asarray(x)))
    holder = _Holder(ConvTranspose(3, 4, k, torch.float32, bias=bias))
    holder.load_state_dict(flax_to_state_dict({"layer": params}, holder))
    with torch.no_grad():
        got = holder.layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 5 * k, 6 * k, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL, rtol=0)


@pytest.mark.parametrize("groups", [1, 2])
def test_group_norm_matches_flax(groups):
    rng = np.random.default_rng(4)
    x = (0.5 + rng.standard_normal((2, 5, 6, 8))).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=groups, epsilon=1e-5)
    params = _perturbed(gn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = np.asarray(gn.apply({"params": params}, jnp.asarray(x)))
    holder = _Holder(GroupNorm32(groups, 8))
    holder.load_state_dict(flax_to_state_dict({"layer": params}, holder))
    with torch.no_grad():
        got = holder.layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL, rtol=0)


def test_conv3_replicate_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, t):
            return jconv3_replicate(t, 4, "layer", jnp.float32)

    params = _perturbed(J().init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = np.asarray(J().apply({"params": params}, jnp.asarray(x)))
    holder = _Holder(Conv3Replicate(3, 4, torch.float32))
    holder.load_state_dict(flax_to_state_dict(params, holder))
    with torch.no_grad():
        got = holder.layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_TOL, rtol=0)
