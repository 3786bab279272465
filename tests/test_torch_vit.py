"""ViT encoder: the port against the JAX package, same parameters, float32.

Flax `init` parameters are carried across by `models/weights.py`. On the CPU
the JAX encoder runs unpadded XLA attention while the port pads to 128 and
masks, so agreement also checks the masking. Tolerance 2e-4 absolute on
tokens of unit scale: two f32 layers summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models.vit import ViT as JViT
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu_torch.models.vit import ViT, ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict, init_params_

TOL = 2e-4


def _pair(**kw):
    jcfg = dataclasses.replace(JViTConfig.tiny_test(**kw), dtype=jnp.float32)
    tcfg = dataclasses.replace(ViTConfig.tiny_test(**kw), dtype=torch.float32)
    return jcfg, tcfg


@pytest.mark.parametrize("hw, out_indices", [
    ((40, 48), (0, 1)),   # 31 tokens, padded to 128
    ((8, 1016), (1,)),    # 128 tokens, no pad rows
])
def test_vit_matches_jax(hw, out_indices):
    jcfg, tcfg = _pair(out_indices=out_indices)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    jm = JViT(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    # Perturb LayerScale/cls params away from their constant init
    # so every parameter's mapping is exercised.
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)
    want = jm.apply({"params": params}, jnp.asarray(images))

    model = ViT(tcfg, (hw[0] // 8, hw[1] // 8))
    model.load_state_dict(flax_to_state_dict(params, model))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got["grid"] == tuple(want["grid"])
    np.testing.assert_allclose(got["tokens"].numpy(), np.asarray(want["tokens"]), atol=TOL)
    np.testing.assert_allclose(got["cls"].numpy(), np.asarray(want["cls"]), atol=TOL)
    assert len(got["hiddens"]) == len(want["hiddens"])
    for g, w in zip(got["hiddens"], want["hiddens"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_weight_mapping_rejects_mismatch():
    jcfg, tcfg = _pair()
    params = JViT(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    model = ViT(tcfg, (2, 2))
    extra = dict(params)
    extra["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        flax_to_state_dict(extra, model)
    partial = {k: v for k, v in params.items() if k != "norm"}
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict(partial, model)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(params, ViT(tcfg, (3, 3)))


def test_random_init_is_seeded_and_scaled():
    _, tcfg = _pair()
    a = init_params_(ViT(tcfg, (2, 2)), torch.Generator().manual_seed(3))
    b = init_params_(ViT(tcfg, (2, 2)), torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.block0.mlp.fc1.weight
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.03  # lecun: var 1/fan_in
    assert a.block0.ls1.gamma.eq(1e-5).all() and a.cls_token.eq(0).all()


def test_resize_pos_embed_not_ported():
    """A live grid other than the pos-embed's resizes the embedding (once
    not ported, now `resize_pos_embed`): a model built for a 2 x 2 grid
    runs a 3 x 3 one as the JAX model with `pos_grid=(2, 2)` does."""
    jcfg, tcfg = _pair()
    jcfg = dataclasses.replace(jcfg, pos_grid=(2, 2))
    images = np.random.default_rng(1).uniform(size=(1, 24, 24, 3)).astype(np.float32)
    jm = JViT(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    want = jm.apply({"params": params}, jnp.asarray(images))
    model = ViT(tcfg, (2, 2))
    model.load_state_dict(flax_to_state_dict(params, model))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got["grid"] == (3, 3)
    np.testing.assert_allclose(got["tokens"].numpy(), np.asarray(want["tokens"]), atol=TOL)
