"""The port's SegFormer (`models/segformer.py`) against the JAX package's, on
the CPU in float32 at `SegFormerConfig.tiny_test()`, with the same
parameters (a seeded tree of the JAX shapes with positive BatchNorm
variances) and inputs made from a seed with numpy:

  * the logits on a 32x48 batch of 2, and on a 36x52 image whose 9x13
    first stage is padded (Flax's SAME) for the 2x2 sequence reduction:
    within TOL;
  * `convert_segformer` on a seeded `transformers` state dict
    (`chip_smoke.released_segformer_state`) gives the JAX converter's tree
    exactly, and the port's model loads it;
  * the thing/stuff split (the stuff table and `thing_ids_from_id2label`
    on the ADE20K table and on a custom one) equal to JAX's;
  * `SegformerForeground.semantic` and `.foreground` (Pillow's resizes on
    both sides) equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.models import segformer as jseg
from labelany3d_tpu_torch.models import segformer as tseg
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_convert import _assert_same_tree
from tests.torch_parity import random_flax_params

TOL = 1e-5  # float32, sums in another order

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def segformer():
    cfg = jseg.SegFormerConfig.tiny_test()
    params = random_flax_params(jseg.SegFormer(cfg).init, jnp.zeros((1, 32, 32, 3)), seed=8)
    params["bn_var"] = np.abs(params["bn_var"]) + 0.5
    # No class favoured by its bias alone, so the class map varies.
    params["classifier"]["bias"] = np.zeros_like(params["classifier"]["bias"])
    model = tseg.SegFormer(tseg.SegFormerConfig.tiny_test())
    model.load_state_dict(flax_to_state_dict(params, model))
    return cfg, params, model.eval()


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 36, 52)])
def test_segformer_logits_match_jax(segformer, shape):
    cfg, params, model = segformer
    x = np.random.default_rng(shape[1]).normal(size=shape + (3,)).astype(np.float32)
    want = jax.jit(lambda p, a: jseg.SegFormer(cfg).apply({"params": p}, a))(params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_convert_segformer_matches_jax():
    cfg = tseg.SegFormerConfig.tiny_test()
    state = chip_smoke.released_segformer_state(cfg, std=0.1)
    tree = tseg.convert_segformer(state, cfg)
    _assert_same_tree(tree, jseg.convert_segformer(state, jseg.SegFormerConfig.tiny_test()))
    model = tseg.SegFormer(cfg)
    model.load_state_dict(flax_to_state_dict(tree, model))


@pytest.mark.parametrize("table", ["ade20k", "custom"])
def test_thing_stuff_split_matches_jax(table):
    assert tseg.ADE20K_STUFF_NAMES == jseg.ADE20K_STUFF_NAMES
    assert tseg.ADE20K_ID2LABEL == jseg.ADE20K_ID2LABEL
    id2label = (tseg.ADE20K_ID2LABEL if table == "ade20k" else
                {0: "wall", 1: "chair", 2: "Floor", 3: "column, pillar", 4: "blanket, cover",
                 5: "car"})
    got = tseg.thing_ids_from_id2label(id2label)
    np.testing.assert_array_equal(got, jseg.thing_ids_from_id2label(id2label))
    assert 0 < len(got) < len(id2label)


def test_segformer_foreground_matches_jax(segformer):
    _, params, _ = segformer
    id2label = {0: "wall", 1: "chair", 2: "floor", 3: "person", 4: "sky", 5: "car"}
    image = np.random.default_rng(9).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    want = jseg.SegformerForeground(jseg.SegFormerConfig.tiny_test(), params=params,
                                    id2label=id2label, input_size=32)
    got = tseg.SegformerForeground(tseg.SegFormerConfig.tiny_test(), params=params,
                                   id2label=id2label, input_size=32, device="cpu")
    np.testing.assert_array_equal(got.thing_ids, want.thing_ids)
    cls = got.semantic(image)
    np.testing.assert_array_equal(cls, want.semantic(image))
    assert len(np.unique(cls)) > 1
    fg = got.foreground(image)
    assert fg.dtype == bool and fg.shape == (40, 56) and 0 < fg.sum() < fg.size
    np.testing.assert_array_equal(fg, want.foreground(image))
