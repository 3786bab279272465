"""The port's SAM (`models/sam.py`) against the JAX package's, on the CPU in
float32 at `SamConfig.tiny_test()`, with the same parameters (a seeded tree
of the JAX shapes) and inputs made from a seed with numpy:

  * `SamCore` (encoder + prompt encoder + decoder), multimask on and off,
    with a `-10` pad label among the prompts: mask logits and IoU
    predictions within TOL;
  * the encoder (windowed blocks only) on a 48-px input, whose 6x6 grid
    differs from the parameters' 8x8 (bicubic `pos_embed`, windows padded),
    and `_get_rel_pos` shrinking and growing a table of another length:
    within TOL;
  * `convert_sam` on a seeded `transformers` `SamModel` state dict
    (`chip_smoke.released_sam_state`) gives the JAX converter's tree
    exactly, and the port's model loads it;
  * `SamAutoSegmentation.segment`: the grid's logits within SEG_TOL of
    the JAX decoder's, the same number of masks, each IoU >= 0.99 with its
    JAX counterpart; the chunked decode (chunks 16 and 6, a padded tail)
    equal to one call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.models import sam as jsam
from labelany3d_tpu_torch.models import sam as tsam
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_convert import _assert_same_tree
from tests.torch_parity import random_flax_params

TOL = 1e-5        # float32, sums in another order
SEG_TOL = 1e-4    # the grid's logits, after the encoder and decoder
MASK_IOU = 0.99

torch.set_num_threads(1)


def _tcfg(**kw):
    return tsam.SamConfig.tiny_test(dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def sam():
    cfg = jsam.SamConfig.tiny_test(dtype=jnp.float32)
    params = random_flax_params(
        jsam.SamCore(cfg).init, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 1, 2)),
        jnp.ones((1, 1, 1), jnp.int32), seed=5)
    # Unit normals where Flax draws them (the Fourier matrix, the point and
    # mask tokens), so that the grid's prompts give distinct masks.
    rng = np.random.default_rng(7)
    for path in (("shared_pe", "positional_embedding"), ("point_embed",), ("not_a_point",),
                 ("decoder", "mask_tokens"), ("decoder", "iou_token")):
        node = params
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = rng.standard_normal(node[path[-1]].shape).astype(np.float32)
    model = tsam.SamCore(_tcfg())
    model.load_state_dict(flax_to_state_dict(params, model))
    return cfg, params, model.eval()


def _inputs(seed, size=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    pts = rng.uniform(0, size, (1, 3, 2, 2)).astype(np.float32)
    labs = np.array([[[1, 0], [1, -10], [0, 1]]], np.int32)
    return x, pts, labs


@pytest.mark.parametrize("multimask", [True, False])
def test_sam_core_matches_jax(sam, multimask):
    cfg, params, model = sam
    x, pts, labs = _inputs(0)
    want = jax.jit(lambda p, a, b, c: jsam.SamCore(cfg).apply(
        {"params": p}, a, b, c, multimask_output=multimask))(params, x, pts, labs)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(pts), torch.from_numpy(labs),
                    multimask_output=multimask)
    assert got[0].shape == (1, 3, 3 if multimask else 1, 32, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_sam_encoder_at_another_grid_matches_jax():
    """All blocks windowed (a global block's tables are sized by the
    config's grid): `pos_embed` resized 8x8 -> 6x6, windows padded 6 -> 8."""
    cfg = dataclasses.replace(jsam.SamConfig.tiny_test(dtype=jnp.float32),
                              global_attn_indexes=())
    params = random_flax_params(jsam.SamVisionEncoder(cfg).init, jnp.zeros((1, 64, 64, 3)),
                                seed=6)
    x, _, _ = _inputs(1, size=48)
    want = jax.jit(lambda p, a: jsam.SamVisionEncoder(cfg).apply({"params": p}, a))(params, x)
    model = tsam.SamVisionEncoder(dataclasses.replace(_tcfg(), global_attn_indexes=()))
    model.load_state_dict(flax_to_state_dict(params, model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (1, 6, 6, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size,length", [(6, 15), (10, 15), (4, 7)])
def test_get_rel_pos_matches_jax(size, length):
    table = np.random.default_rng(size).normal(size=(length, 5)).astype(np.float32)
    want = jsam._get_rel_pos(size, size, jnp.asarray(table))
    got = tsam._get_rel_pos(size, size, torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_convert_sam_matches_jax():
    cfg = _tcfg()
    state = chip_smoke.released_sam_state(cfg, std=0.1)
    tree = tsam.convert_sam(state, cfg)
    _assert_same_tree(tree, jsam.convert_sam(state, jsam.SamConfig.tiny_test()))
    model = tsam.SamCore(cfg)
    model.load_state_dict(flax_to_state_dict(tree, model))


def _image(seed, hw=(40, 56)):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), dtype=np.uint8)


RELAXED = dict(pred_iou_thresh=-1e9, stability_thresh=0.0, min_area_frac=0.0)


@pytest.mark.parametrize("thresholds", [RELAXED, dict(RELAXED, nms_iou=0.3)],
                         ids=["relaxed", "nms_0.3"])
def test_auto_segmentation_matches_jax(sam, thresholds):
    cfg, params, _ = sam
    image = _image(2)
    jseg = jsam.SamAutoSegmentation(cfg, params=params, points_per_side=4, **thresholds)
    want_masks = jseg.segment(image)
    tseg = tsam.SamAutoSegmentation(_tcfg(), params=params, points_per_side=4, device="cpu",
                                    **thresholds)
    logits, iou = tseg.decode_grid(image)
    # The JAX decoder over the same grid in one call.
    ar = (np.arange(4) + 0.5) / 4 * 64
    xx, yy = np.meshgrid(ar, ar)
    pts = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32)[None, :, None]
    emb = jseg._encode(params["vision"], jnp.asarray(tseg.preprocess(image).numpy()))
    wm, wi = jseg._decode(params, emb, pts, jnp.ones((1, 16, 1), jnp.int32))
    np.testing.assert_allclose(logits, np.asarray(wm[0]), rtol=SEG_TOL, atol=SEG_TOL)
    np.testing.assert_allclose(iou, np.asarray(wi[0]), rtol=SEG_TOL, atol=SEG_TOL)

    got_masks = tseg.select(logits, iou, image.shape[:2])
    assert len(got_masks) == len(want_masks) >= 1
    for g, w in zip(got_masks, want_masks):
        assert g.shape == image.shape[:2] and g.dtype == bool
        assert (g & w).sum() / max((g | w).sum(), 1) >= MASK_IOU


def test_chunked_decode_matches_one_call(sam):
    _, params, _ = sam
    image = _image(3)
    outs = []
    for chunk in (16, 6):  # 6 does not divide the 16 prompts: a padded tail
        seg = tsam.SamAutoSegmentation(_tcfg(), params=params, points_per_side=4,
                                       prompt_chunk=chunk, device="cpu", **RELAXED)
        outs.append((seg.decode_grid(image), seg.segment(image)))
    (la, ia), ma = outs[0]
    (lb, ib), mb = outs[1]
    np.testing.assert_allclose(lb, la, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ib, ia, rtol=TOL, atol=TOL)
    assert len(ma) == len(mb) >= 1
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)


def test_random_init_draws_flax_distributions():
    """Without weights: position tables zero, tokens unit normal, kernels
    lecun-normal, from a seeded generator (the same seed, the same model)."""
    cfg = _tcfg()
    a = tsam.SamAutoSegmentation(cfg, device="cpu", seed=4)
    b = tsam.SamAutoSegmentation(cfg, device="cpu", seed=4)
    a._ensure()
    b._ensure()
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    assert not sa["vision.pos_embed"].any() and not sa["vision.block1.attn.rel_pos_h"].any()
    assert 0.5 < float(sa["decoder.mask_tokens"].std()) < 1.5
    qkv = sa["vision.block0.attn.qkv.weight"]
    assert abs(float(qkv.std()) * np.sqrt(qkv.shape[1]) - 1.0) < 0.2
