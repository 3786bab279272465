"""The port's checkpoint converters (`models/convert.py`) against the JAX
package's (`labelany3d_tpu/models/convert.py`).

Synthetic state dicts with the released torch names and shapes, at tiny
sizes, come from `chip_smoke.released_*_state` (the functions its phase 8 runs
at full size): MoGe (`backbone.*`, `head.*`), DepthPro (`depth_pro.pt`) and
MASt3R (croco encoder and decoders, `downstream_head1/2`). For each:
  * the port's converter gives the JAX converter's tree exactly (same keys,
    equal arrays);
  * the port model loaded through it (`flax_to_state_dict`) equals the JAX
    model applied to the JAX tree on the same input, in float32: 1e-4
    relative (atol 1e-5; the matcher's 3D points relative to each point's
    norm).
Weights are N(0, 0.1^2) here (those functions default to phase 8's 0.02)
so the outputs vary enough to compare.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.models import convert as jconvert
from labelany3d_tpu.models import depth_pro as jdp
from labelany3d_tpu.models import matcher as jmatcher
from labelany3d_tpu.models import moge as jmoge
from labelany3d_tpu_torch.models import convert, depth_pro, matcher, moge
from labelany3d_tpu_torch.models.weights import flax_to_state_dict

RTOL = 1e-4
ATOL = 1e-5
STD = 0.1


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_tree(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


def _f32(cfg, dtype, *vits):
    return dataclasses.replace(cfg, dtype=dtype, **{
        k: dataclasses.replace(getattr(cfg, k), dtype=dtype) for k in vits})


def _close(got, want, points=False):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    if points:
        err = np.linalg.norm(g - w, axis=-1)
        assert np.all(err <= RTOL * np.linalg.norm(w, axis=-1) + ATOL)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_convert_moge_checkpoint_matches_jax():
    grid = (5, 5)
    jcfg = jmoge.MoGeConfig.tiny_reference_test()
    jcfg = _f32(dataclasses.replace(
        jcfg, backbone=dataclasses.replace(jcfg.backbone, pos_grid=grid)), jnp.float32,
        "backbone")
    tcfg = moge.MoGeConfig.tiny_reference_test()
    tcfg = _f32(dataclasses.replace(
        tcfg, backbone=dataclasses.replace(tcfg.backbone, pos_grid=grid)), torch.float32,
        "backbone")
    state = chip_smoke.released_moge_state(tcfg, std=STD)
    assert "head.upsample_blocks.0.0.0.weight" in state and "head.output_block.1.2.weight" in state
    tree = convert.convert_moge_checkpoint(state, tcfg, grid)
    _assert_same_tree(tree, jconvert.convert_moge_checkpoint(state, jcfg, grid))

    hw = (32, 32)  # a 4 x 4 grid: the 5 x 5 pos-embed is resized
    images = np.random.default_rng(0).uniform(size=(2, *hw, 3)).astype(np.float32)
    jm = jmoge.MoGeModel(jcfg)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(tree, jnp.asarray(images))
    tm = moge.MoGeModel(tcfg, hw)
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images))
    for key in ("points", "mask"):
        _close(got[key], want[key])


def test_convert_depth_pro_matches_jax():
    vits = ("patch_encoder", "image_encoder", "fov_encoder")
    jcfg = _f32(jdp.DepthPro35Config.tiny_test(), jnp.float32, *vits)
    tcfg = _f32(depth_pro.DepthPro35Config.tiny_test(), torch.float32, *vits)
    state = chip_smoke.released_depth_pro_state(tcfg, std=STD)
    tree = convert.convert_depth_pro(state, tcfg)
    _assert_same_tree(tree, jconvert.convert_depth_pro(state, jcfg))

    s = tcfg.img_size
    images = np.random.default_rng(1).uniform(size=(1, s, s, 3)).astype(np.float32)
    jm = jdp.DepthPro35(jcfg)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(tree, jnp.asarray(images))
    tm = depth_pro.DepthPro35(tcfg)
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(images))
    for key in ("canonical_inverse_depth", "fov_deg"):
        _close(got[key], want[key])


@pytest.mark.parametrize("shared_decoder", [False, True])
def test_convert_mast3r_matches_jax(shared_decoder):
    jcfg = _f32(jmatcher.MatcherConfig.tiny_catmlpdpt_test(), jnp.float32, "encoder")
    tcfg = _f32(matcher.MatcherConfig.tiny_catmlpdpt_test(), torch.float32, "encoder")
    state = chip_smoke.released_mast3r_state(tcfg, std=STD)
    if shared_decoder:  # checkpoints whose two decoders share dec_blocks
        state = {k: v for k, v in state.items() if not k.startswith("dec_blocks2.")}
    tree = convert.convert_mast3r(state, tcfg)
    _assert_same_tree(tree, jconvert.convert_mast3r(state, jcfg))
    _assert_same_tree(convert.convert_mast3r_head(state, tcfg, "downstream_head2."),
                      jconvert.convert_mast3r_head(state, jcfg, "downstream_head2."))

    hw = (64, 64)
    rng = np.random.default_rng(2)
    img0 = rng.uniform(size=(1, *hw, 3)).astype(np.float32)
    img1 = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    jm = jmatcher.TwoViewMatcher(jcfg)
    want = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        tree, jnp.asarray(img0), jnp.asarray(img1))
    tm = matcher.TwoViewMatcher(tcfg, (4, 4))
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(img0), torch.from_numpy(img1))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], points=key.startswith("pts3d"))


def test_load_torch_checkpoint_matches_jax(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    for name, obj in (("plain.pt", sd), ("wrapped.pt", {"model": sd})):
        torch.save(obj, tmp_path / name)
        got = convert.load_torch_checkpoint(str(tmp_path / name))
        _assert_same_tree(got, jconvert.load_torch_checkpoint(str(tmp_path / name)))
        np.testing.assert_array_equal(got["a.weight"], sd["a.weight"].numpy())
