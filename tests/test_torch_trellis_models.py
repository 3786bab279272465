"""TRELLIS's models in the port against the JAX package on the CPU, float32,
at `tiny_test()` sizes: the same numpy inputs and the same parameters (a
seeded tree of the JAX shapes, `tests/torch_parity.py::random_flax_params`,
carried across by `flax_to_state_dict`).

Tolerance: 1e-4 absolute and relative (float32 through a few blocks whose
sums run in another order). Gates and output layers are random, not zero,
so every branch reaches the output. The SLat flow's invalid slots are 0 in
both packages; its valid rows are compared (pad queries are masked keys
only, as the JAX package's CPU path does).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from labelany3d_tpu.models.trellis import decoders as jdec
from labelany3d_tpu.models.trellis import dit as jdit
from labelany3d_tpu.models.trellis import slat as jslat
from labelany3d_tpu.models.trellis import sparse_structure as jss
from labelany3d_tpu_torch.models.trellis import decoders as tdec
from labelany3d_tpu_torch.models.trellis import dit as tdit
from labelany3d_tpu_torch.models.trellis import slat as tslat
from labelany3d_tpu_torch.models.trellis import sparse_structure as tss
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_trellis_ops import voxels
from tests.torch_parity import random_flax_params

TOL = 1e-4


def f32(cfg, dtype):
    """`cfg` with every nested `dtype` field set to `dtype`."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            kw[f.name] = dtype
        elif dataclasses.is_dataclass(v):
            kw[f.name] = f32(v, dtype)
    return dataclasses.replace(cfg, **kw)


def jcfg(cfg):
    return f32(cfg, jnp.float32)


def tcfg(cfg):
    return f32(cfg, torch.float32)


def port(model, params):
    model.load_state_dict(flax_to_state_dict(params, model))
    return model.eval().requires_grad_(False)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["dense", "masked", "share_mod"])
def test_dit_block_matches_jax(mode):
    jc = jcfg(jdit.DiTConfig.tiny_test(qk_rms_norm=True, qk_rms_norm_cross=mode == "dense",
                                       share_mod=mode == "share_mod"))
    tc = tcfg(tdit.DiTConfig.tiny_test(qk_rms_norm=True, qk_rms_norm_cross=mode == "dense",
                                       share_mod=mode == "share_mod"))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, jc.width)).astype(np.float32)
    temb = rng.standard_normal((2, jc.width)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, jc.cond_dim)).astype(np.float32)
    valid = np.arange(40)[None].repeat(2, 0) < np.array([[33], [40]])
    mods = tuple(rng.standard_normal((6, 2, jc.width)).astype(np.float32))
    jblk, tblk = jdit.DiTBlock(jc), tdit.DiTBlock(tc)
    kw = dict(t_emb=temb, cond_tokens=ctx,
              attn_spec=("masked", valid) if mode == "masked" else None,
              mods=mods if mode == "share_mod" else None)
    params = random_flax_params(lambda key, x: jblk.init(key, x, **kw), x, seed=1)
    want = jax.jit(lambda p, x, t, c, m: jblk.apply({"params": p}, x, t_emb=t, cond_tokens=c,
                                                    attn_spec=kw["attn_spec"], mods=m))(
        params, x, temb, ctx, kw["mods"])
    tkw = {k: (tuple(map(_t, v)) if isinstance(v, tuple) and k == "mods" else v)
           for k, v in kw.items()}
    tkw["attn_spec"] = ("masked", _t(valid)) if mode == "masked" else None
    got = port(tblk, params)(_t(x), t_emb=_t(temb), cond_tokens=_t(ctx),
                             attn_spec=tkw["attn_spec"], mods=tkw["mods"])
    close(got, want)


def test_transformer_block_windowed_matches_jax():
    jc = jcfg(jdec.SLatDecoderConfig.tiny_test()).dit()
    tc = tcfg(tdec.SLatDecoderConfig.tiny_test()).dit()
    coords, valid = voxels(120, 160, 16, seed=2)
    x = np.random.default_rng(3).standard_normal((1, 160, jc.width)).astype(np.float32)
    spec = ("windowed", coords[None], valid[None], 2, 16, 4)
    jblk = jdit.TransformerBlock(jc)
    params = random_flax_params(lambda key, x: jblk.init(key, x, spec), x, seed=4)
    want = jblk.apply({"params": params}, x, spec)
    got = port(tdit.TransformerBlock(tc), params)(
        _t(x), ("windowed", _t(coords)[None], _t(valid)[None], 2, 16, 4))
    close(got[0][valid], np.asarray(want)[0][valid])


def test_sparse_structure_flow_matches_jax():
    jc, tc = jcfg(jss.SparseStructureConfig.tiny_test()), tcfg(tss.SparseStructureConfig.tiny_test())
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, jc.latent_res ** 3, jc.latent_channels)).astype(np.float32)
    t = np.array([500.0, 120.0], np.float32)
    cond = rng.standard_normal((2, 6, jc.dit.cond_dim)).astype(np.float32)
    jm = jss.SparseStructureFlowModel(jc)
    params = random_flax_params(jm.init, x, t, cond, seed=6)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, x, t, cond)
    got = port(tss.SparseStructureFlowModel(tc), params)(_t(x), _t(t), _t(cond))
    close(got, want)


@pytest.mark.parametrize("norm_type", ["layer", "group"])
def test_structure_decoder_and_occupancy_match_jax(norm_type):
    kw = dict(norm_type=norm_type, channels=(32, 32, 32)) if norm_type == "group" else {}
    jc = jcfg(dataclasses.replace(jss.SSDecoderConfig.tiny_test(), **kw))
    tc = tcfg(dataclasses.replace(tss.SSDecoderConfig.tiny_test(), **kw))
    lat = np.random.default_rng(7).standard_normal((1, 64, jc.latent_channels)).astype(np.float32)
    jm = jss.StructureDecoder(jc, latent_res=4)
    params = random_flax_params(jm.init, lat, seed=8)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, lat)
    got = port(tss.StructureDecoder(tc, latent_res=4), params)(_t(lat))
    assert got.shape == (1, 16, 16, 16)
    close(got, want)
    # Top-K on the same logits; ties (a plateau of equal logits) by the
    # lower flat index, as jax.lax.top_k orders them.
    logits = np.asarray(want).copy()
    logits[0, 3:9] = 7.0
    jc_, jv = jss.decode_occupancy(jnp.asarray(logits), 700)
    tc_, tv = tss.decode_occupancy(_t(logits), 700)
    np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def slat_inputs():
    """SLat flow inputs (a CFG-style batch of 2) and one parameter tree."""
    jc = jcfg(jslat.SLatConfig.tiny_test())
    coords, valid = voxels(170, 200, 16, seed=9)
    rng = np.random.default_rng(10)
    feats = rng.standard_normal((2, 200, jc.latent_channels)).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    cond = rng.standard_normal((2, 5, jc.dit.cond_dim)).astype(np.float32)
    c2, v2 = np.broadcast_to(coords, (2, 200, 3)), np.broadcast_to(valid, (2, 200))
    params = random_flax_params(jslat.SLatFlowModel(jc).init, feats, c2, v2, t, cond, seed=11)
    return params, valid, (feats, c2, v2, t, cond)


@pytest.mark.parametrize("torso_slots", [None, 64])
def test_slat_flow_matches_jax(torso_slots, slat_inputs):
    params, valid, (feats, c2, v2, t, cond) = slat_inputs
    jc, tc = jcfg(jslat.SLatConfig.tiny_test()), tcfg(tslat.SLatConfig.tiny_test())
    jm = jslat.SLatFlowModel(jc)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, torso_slots=torso_slots))(
        params, feats, c2, v2, t, cond)
    got = port(tslat.SLatFlowModel(tc), params)(_t(feats), _t(c2.copy()), _t(v2.copy()), _t(t),
                                                _t(cond), torso_slots=torso_slots)
    assert not got[:, ~valid].any()
    close(got[:, valid], np.asarray(want)[:, valid])


@pytest.fixture(scope="module")
def decoder_inputs():
    coords, valid = voxels(150, 192, 16, seed=12)
    feats = np.random.default_rng(13).standard_normal((192, 4)).astype(np.float32)
    return feats, coords, valid


def test_gaussian_decoder_matches_jax(decoder_inputs):
    rep = jdec.GaussianRepConfig(num_gaussians=4)
    trep = tdec.GaussianRepConfig(num_gaussians=4)
    jm = jdec.SLatGaussianDecoder(jcfg(jdec.SLatDecoderConfig.tiny_test()), rep=rep)
    params = random_flax_params(jm.init, *decoder_inputs, seed=14)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *decoder_inputs)
    got = port(tdec.SLatGaussianDecoder(tcfg(tdec.SLatDecoderConfig.tiny_test()), trep),
               params)(*map(_t, decoder_inputs))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    for name in ("means", "scales", "rotations", "opacities", "colors"):
        close(getattr(got, name)[v], np.asarray(getattr(want, name))[v])


def test_mesh_decoder_matches_jax(decoder_inputs):
    jm = jdec.SLatMeshDecoder(jcfg(jdec.SLatDecoderConfig.tiny_test()))
    params = random_flax_params(jm.init, *decoder_inputs, seed=15)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *decoder_inputs)
    got = port(tdec.SLatMeshDecoder(tcfg(tdec.SLatDecoderConfig.tiny_test())), params)(
        *map(_t, decoder_inputs))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    v = np.asarray(want[2])
    assert got[0].shape == (192 * 64, 101)
    close(got[0][v], np.asarray(want[0])[v])
