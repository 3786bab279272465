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
relative. The head keeps those shape-only constants once built
(`moge._head_constant`): kept and fresh ones, and the model's outputs and
gradients with the constants kept or rebuilt, are held bit for bit.
"""

import dataclasses
import sys
import threading

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


def _fresh_uv(h, w, aspect, pad, dtype):
    uv = moge._view_plane_uv(h, w, aspect)
    if pad:
        uv = np.pad(uv, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    return torch.from_numpy(uv).to(dtype).permute(2, 0, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, pad", [((37, 37), 0), ((12, 20), 0), ((37, 37), 1), ((48, 64), 1)])
def test_cached_uv_plane_is_the_fresh_one(hw, pad, dtype):
    """The kept UV plane, cold and warm, equals one built afresh bit for bit."""
    moge.clear_head_constants()
    h, w = hw
    aspect = w / h
    x = torch.randn(2, 3, h + 2 * pad, w + 2 * pad).to(dtype)
    want = _fresh_uv(h, w, aspect, pad, dtype)
    for _ in range(2):
        got = moge._cat_uv(x, aspect, pad=pad)
        assert got.dtype == dtype and got.shape == (2, 5, h + 2 * pad, w + 2 * pad)
        assert torch.equal(got[:, :3], x)
        assert torch.equal(got[:, 3:], want.expand(2, -1, -1, -1))
    kept = moge._HEAD_CONSTANTS[("uv", h, w, aspect, pad, dtype, x.device)]
    assert torch.equal(kept, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_hw, out_hw", [((8, 8), (32, 32)), ((12, 16), (48, 64)),
                                           ((148, 148), (518, 518)), ((36, 20), (50, 70))])
def test_cached_tap_matrices_are_the_fresh_ones(in_hw, out_hw, dtype):
    """The kept tap matrices equal fresh ones bit for bit, and so does the
    resize made with them, cold and warm."""
    moge.clear_head_constants()
    x = torch.randn(2, 3, *in_hw).to(dtype)
    fresh = [torch.as_tensor(moge._resize_matrix(n, o, 1), dtype=dtype)
             for n, o in zip(in_hw, out_hw)]
    want = torch.matmul(torch.matmul(fresh[0], x), fresh[1].t())
    for _ in range(2):
        assert torch.equal(moge._resize_bilinear_pad(x, out_hw), want)
    for (n, o), g in zip(zip(in_hw, out_hw), fresh):
        assert torch.equal(moge._HEAD_CONSTANTS[("taps", n, o, 1, dtype, x.device)], g)


def _tiny_reference_model(hw):
    torch.manual_seed(0)
    return moge.MoGeModel(moge.MoGeConfig.tiny_reference_test(), hw).float()


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_head_constants_build_once_a_key_then_only_hit(hw):
    """One build for each distinct key, then hits only: a forward of the
    reference head asks for one UV plane a level, one padded plane at the
    image size and two tap matrices (one key when the image is square)."""
    cfg = moge.MoGeConfig.tiny_reference_test()
    tm = _tiny_reference_model(hw).eval()
    x = torch.rand(1, *hw, 3)
    moge.clear_head_constants()
    builds, hits = moge.HEAD_CONSTANT_BUILDS.count, moge.HEAD_CONSTANT_HITS.count
    asks = len(cfg.dim_upsample) + 1 + 2
    keys = asks - (1 if hw[0] == hw[1] else 0)
    with torch.no_grad():
        tm(x)
    assert moge.HEAD_CONSTANT_BUILDS.count - builds == keys
    assert moge.HEAD_CONSTANT_HITS.count - hits == asks - keys
    assert len(moge._HEAD_CONSTANTS) == keys
    for n in range(1, 4):
        with torch.no_grad():
            tm(x)
        assert moge.HEAD_CONSTANT_BUILDS.count - builds == keys
        assert moge.HEAD_CONSTANT_HITS.count - hits == asks - keys + n * asks
    moge.clear_head_constants()
    assert len(moge._HEAD_CONSTANTS) == 0


def test_head_constants_stay_bounded():
    moge.clear_head_constants()
    for n in range(moge._HEAD_CONSTANTS_MAX + 10):
        moge._resize_bilinear_pad(torch.zeros(1, 1, 2, 2 + n), (4, 4))
    assert len(moge._HEAD_CONSTANTS) == moge._HEAD_CONSTANTS_MAX
    assert ("taps", 2, 4, 1, torch.float32, torch.device("cpu")) in moge._HEAD_CONSTANTS


def test_head_constants_shared_by_threads():
    """Threads asking for the same few keys at once: each key is built once,
    and every call is counted as a build or a hit."""
    moge.clear_head_constants()
    builds, hits = moge.HEAD_CONSTANT_BUILDS.count, moge.HEAD_CONSTANT_HITS.count
    shapes = [(2, 3 + k) for k in range(4)]
    calls, workers = 50, 16
    errors = []

    def work():
        try:
            for i in range(calls):
                moge._cat_uv(torch.zeros(1, 1, *shapes[i % len(shapes)]), 1.5)
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert moge.HEAD_CONSTANT_BUILDS.count - builds == len(shapes)
    assert moge.HEAD_CONSTANT_HITS.count - hits == calls * workers - len(shapes)


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_outputs_and_gradients_same_cold_and_warm(hw):
    """The tiny reference MoGe's outputs and gradients are bit-identical
    with the constants rebuilt before every call and with them kept."""
    tm = _tiny_reference_model(hw)
    x = torch.rand(2, *hw, 3, generator=torch.Generator().manual_seed(1))

    def run(cold):
        if cold:
            moge.clear_head_constants()
        tm.zero_grad(set_to_none=True)
        out = tm(x)
        (out["points"].square().mean() + out["mask"].mean()).backward()
        return ({k: v.detach().clone() for k, v in out.items()},
                {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None})

    cold_out, cold_grad = run(True)
    for _ in range(2):
        warm_out, warm_grad = run(False)
        for k in cold_out:
            assert torch.equal(warm_out[k], cold_out[k]), k
        assert warm_grad.keys() == cold_grad.keys() and cold_grad
        for n in cold_grad:
            assert torch.equal(warm_grad[n], cold_grad[n]), n


def test_constants_built_in_inference_mode_serve_a_training_step():
    """A constant first asked for under `torch.inference_mode` (the depth
    backend) is a normal tensor, so a later training forward at the same
    shape can save it for its backward. The constants are no buffers."""
    tm = _tiny_reference_model((32, 32))
    x = torch.rand(1, 32, 32, 3)
    moge.clear_head_constants()
    names = list(tm.state_dict())
    with torch.inference_mode():
        tm(x)
    assert not any(t.is_inference() for t in moge._HEAD_CONSTANTS.values())
    tm(x)["points"].sum().backward()
    assert tm.head.up0_deconv.weight.grad is not None
    assert moge._HEAD_CONSTANTS and list(tm.state_dict()) == names
