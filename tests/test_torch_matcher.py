"""The matcher's pieces: 2D RoPE, (B, S, H, D) attention, TwoViewMatcher
and the matcher backend, the port against the JAX package on the CPU in
float32.

On the CPU `labelany3d_tpu.ops.attention.flash_sdpa` runs XLA's
`dot_product_attention` (keys masked by segment ids), and the port's
`flash_sdpa` its plain PyTorch version. The matcher runs at
`MatcherConfig.tiny_test()` with float32 dtypes, with the JAX package's
`init` parameters carried across by `models/weights.py`. Tolerances: 1e-5
for RoPE and attention (f32 softmax over <= 64 keys, summed in another
order), 1e-4 for the matcher's outputs (two encoder and two decoder blocks
of unit-scale f32 arithmetic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models.matcher import MatcherConfig as JMatcherConfig
from labelany3d_tpu.models.matcher import TwoViewMatcher as JTwoViewMatcher
from labelany3d_tpu.models.matcher import match_images as jmatch_images
from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
from labelany3d_tpu.ops.attention import flash_sdpa as jflash_sdpa
from labelany3d_tpu.ops.rope2d import apply_rope_2d as japply_rope_2d
from labelany3d_tpu.ops.rope2d import rope_2d_freqs as jrope_2d_freqs
from labelany3d_tpu_torch.models.matcher import MatcherConfig, TwoViewMatcher, match_images
from labelany3d_tpu_torch.models.vit import ViTConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from labelany3d_tpu_torch.ops import attention as att
from labelany3d_tpu_torch.ops.rope2d import apply_rope_2d, rope_2d_freqs

ATTN_TOL = 1e-5
MODEL_TOL = 1e-4


def test_rope2d_matches_jax():
    rng = np.random.default_rng(0)
    gy, gx = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    pos = np.stack([gy, gx], -1).reshape(1, 35, 2).astype(np.int32)
    jcos, jsin = jrope_2d_freqs(16, jnp.asarray(pos))
    cos, sin = rope_2d_freqs(16, torch.from_numpy(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=ATTN_TOL, rtol=0)
    for shape in ((2, 35, 3, 16), (2, 35, 16)):  # with and without a heads axis
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(japply_rope_2d(jnp.asarray(x), jcos, jsin))
        got = apply_rope_2d(torch.from_numpy(x), cos, sin).numpy()
        np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=0)
    with pytest.raises(ValueError, match="divisible by 4"):
        rope_2d_freqs(6, torch.from_numpy(pos))


@pytest.mark.parametrize("sq,sk,heads,d,pad", [
    (37, 37, 2, 64, 0),    # self-attention at the kernel's head dim
    (37, 23, 3, 16, 0),    # cross-attention, Sq != Sk
    (40, 40, 2, 64, 11),   # segment ids mask the last keys
])
def test_flash_sdpa_matches_jax(sq, sk, heads, d, pad):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, heads, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, heads, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, heads, d)).astype(np.float32)
    seg = None
    if pad:
        seg = np.zeros((2, sk), np.int32)
        seg[:, sk - pad:] = 1
    want = np.asarray(jflash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if seg is None else jnp.asarray(seg)))
    att.FLASH_PLAIN_CALLS.reset()
    got = att.flash_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         None if seg is None else torch.from_numpy(seg)).numpy()
    assert att.FLASH_PLAIN_CALLS.count == 1
    np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=0)


def test_flash_sdpa_masked_keys_do_not_leak_and_cpu_route():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 20, 2, 64)).astype(np.float32))
               for _ in range(3))
    seg = torch.zeros(1, 20, dtype=torch.int32)
    seg[:, 15:] = 1
    base = att.flash_sdpa(q, k, v, seg)
    k2, v2 = k.clone(), v.clone()
    k2[:, 15:] = float("nan")
    v2[:, 15:] = float("nan")
    torch.testing.assert_close(att.flash_sdpa(q, k2, v2, seg), base, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Sq == Sk"):
        att.flash_sdpa(q, k[:, :10], v[:, :10], seg)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_sdpa_kernel(q, k, v)


def _matcher_pair():
    jcfg = dataclasses.replace(
        JMatcherConfig.tiny_test(),
        encoder=dataclasses.replace(JViTConfig.tiny_test(), dtype=jnp.float32),
        dtype=jnp.float32)
    tcfg = dataclasses.replace(
        MatcherConfig.tiny_test(),
        encoder=dataclasses.replace(ViTConfig.tiny_test(), dtype=torch.float32),
        dtype=torch.float32)
    return jcfg, tcfg


def _carry(jm, tcfg, params, hw):
    model = TwoViewMatcher(tcfg, (hw[0] // 8, hw[1] // 8))
    model.load_state_dict(flax_to_state_dict(params, model))
    return model.eval()


@pytest.mark.parametrize("hw,r,p,ref_index", [
    ((32, 40), 2, 2, None),          # pairs row by row, no head resize
    ((36, 44), 1, 3, None),          # broadcast one reference; 32x40 -> 36x44 resize
    ((32, 40), 2, 3, [1, 0, 1]),     # many references by ref_index
])
def test_two_view_matcher_matches_jax(hw, r, p, ref_index):
    jcfg, tcfg = _matcher_pair()
    rng = np.random.default_rng(3)
    img0 = rng.uniform(size=(r, *hw, 3)).astype(np.float32)
    img1 = rng.uniform(size=(p, *hw, 3)).astype(np.float32)
    jm = JTwoViewMatcher(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img0[:1]), jnp.asarray(img1[:1]))["params"]
    # Move every parameter off its constant init so each mapping counts.
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)
    idx = None if ref_index is None else np.asarray(ref_index, np.int32)
    want = jm.apply({"params": params}, jnp.asarray(img0), jnp.asarray(img1),
                    ref_index=None if idx is None else jnp.asarray(idx))
    model = _carry(jm, tcfg, params, hw)
    with torch.no_grad():
        got = model(torch.from_numpy(img0), torch.from_numpy(img1),
                    ref_index=None if idx is None else torch.from_numpy(idx))
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=MODEL_TOL,
                                   rtol=0, err_msg=key)


def test_match_images_matches_jax():
    """Matcher + reciprocal NN on one pair; descriptors scored in f32."""
    jcfg, tcfg = _matcher_pair()
    rng = np.random.default_rng(4)
    hw = (64, 64)
    img0 = rng.uniform(size=(*hw, 3)).astype(np.float32)
    img1 = np.roll(img0, 3, axis=1)
    jm = JTwoViewMatcher(jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(img0[None]),
                     jnp.asarray(img1[None]))["params"]
    want = jmatch_images(jm, params, jnp.asarray(img0), jnp.asarray(img1))
    model = _carry(jm, tcfg, params, hw)
    with torch.no_grad():
        got = match_images(model, torch.from_numpy(img0), torch.from_numpy(img1))
    np.testing.assert_array_equal(got.xy0.numpy(), np.asarray(want.xy0))
    np.testing.assert_array_equal(got.xy1.numpy(), np.asarray(want.xy1))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), atol=MODEL_TOL)


def test_matcher_backend_matches_jax():
    """`TorchMatcherBackend` against `JaxMatcherBackend` with the same
    weights: `match`, `match_batch` and `match_pairs` (refs bucketed to a
    power of two, pairs to the same ratio) give the same matches."""
    from labelany3d_tpu.pipeline.backends import JaxMatcherBackend
    from labelany3d_tpu.registration.renderer import RenderedView
    from labelany3d_tpu_torch.pipeline.backends import TorchMatcherBackend

    jcfg, tcfg = _matcher_pair()
    rng = np.random.default_rng(5)
    h = w = 32
    jb = JaxMatcherBackend(cfg=jcfg, image_size=h)
    tb = TorchMatcherBackend(cfg=tcfg, device="cpu")
    views = [RenderedView(rng.uniform(size=(h, w, 4)).astype(np.float32),
                          np.full((h, w), 2.0, np.float32), np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32)) for _ in range(3)]
    refs = [rng.uniform(size=(h, w, 4)).astype(np.float32) for _ in range(3)]
    jb._ensure(h, w)
    tb._ensure(h, w)
    tb.model.load_state_dict(flax_to_state_dict(jb.params, tb.model))
    calls = [("match", (refs[0], views[0])), ("match_batch", (refs[1], views)),
             ("match_pairs", (refs, views, [2, 0, 1])),
             ("match_pairs", (refs[:2], views, [1, 1, 0]))]
    for name, args in calls:
        want, got = getattr(jb, name)(*args), getattr(tb, name)(*args)
        if name == "match":
            want, got = [want], [got]
        assert len(got) == len(want)
        for g, wnt in zip(got, want):
            for a, b in zip(g, wnt):
                np.testing.assert_array_equal(a, np.asarray(b))
    assert tb.forwards == len(calls)
    # A reference crop of another size is resized to the views' size as the
    # JAX backend resizes it (8-bit, Pillow's bicubic; within one level).
    crop = refs[0][:16]
    prep = tb._prep_ref(crop, h, w)
    np.testing.assert_allclose(prep, jb._prep_ref(crop, h, w), atol=1 / 255 + 1e-6)
    got = tb.match(crop, views[0])
    for a, b in zip(got, tb.match(np.concatenate([prep, crop[:1, :1, 3:].repeat(h, 0)
                                                  .repeat(w, 1)], -1), views[0])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, jb.match(crop, views[0])):
        np.testing.assert_array_equal(a, np.asarray(b))
