"""The port's CLIP stack (`data/bpe.py`, `models/clip.py`) against the JAX
package's, on the CPU in float32 at `tiny_test()` sizes.

  * Tokenizers: the BPE tokenizer over a small vocabulary and merge list,
    the hash fallback and `load_tokenizer` give the same ids as the JAX
    package's (exact).
  * Text and vision encoders on the same token ids or images and the same
    parameters (a seeded tree of the JAX shapes, carried across by
    `flax_to_state_dict`): 1e-4 relative and absolute (float32 through two
    blocks whose sums run in another order).
  * Converters: a seeded state dict with the released `transformers` names
    (`chip_smoke.released_clip_{text,vision}_state`, N(0, 0.1^2)) gives the
    JAX converter's tree exactly, and the models loaded from it agree as
    above.
  * `preprocess_clip_image` against the JAX package's (Pillow's BICUBIC):
    within one 8-bit level after the resize (Pillow sums in fixed point),
    at least 99% of values equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.data import bpe as jbpe
from labelany3d_tpu.models import clip as jclip
from labelany3d_tpu_torch.data import bpe
from labelany3d_tpu_torch.models import clip
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_convert import _assert_same_tree
from tests.torch_parity import random_flax_params

TOL = 1e-4
LEVEL = 1.0 / 255.0
EQUAL_SHARE = 0.99


def _port(model, params):
    model.load_state_dict(flax_to_state_dict(params, model))
    return model.eval().requires_grad_(False)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _cfgs(name, **kw):
    j = getattr(jclip, name).tiny_test(dtype=jnp.float32, **kw)
    t = getattr(clip, name).tiny_test(dtype=torch.float32, **kw)
    return j, t


VOCAB_WORDS = ["a", "c", "h", "i", "r", "t", "o", "e", "l", "b", "</w>"]
MERGES = [("c", "h"), ("ch", "a"), ("i", "r</w>"), ("t", "a"), ("b", "l"), ("bl", "e</w>"),
          ("ta", "ble</w>"), ("cha", "ir</w>")]


def _vocab():
    toks = ([w for w in VOCAB_WORDS if w != "</w>"] + [w + "</w>" for w in VOCAB_WORDS[:-1]]
            + ["".join(m) for m in MERGES] + ["<|startoftext|>", "<|endoftext|>"])
    return {t: i for i, t in enumerate(dict.fromkeys(toks))}


@pytest.mark.parametrize("text", ["chair", "a table", "Chair  TABLE!", "tea_table 42",
                                  "<|startoftext|>chair<|endoftext|>", ""])
def test_tokenizers_match_jax(text, tmp_path):
    vocab = _vocab()
    for length in (16, 4):
        got = bpe.CLIPTokenizer(vocab, MERGES)(text, length)
        assert got == jbpe.CLIPTokenizer(vocab, MERGES)(text, length)
        assert len(got) == length and got[-1] == vocab["<|endoftext|>"]
        assert bpe.HashTokenizer(64)(text, length) == jbpe.HashTokenizer(64)(text, length)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    loaded = bpe.load_tokenizer(str(tmp_path))
    assert not loaded.is_fallback and loaded(text) == jbpe.load_tokenizer(str(tmp_path))(text)
    assert bpe.load_tokenizer(str(tmp_path / "missing"), 64).is_fallback


@pytest.mark.parametrize("projection", [None, 8])
def test_text_encoder_matches_jax(projection):
    jcfg, tcfg = _cfgs("CLIPTextConfig", projection_dim=projection)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size - 1, (3, jcfg.max_len)).astype(np.int32)
    ids[0, 5] = ids[0, 9] = jcfg.eos_token_id  # pooled at the first EOS
    ids[1, -1] = jcfg.eos_token_id             # row 2 has none: its highest id
    jm = jclip.CLIPTextEncoder(jcfg)
    params = random_flax_params(jm.init, jnp.asarray(ids[:1]), seed=1)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(ids))
    got = _port(clip.CLIPTextEncoder(tcfg), params)(torch.from_numpy(ids).long())
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


def test_vision_encoder_matches_jax():
    jcfg, tcfg = _cfgs("CLIPVisionConfig")
    img = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jclip.CLIPVisionEncoder(jcfg)
    params = random_flax_params(jm.init, jnp.asarray(img[:1]), seed=3)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(img))
    got = _port(clip.CLIPVisionEncoder(tcfg), params)(torch.from_numpy(img))
    assert got.keys() == want.keys() == {"tokens", "pooled", "image_embeds"}
    for k in want:
        _close(got[k], want[k])


def test_convert_clip_matches_jax():
    jcfg, tcfg = _cfgs("CLIPTextConfig", projection_dim=8)
    state = chip_smoke.released_clip_text_state(tcfg, std=0.1)
    tree = clip.convert_clip_text(state, tcfg)
    _assert_same_tree(tree, jclip.convert_clip_text(state, jcfg))
    ids = np.random.default_rng(4).integers(0, 63, (2, jcfg.max_len)).astype(np.int32)
    want = jclip.CLIPTextEncoder(jcfg).apply({"params": tree}, jnp.asarray(ids))
    got = _port(clip.CLIPTextEncoder(tcfg), tree)(torch.from_numpy(ids).long())
    _close(got["text_embeds"], want["text_embeds"])
    with pytest.raises(KeyError, match="text_projection"):
        clip.convert_clip_text({k: v for k, v in state.items()
                                if k != "text_projection.weight"}, tcfg)

    jcfg, tcfg = _cfgs("CLIPVisionConfig")
    state = chip_smoke.released_clip_vision_state(tcfg, std=0.1)
    tree = clip.convert_clip_vision(state, tcfg)
    _assert_same_tree(tree, jclip.convert_clip_vision(state, jcfg))
    img = np.random.default_rng(5).standard_normal((1, 32, 32, 3)).astype(np.float32)
    want = jclip.CLIPVisionEncoder(jcfg).apply({"params": tree}, jnp.asarray(img))
    got = _port(clip.CLIPVisionEncoder(tcfg), tree)(torch.from_numpy(img))
    _close(got["image_embeds"], want["image_embeds"])
    # Without the `vision_model.` prefix, as a bare CLIPVisionModel saves it.
    bare = {k.removeprefix("vision_model."): v for k, v in state.items()}
    _assert_same_tree(clip.convert_clip_vision(bare, tcfg), tree)


@pytest.mark.parametrize("hw", [(40, 40), (300, 170)])
def test_preprocess_clip_image_matches_jax(hw):
    rgb = np.random.default_rng(6).uniform(size=hw + (3,)).astype(np.float32)
    want = jclip.preprocess_clip_image(rgb, 32)
    got = clip.preprocess_clip_image(torch.from_numpy(rgb), 32).numpy()
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.float32
    # Back to 8-bit levels: at most one apart, nearly all equal.
    std = np.asarray(clip.CLIP_IMAGE_STD, np.float32)
    diff = np.abs(got - want) * std
    assert diff.max() <= LEVEL + 1e-6
    assert (diff < 1e-6).mean() >= EQUAL_SHARE


def test_clip_configs_match_jax():
    for name, presets in (("CLIPTextConfig", ("sd15", "sd2", "tiny_test")),
                          ("CLIPVisionConfig", ("vitl14", "tiny_test"))):
        for p in presets:
            j = dataclasses.asdict(getattr(getattr(jclip, name), p)())
            t = dataclasses.asdict(getattr(getattr(clip, name), p)())
            for d in (j, t):
                d.pop("dtype")
                d.pop("param_dtype", None)
            assert t == j, (name, p)
