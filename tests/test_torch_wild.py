"""Wild mode's host parts, backends and background model in the port
(`data/{wild,sources,scenes}.py`, `models/background.py`) against the JAX
package's, on the CPU:

  * `filter_component_masks`, `ColorSegmentation` (OpenCV on both sides),
    `BorderPriorForeground`, `WildInstanceSource` (the default stack) and
    `DirectoryLoader`: equal on seeded and procedural images;
  * `make_wild_source`: the same backends for every selector, the same
    errors, and with `sam_path` / `segformer_path` (seeded `transformers`
    state dicts saved with `torch.save`, an `id2label` in `config.json`)
    the same converted trees and thing classes;
  * `ClipSegForeground` and `ClipTagger` with one tiny `transformers` model
    each on both sides (needs `transformers`): equal masks and tags;
  * `BackgroundModel.fit` at width 16, depth 2, 10 steps, from the JAX
    init and the JAX key schedule's off-surface draws: every loss and the
    final parameters within FIT_TOL, the final loss as JAX returns it; then
    `extract_mesh(16)`: the same triangles, corners within MESH_TOL;
  * `data/scenes.py`: the same scenes from the same files.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from labelany3d_tpu.data import scenes as jscenes
from labelany3d_tpu.data import sources as jsources
from labelany3d_tpu.data import wild as jwild
from labelany3d_tpu.models import background as jbg
from labelany3d_tpu_torch.data import scenes as tscenes
from labelany3d_tpu_torch.data import sources as tsources
from labelany3d_tpu_torch.data import wild as twild
from labelany3d_tpu_torch.models import background as tbg
from labelany3d_tpu_torch.models.sam import SamConfig
from labelany3d_tpu_torch.models.segformer import SegFormerConfig
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_convert import _assert_same_tree
from tests.test_wild import _photo_like_fixture, _toy_wild_image

FIT_TOL = 1e-5    # Adam over 10 float32 steps, sums in another order
MESH_TOL = 1e-4   # marching-cubes vertices of fields within FIT_TOL

torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(0)
    return {"toy": _toy_wild_image(), "photo": _photo_like_fixture()[0],
            "noise": rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)}


def test_filter_component_masks_matches_jax():
    rng = np.random.default_rng(1)
    masks = rng.uniform(size=(12, 30, 40)) > 0.6
    masks[3] = False  # an empty mask: the epsilons decide
    fg = rng.uniform(size=(30, 40)) > 0.5
    for threshold in (0.3, 0.5, -1.0):
        got = twild.filter_component_masks(masks, fg, threshold)
        want = jwild.filter_component_masks(masks, fg, threshold)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["toy", "photo", "noise"])
def test_host_backends_and_source_match_jax(name):
    img = _images()[name]
    np.testing.assert_array_equal(twild.ColorSegmentation(min_area=50).segment(img),
                                  jwild.ColorSegmentation(min_area=50).segment(img))
    np.testing.assert_array_equal(twild.BorderPriorForeground().foreground(img),
                                  jwild.BorderPriorForeground().foreground(img))
    got = twild.default_wild_source().read_instances(img)
    want = jwild.default_wild_source().read_instances(img)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.bboxes, want.bboxes)
    assert got.labels == want.labels and got.category_ids == want.category_ids
    assert twild.ConstantTagger().tag(img, got.masks) == jwild.ConstantTagger().tag(img, got.masks)


def test_empty_source_and_provider_match_jax():
    img = np.full((64, 64, 3), 128, np.uint8)
    src = twild.WildInstanceSource(twild.ColorSegmentation(min_area=1 << 20),
                                   twild.BorderPriorForeground(), twild.ConstantTagger())
    inst = tsources.WildInstanceProvider(src).instances({"id": 1}, img)
    assert len(inst) == 0 and inst.masks.shape == (0, 64, 64)
    with pytest.raises(ValueError, match="decoded image"):
        tsources.WildInstanceProvider().instances({"id": 1}, None)


def test_directory_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name, hw in (("b.png", (30, 40)), ("a.jpg", (24, 36)), ("c.JPEG", (20, 20))):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(tmp_path / name)
    (tmp_path / "notes.txt").write_text("not an image")
    got, want = tsources.DirectoryLoader(str(tmp_path)), jsources.DirectoryLoader(str(tmp_path))
    assert got.get_images() == want.get_images() and len(got) == len(want) == 3
    assert got.get_image_by_index(1) == want.get_image_by_index(1)
    assert got.get_annotations(1) == want.get_annotations(1) == []


def _kinds(src):
    return [type(b).__name__ for b in (src.segmentation, src.foreground, src.tagger)]


@pytest.mark.parametrize("seg,fg", [("color", "border"), ("sam", "semantic"),
                                    ("entityv2", "oneformer")])
def test_make_wild_source_selectors_match_jax(seg, fg):
    got = twild.make_wild_source(foreground=fg, segmentation=seg, device="cpu")
    want = jwild.make_wild_source(foreground=fg, segmentation=seg)
    assert _kinds(got) == _kinds(want)


@pytest.mark.parametrize("kw,match", [
    (dict(segmentation="nope"), "wild_segmentation"),
    (dict(foreground="nope"), "wild_foreground"),
    (dict(tagger="nope"), "wild_tagger"),
    (dict(foreground="clipseg"), "clipseg_path"),
    (dict(tagger="clip"), "clip_path"),
])
def test_make_wild_source_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        twild.make_wild_source(device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jwild.make_wild_source(**kw)
    assert str(got.value) == str(want.value)


def test_make_wild_source_with_weight_files_matches_jax(tmp_path):
    """ViT-B's and B0's layer structure at tiny widths: the converters read
    names, not sizes, so the files stay small."""
    sam_cfg = SamConfig.vit_base(width=32, num_heads=2, image_size=64, patch_size=8,
                                 window_size=4, out_channels=16, prompt_dim=16,
                                 num_pos_feats=8, decoder_heads=2, decoder_mlp_dim=32,
                                 iou_head_hidden_dim=16)
    seg_cfg = SegFormerConfig.b0(hidden_sizes=(8, 8, 8, 8), num_heads=(1, 1, 1, 1),
                                 decoder_hidden=8, num_labels=6)
    for name, state in (("sam.pth", chip_smoke.released_sam_state(sam_cfg)),
                        ("segformer.pth", chip_smoke.released_segformer_state(seg_cfg))):
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / name)
    id2label = {"0": "wall", "1": "chair", "2": "floor", "3": "person", "4": "sky", "5": "car"}
    (tmp_path / "config.json").write_text(json.dumps({"id2label": id2label}))
    kw = dict(segmentation="sam", foreground="semantic", sam_path=str(tmp_path / "sam.pth"),
              segformer_path=str(tmp_path / "segformer.pth"))
    got = twild.make_wild_source(device="cpu", **kw)
    want = jwild.make_wild_source(**kw)
    _assert_same_tree(got.segmentation.auto.params, want.segmentation.auto.params)
    _assert_same_tree(got.foreground.params, want.foreground.params)
    np.testing.assert_array_equal(got.foreground.thing_ids, want.foreground.thing_ids)
    assert got.foreground.thing_ids.tolist() == [1, 3, 5]


def test_open_vocabulary_backends_match_jax(tmp_path):
    pytest.importorskip("transformers")
    from tests.test_wild_openvocab import _tiny_clipseg, _tiny_tokenizer
    from transformers import (
        CLIPConfig,
        CLIPImageProcessor,
        CLIPModel,
        CLIPProcessor,
        CLIPTextConfig,
        CLIPVisionConfig,
    )

    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    model, proc = _tiny_clipseg(tmp_path)
    got = twild.ClipSegForeground(model=model, processor=proc, device="cpu").foreground(img)
    want = jwild.ClipSegForeground(model=model, processor=proc).foreground(img)
    assert got.shape == (48, 64) and got.dtype == bool
    np.testing.assert_array_equal(got, want)

    cfg = CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(vocab_size=80, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                       num_attention_heads=2, projection_dim=16),
        CLIPVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2, image_size=32, patch_size=16, projection_dim=16),
        projection_dim=16)
    torch.manual_seed(0)
    clip = CLIPModel(cfg)
    cproc = CLIPProcessor(image_processor=CLIPImageProcessor(
        size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32}),
        tokenizer=_tiny_tokenizer(tmp_path))
    masks = np.zeros((3, 48, 64), bool)
    masks[0, 5:20, 5:30] = True
    masks[1, 25:45, 30:60] = True  # masks[2] empty: the whole image
    vocab = ["chair", "table", "lamp", "sofa"]
    got = twild.ClipTagger(model=clip, processor=cproc, vocabulary=vocab, device="cpu")
    want = jwild.ClipTagger(model=clip, processor=cproc, vocabulary=vocab)
    assert got.tag(img, masks) == want.tag(img, masks)
    assert got.tag(img, masks[:0]) == [] == want.tag(img, masks[:0])
    assert twild.ClipTagger(model=clip, processor=cproc, device="cpu").vocabulary == \
        jwild.ClipTagger(model=clip, processor=cproc).vocabulary


@pytest.fixture(scope="module")
def background_fit():
    """The JAX fit and its draws: `split(PRNGKey(seed), steps)`, then each
    step's `split(k)[0]` for the uniform off-surface points."""
    cfg = jbg.BackgroundConfig(width=16, depth=2, fit_steps=10)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(300, 3))
    points = (d / np.linalg.norm(d, axis=1, keepdims=True) * 0.8 + [1.0, 2.0, 3.0])
    points = points.astype(np.float32)
    jm = jbg.BackgroundModel(cfg, seed=0)
    init = jbg.SDFMLP(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
    loss = jm.fit(points)
    off = np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[0], points.shape))
                    for k in jax.random.split(jax.random.PRNGKey(0), cfg.fit_steps)])

    def jax_losses(p):
        """Every step's loss, by the JAX fit's own loss and update."""
        import optax

        model, tx, data = jbg.SDFMLP(cfg), optax.adam(cfg.learning_rate), jnp.asarray(
            (points - jm.bounds[0]) / (jm.bounds[1] - jm.bounds[0]))

        def loss_fn(p, o):
            d = jnp.min(jnp.linalg.norm(o[:, None] - data[None, :256], axis=-1), axis=-1)
            return (jnp.mean(model.apply({"params": p}, data) ** 2) + jnp.mean(
                (model.apply({"params": p}, o) - jnp.minimum(d, cfg.truncation * 4)) ** 2))

        out, opt = [], tx.init(p)
        for o in off:
            val, g = jax.value_and_grad(loss_fn)(p, o)
            up, opt = tx.update(g, opt, p)
            p = optax.apply_updates(p, up)
            out.append(float(val))
        return np.array(out)

    return cfg, points, jm, init, loss, off, jax_losses(init)


def test_background_fit_matches_jax(background_fit):
    cfg, points, jm, init, loss, off, losses = background_fit
    np.testing.assert_allclose(losses[-1], loss, rtol=FIT_TOL)  # the replay is the JAX fit
    tm = tbg.BackgroundModel(tbg.BackgroundConfig(width=16, depth=2, fit_steps=10),
                             device="cpu")
    got = tm.fit(points, off_points=torch.from_numpy(off), params=init)
    np.testing.assert_allclose(tm.losses, losses, rtol=FIT_TOL, atol=FIT_TOL)
    np.testing.assert_allclose(got, loss, rtol=FIT_TOL)
    np.testing.assert_array_equal(tm.bounds[0], jm.bounds[0])
    want = flax_to_state_dict(jm.params, tm.model)
    for k, v in tm.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=FIT_TOL, atol=FIT_TOL)

    gv, gf = tm.extract_mesh(16)
    wv, wf = jm.extract_mesh(16)
    # The merge rounds vertices to 1e-5 grid units, so fields within FIT_TOL
    # may merge a vertex pair on one side only: indices shift, triangles
    # do not. Face by face, the corners agree.
    assert len(gf) == len(wf) > 0 and abs(len(gv) - len(wv)) <= 2
    np.testing.assert_allclose(gv[gf], wv[wf], rtol=MESH_TOL, atol=MESH_TOL)


def test_background_fit_draws_its_own(background_fit):
    """Without draws or an init: Flax's initialisers and uniform draws from
    a seeded generator; the same seed gives the same fit."""
    _, points, *_ = background_fit
    cfg = tbg.BackgroundConfig(width=16, depth=2, fit_steps=10)
    a, b = (tbg.BackgroundModel(cfg, seed=1, device="cpu") for _ in range(2))
    assert a.fit(points) == b.fit(points)
    assert np.isfinite(a.losses).all() and len(a.losses) == 10
    with pytest.raises(RuntimeError, match="fit"):
        tbg.BackgroundModel(cfg, device="cpu").extract_mesh(8)
    x = torch.rand(5, 3)
    np.testing.assert_allclose(tbg.positional_encoding(x, 3).numpy(),
                               np.asarray(jbg.positional_encoding(jnp.asarray(x.numpy()), 3)),
                               rtol=1e-6, atol=1e-6)


def test_scenes_match_jax(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "x.png")
    attrs = {"img_path": str(tmp_path / "x.png")}
    got, want = tscenes.get_scene("InTheWild", attrs), jscenes.get_scene("InTheWild", attrs)
    np.testing.assert_array_equal(got.image_np, want.image_np)
    np.testing.assert_array_equal(got.c2w, want.c2w)
    assert got.depth_map is None and got.K is None
    arr = tscenes.get_scene("Array", {"image": img})
    np.testing.assert_array_equal(np.asarray(arr.image_pil), img)
    tscenes.register_scene_type("Blank", tscenes.BaseScene)
    assert isinstance(tscenes.get_scene("Blank", {}), tscenes.BaseScene)
    with pytest.raises(KeyError, match="Unknown scene type") as got_err:
        tscenes.get_scene("Nope", {})
    with pytest.raises(KeyError) as want_err:
        jscenes.get_scene("Nope", {})
    assert "Available" in str(got_err.value) and "Available" in str(want_err.value)
