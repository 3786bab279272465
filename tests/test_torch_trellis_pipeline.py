"""TRELLIS as a whole in the port against the JAX package on the CPU, and
its wiring as stage 6's `obj_rec=trellis` backend.

  * The converters: `tests/trellis_replica.py`'s released-layout state dicts
    (tiny) through both packages' `convert_trellis_*` give equal trees, and
    the port's tree loads into the port's module, whose output matches the
    torch replica within 1e-4.
  * `TrellisPipeline.run` end to end at `tiny_test()` in float32 with the
    same weights (seeded trees of the JAX shapes) and the same draws (the
    JAX run's `jax.random` noise): voxels equal, SLat and the decoded
    Gaussians within 1e-4, the mesh decoder's features within 1e-4, and the
    baked mesh the same size. The crop's object is already `cond_size`
    square, so both packages' resizes are the identity and the conditioner
    sees the same pixels; the resize itself is held to Pillow's within one
    level (`test_torch_trellis_ops.py`), and `preprocess` to the JAX one
    on a crop that is resized, within 1/255.
  * `make_reconstruction("trellis")` and the runner's `all` route with
    `run.obj_rec=trellis` at the tiny config on the CPU.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import trellis_replica as rep
from labelany3d_tpu.models import convert_trellis as jct
from labelany3d_tpu.models.trellis import pipeline as jpipe
from labelany3d_tpu_torch.models import convert_trellis as tct
from labelany3d_tpu_torch.models.trellis import pipeline as tpipe
from labelany3d_tpu_torch.models.trellis import sparse_structure as tss
from labelany3d_tpu_torch.pipeline.backends import default_registry, make_reconstruction
from tests.test_torch_trellis_models import TOL, close, jcfg, port, tcfg
from tests.torch_parity import random_flax_params


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_same_tree(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg="/".join(k))


def test_converters_match_jax():
    torch.manual_seed(0)
    W, CTX, H = 36, 24, 2
    ss_ref = rep.SparseStructureFlowModelRef(8, 4, W, CTX, 4, 2, H, qk_rms_norm=True)
    ss_json = {"args": {"resolution": 8, "in_channels": 4, "out_channels": 4,
                        "model_channels": W, "cond_channels": CTX, "num_blocks": 2,
                        "num_heads": H, "qk_rms_norm": True}}
    dec_ref = rep.SparseStructureDecoderRef(1, 4, 2, [12, 8, 6], 1)
    dec_json = {"args": {"latent_channels": 4, "out_channels": 1, "channels": [12, 8, 6],
                         "num_res_blocks": 2, "num_res_blocks_middle": 1}}
    slat_ref = rep.SLatFlowModelRef(8, 4, W, CTX, 4, 2, H, [12], qk_rms_norm=True)
    slat_json = {"args": {"resolution": 8, "in_channels": 4, "out_channels": 4,
                          "model_channels": W, "cond_channels": CTX, "num_blocks": 2,
                          "num_heads": H, "io_block_channels": [12], "qk_rms_norm": True}}
    gs_ref = rep.SLatGaussianDecoderRef(4, 24, 4, 2, 2, 3 * 14)
    mesh_ref = rep.SLatMeshDecoderRef(4, 32, 4, 1, 2, tct.mesh_out_channels())
    dec_args = {"resolution": 4, "latent_channels": 4, "num_blocks": 2, "num_heads": 2}
    cases = [
        (ss_ref, "convert_trellis_ss_flow", "ss_flow_config_from_json", ss_json),
        (dec_ref, "convert_trellis_ss_decoder", "ss_decoder_config_from_json", dec_json),
        (slat_ref, "convert_trellis_slat_flow", "slat_flow_config_from_json", slat_json),
        (gs_ref, "convert_trellis_slat_gs", "slat_decoder_config_from_json",
         {"args": {**dec_args, "model_channels": 24}}),
        (mesh_ref, "convert_trellis_slat_mesh", "slat_decoder_config_from_json",
         {"args": {**dec_args, "model_channels": 32, "num_blocks": 1}}),
    ]
    for ref, conv, reader, js in cases:
        jc, tc = getattr(jct, reader)(js), getattr(tct, reader)(js)
        assert {f.name for f in dataclasses.fields(jc)} == {f.name for f in dataclasses.fields(tc)}
        state = rep.state_np(ref)
        assert_same_tree(getattr(tct, conv)(state, tc), getattr(jct, conv)(state, jc))
    rep_json = {"args": {"representation_config": {"num_gaussians": 3, "lr": {"_xyz": 0.5}}}}
    assert dataclasses.asdict(tct.gs_rep_config_from_json(rep_json)) == \
        dataclasses.asdict(jct.gs_rep_config_from_json(rep_json))

    # The port's SS flow from the converted tree against the torch replica.
    cfg = tcfg(tct.ss_flow_config_from_json(ss_json))
    model = port(tss.SparseStructureFlowModel(cfg),
                 tct.convert_trellis_ss_flow(rep.state_np(ss_ref), cfg))
    x, t, cond = torch.randn(1, 4, 8, 8, 8), torch.tensor([123.0]), torch.randn(1, 7, CTX)
    with torch.no_grad():
        want = ss_ref(x, t, cond).permute(0, 2, 3, 4, 1).reshape(1, 512, 4)
        got = model(x.permute(0, 2, 3, 4, 1).reshape(1, 512, 4), t, cond)
    close(got, want)

    # The DINOv2 conditioner (a tiny registered ViT in the timm layout).
    from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
    from labelany3d_tpu_torch.models.vit import ViTConfig

    vit = rep_vit_state(ViTConfig.tiny_test(num_register_tokens=4, pos_grid=(3, 3)))
    assert_same_tree(
        tct.convert_trellis_cond(vit, ViTConfig.tiny_test(num_register_tokens=4,
                                                          pos_grid=(3, 3))),
        jct.convert_trellis_cond(vit, JViTConfig.tiny_test(num_register_tokens=4,
                                                           pos_grid=(3, 3))))
    assert tct.cond_backbone_config().num_register_tokens == 4


def rep_vit_state(cfg) -> dict:
    """A DINOv2 (timm names) state dict for `cfg`, seeded."""
    rng = np.random.default_rng(0)
    c, p, hid = cfg.width, cfg.patch_size, int(cfg.width * cfg.mlp_ratio)
    shapes = {"patch_embed.proj.weight": (c, 3, p, p), "patch_embed.proj.bias": (c,),
              "pos_embed": (1, 1 + cfg.pos_grid[0] * cfg.pos_grid[1], c),
              "cls_token": (1, 1, c), "register_tokens": (1, cfg.num_register_tokens, c),
              "norm.weight": (c,), "norm.bias": (c,)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        shapes.update({b + "norm1.weight": (c,), b + "norm1.bias": (c,),
                       b + "norm2.weight": (c,), b + "norm2.bias": (c,),
                       b + "attn.qkv.weight": (3 * c, c), b + "attn.qkv.bias": (3 * c,),
                       b + "attn.proj.weight": (c, c), b + "attn.proj.bias": (c,),
                       b + "mlp.fc1.weight": (hid, c), b + "mlp.fc1.bias": (hid,),
                       b + "mlp.fc2.weight": (c, hid), b + "mlp.fc2.bias": (c,),
                       b + "ls1.gamma": (c,), b + "ls2.gamma": (c,)})
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def crop(seed: int, side: int, hw=(48, 40)) -> np.ndarray:
    """An RGBA crop whose object (alpha > 127) spans `side` x `side` pixels."""
    rng = np.random.default_rng(seed)
    img = np.zeros((*hw, 4), np.uint8)
    img[..., :3] = rng.integers(0, 256, (*hw, 3))
    img[5:5 + side, 3:3 + side, 3] = 255
    return img


@pytest.fixture(scope="module")
def runs():
    """Both tiny pipelines, f32, the same weights and draws, run on one crop."""
    jcf = jcfg(jpipe.TrellisPipelineConfig.tiny_test())
    jp = jpipe.TrellisPipeline(jcf)
    c = jcf
    img = jnp.zeros((1, c.cond_size, c.cond_size, 3))
    m = (c.cond_size // c.cond_backbone.patch_size) ** 2
    cond = jnp.zeros((1, m, c.cond_backbone.width))
    lat = jnp.zeros((1, c.structure.latent_res ** 3, c.structure.latent_channels))
    t = jnp.zeros((1,))
    n = c.max_voxels
    feats = jnp.zeros((1, n, c.slat.latent_channels))
    coords, valid = jnp.zeros((1, n, 3), jnp.int32), jnp.ones((1, n), bool)
    jp.params = {
        "cond": random_flax_params(jp.cond_model.init, img, seed=1),
        "ss": random_flax_params(jp.ss_model.init, lat, t, cond, seed=2),
        "ss_dec": random_flax_params(jp.ss_decoder.init, lat, seed=3),
        "slat": random_flax_params(jp.slat_model.init, feats, coords, valid, t, cond, seed=4),
        "gs": random_flax_params(jp.gs_decoder.init, feats[0], coords[0], valid[0], seed=5),
        "mesh": random_flax_params(jp.mesh_decoder.init, feats[0], coords[0], valid[0], seed=6),
    }
    rgba = crop(7, c.cond_size)
    want = jp.run(rgba, seed=3)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))

    def draws(name, shape):
        return np.asarray(jax.random.normal(k1 if name == "ss" else k2, shape))

    tp = tpipe.TrellisPipeline(tcfg(tpipe.TrellisPipelineConfig.tiny_test()),
                               params=dict(jp.params), device="cpu")
    got = tp.run(rgba, seed=3, draws=draws)
    return got, want, jp, tp


def test_trellis_run_matches_jax(runs):
    got, want, _, _ = runs
    np.testing.assert_array_equal(got["coords"].numpy(), np.asarray(want["coords"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    v = np.asarray(want["valid"])[0]
    assert 0 < v.sum()
    gs, jgs = got["gaussians"], want["gaussians"]
    gv = np.asarray(jgs.valid)
    np.testing.assert_array_equal(gs.valid.numpy(), gv)
    for name in ("means", "scales", "rotations", "opacities", "colors"):
        close(getattr(gs, name)[gv], np.asarray(getattr(jgs, name))[gv])
    mf, jmf = got["mesh_features"], want["mesh_features"]
    mv = np.asarray(jmf[2])
    np.testing.assert_array_equal(mf[1].numpy(), np.asarray(jmf[1]))
    close(mf[0][mv], np.asarray(jmf[0])[mv])
    mesh, jmesh = got["mesh"], want["mesh"]
    assert mesh.faces.shape == jmesh.faces.shape and len(mesh.faces) > 0
    assert mesh.texture.shape == jmesh.texture.shape == (256, 256, 3)
    assert np.abs(mesh.vertices - jmesh.vertices).max() <= TOL


def test_trellis_slat_matches_jax(runs):
    got, want, jp, tp = runs
    coords, valid = want["coords"], want["valid"]
    n_fine, torso = jp._slat_buckets(np.asarray(coords), np.asarray(valid),
                                     jp.cfg.max_voxels)
    assert (n_fine, torso) == tp.slat_buckets(got["coords"], got["valid"])
    # SLat itself: the decoders' input (valid rows; pad slots are zero).
    k2 = jax.random.split(jax.random.PRNGKey(3))[1]
    cond, uncond = jp.get_cond(jp.preprocess(crop(7, jp.cfg.cond_size)))
    jslat = jp.sample_slat(coords, valid, cond, uncond, k2)
    v = np.asarray(valid)[0]
    close(got["slat"][0][v], np.asarray(jslat)[0][v])
    assert not got["slat"][0][~v].any()


def test_preprocess_matches_jax():
    """A crop that is resized: Pillow's bilinear in the JAX package, the
    port's 8-bit triangle filter, within one level."""
    jp = jpipe.TrellisPipeline(jpipe.TrellisPipelineConfig.tiny_test())
    tp = tpipe.TrellisPipeline(tpipe.TrellisPipelineConfig.tiny_test(), device="cpu")
    for rgba in (crop(8, 41, (60, 50)), crop(9, 20), crop(10, 30).astype(np.float32) / 255):
        want = np.asarray(jp.preprocess(rgba))
        got = tp.preprocess(rgba).numpy()
        assert got.shape == want.shape == (32, 32, 3)
        np.testing.assert_allclose(got, want, atol=1 / 255 + 1e-6)


def test_make_reconstruction_trellis(monkeypatch):
    reg = default_registry()
    tr = reg.get("reconstruction", backend="trellis", tiny=True, device="cpu")
    assert isinstance(tr, tpipe.TrellisPipeline) and tr.cfg.max_voxels == 256
    assert reg.get("reconstruction", backend="trellis") is tr  # built once
    full = make_reconstruction("trellis", device="cpu")
    assert full.cfg.max_voxels == 8192 and full._params_dtype == torch.bfloat16
    assert full.models is None  # built on first use
    for name in ("hunyuan3d", "hunyuan3d_carve"):  # ported: tests/test_torch_hunyuan_route.py
        assert make_reconstruction(name, device="cpu").novel_views is not None
    with pytest.raises(ValueError, match="hunyuan4d"):
        make_reconstruction("hunyuan4d", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_reconstruction("trellis", tiny=True)


def test_run_times_each_component_once(monkeypatch):
    """`run(timer=...)` gives one span per component, and the run extracts
    the surface once (inside `to_glb_mesh`)."""
    from labelany3d_tpu_torch.utils.profiling import StageTimer

    surfaces = []

    def counted(*args):
        surfaces.append(1)
        return flexicubes_to_mesh(*args)

    flexicubes_to_mesh = tpipe.flexicubes_to_mesh
    monkeypatch.setattr(tpipe, "flexicubes_to_mesh", counted)
    tp = tpipe.TrellisPipeline(tpipe.TrellisPipelineConfig.tiny_test(), device="cpu")
    timer = StageTimer()
    tp.run(crop(7, tp.cfg.cond_size), timer=timer)
    assert {k: s.calls for k, s in timer.stats.items()} == dict.fromkeys(
        ("get_cond", "sample_sparse_structure", "sample_slat", "decode", "to_glb_mesh",
         "flexicubes_to_mesh", "bake"), 1)
    assert len(surfaces) == 1
    inner = timer.stats["flexicubes_to_mesh"].total_seconds + timer.stats["bake"].total_seconds
    assert inner <= timer.stats["to_glb_mesh"].total_seconds


def test_runner_all_route_with_trellis(tmp_path):
    """`run.obj_rec=trellis` through the CLI's `all` route at the tiny
    presets: every crop gets a TRELLIS GLB (empty: the default random
    initialisation zeroes the flows' output layers, as in the JAX package),
    the layout stage skips empty meshes as the JAX one does, so the scene
    gets no boxes and COCO3D lists no image."""
    from labelany3d_tpu_torch.data.meshio import load_glb
    from labelany3d_tpu_torch.pipeline import runner
    from labelany3d_tpu_torch.pipeline.scene import SceneDir
    from labelany3d_tpu_torch.utils.png import write_png
    from tests.test_torch_pipeline_layout import RENDER, SCENE
    from tests.test_torch_pipeline_layout import _world as _layout_world

    scene, img, depth, gts, images, annos = _layout_world()
    root = tmp_path / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    write_png(root / "images" / "val2017" / f"{SCENE}.jpg", img)
    (root / "annotations" / "coconut_val.json").write_text(json.dumps(
        {"images": images, "annotations": annos[1], "categories": []}))
    out = tmp_path / "results"
    assert runner.main(["all", "--dataset_root", str(root), "--save_dir", str(out),
                        "--end_index", "1", "models.tiny=true", "compute.batch_size=1",
                        f"compute.render_size={RENDER}", "run.obj_rec=trellis",
                        f"compute.image_height={scene.height}",
                        f"compute.image_width={scene.width}"], device="cpu") == 0
    sd = SceneDir(out / "val" / SCENE)
    ids = sd.list_crop_ids()
    assert len(ids) == 2
    for obj_id in ids:
        assert load_glb(sd.object_mesh(obj_id)).is_empty
    assert not sd.bbox3d.exists()
    coco = json.loads((out / "COCO3D_val.json").read_text())
    assert coco["images"] == [] and coco["annotations"] == []
