"""`models.ckpt_dir` from the CLI to stage 6, and the runner's unloading.

  * `make_reconstruction("trellis" | "hunyuan3d", tiny=True, ckpt_dir=...,
    device="cpu")` builds, bit for bit, the models that the same converted
    trees passed in memory build (every parameter and buffer equal; TRELLIS's
    conditioning tokens on one crop equal), and a TRELLIS store that lacks
    components warns with their names.
  * `runner.main([... "models.ckpt_dir=..."])` hands the key to the
    reconstruction factory (it was dropped before), and only to it.
  * The port's registry unloads as the JAX one does
    (`tests/test_models.py::test_registry_lazy_load_and_unload`).
  * After `run_stages("all")` at tiny on the CPU, every model the runner
    built is freed (a weak reference to it is dead) and a backend the caller
    passed is alive.
"""

import dataclasses
import json
import weakref

import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu_torch.models import checkpoints
from labelany3d_tpu_torch.models import convert_trellis as ct
from labelany3d_tpu_torch.models.trellis import TrellisPipeline, TrellisPipelineConfig
from labelany3d_tpu_torch.pipeline import backends
from labelany3d_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)


def _trellis_trees():
    """The tiny TRELLIS's six components as converted trees, from seeded
    released-layout state dicts."""
    cfg = TrellisPipelineConfig.tiny_test()
    grid = cfg.cond_size // cfg.cond_backbone.patch_size
    vit = dataclasses.replace(cfg.cond_backbone, pos_grid=(grid, grid))
    draw = dataclasses.replace(cfg, cond_backbone=vit)
    conv = {"cond": lambda s: ct.convert_trellis_cond(s, vit),
            "ss": lambda s: ct.convert_trellis_ss_flow(s, cfg.structure),
            "ss_dec": lambda s: ct.convert_trellis_ss_decoder(s, cfg.ss_dec),
            "slat": lambda s: ct.convert_trellis_slat_flow(s, cfg.slat),
            "gs": lambda s: ct.convert_trellis_slat_gs(s, cfg.dec_gs),
            "mesh": lambda s: ct.convert_trellis_slat_mesh(s, cfg.dec_mesh)}
    return {name: conv[name](state) for name, state in chip_smoke.released_trellis_states(draw)}


def _assert_same_module(got: torch.nn.Module, want: torch.nn.Module):
    g, w = got.state_dict(), want.state_dict()
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_trellis_from_the_store_equals_the_trees_in_memory(tmp_path):
    trees = _trellis_trees()
    for comp, tree in trees.items():
        checkpoints.save_params(str(tmp_path), TrellisPipeline.CKPT_NAMES[comp], tree)
    stored = backends.make_reconstruction("trellis", tiny=True, ckpt_dir=str(tmp_path),
                                          device="cpu")
    memory = TrellisPipeline(TrellisPipelineConfig.tiny_test(), params=trees, device="cpu")
    stored.init_params()
    memory.init_params()
    for comp in trees:
        _assert_same_module(stored.models[comp], memory.models[comp])
    rgba = chip_smoke.trellis_crop(3, 48)
    a = stored.get_cond(stored.preprocess(rgba))[0]
    b = memory.get_cond(memory.preprocess(rgba))[0]
    assert torch.equal(a, b) and a.abs().sum() > 0


def test_partial_trellis_store_warns_with_the_missing_names(tmp_path, monkeypatch, capsys):
    trees = _trellis_trees()
    for comp in ("cond", "ss", "slat"):
        checkpoints.save_params(str(tmp_path), TrellisPipeline.CKPT_NAMES[comp], trees[comp])
    monkeypatch.setattr(tlog, "_seen", set())
    tp = backends.make_reconstruction("trellis", tiny=True, ckpt_dir=str(tmp_path),
                                      device="cpu")
    tp.init_params()
    err = capsys.readouterr().err
    assert "trellis_ss_dec" in err and "trellis_slat_gs" in err and "trellis_slat_mesh" in err
    assert "trellis_cond" not in err and "random-initialized" not in err
    # The stored components load; the missing ones draw their usual seeds.
    memory = TrellisPipeline(TrellisPipelineConfig.tiny_test(),
                             params={k: trees[k] for k in ("cond", "ss", "slat")}, device="cpu")
    memory.init_params()
    for comp in TrellisPipeline.CKPT_NAMES:
        _assert_same_module(tp.models[comp], memory.models[comp])
    # An empty store: the random-weight warning.
    monkeypatch.setattr(tlog, "_seen", set())
    backends.make_reconstruction("trellis", tiny=True, ckpt_dir=str(tmp_path / "none"),
                                 device="cpu").init_params()
    assert "random-initialized" in capsys.readouterr().err


def test_hunyuan3d_from_the_store_equals_the_trees_in_memory(tmp_path):
    from labelany3d_tpu_torch.models.diffusion import MVDStdViews
    from labelany3d_tpu_torch.models.diffusion.convert import convert_mvd
    from labelany3d_tpu_torch.models.diffusion.mvd import MVDUNetConfig
    from labelany3d_tpu_torch.models.svrm import SVRMConfig, SVRMReconstruction, convert_svrm

    svrm = convert_svrm(chip_smoke.released_svrm_state(SVRMConfig.tiny_test()),
                        SVRMConfig.tiny_test())
    ucfg = MVDUNetConfig.tiny_test()
    mvd = convert_mvd(unet_state=chip_smoke.released_mvd_unet_state(ucfg), unet_cfg=ucfg,
                      ramping_coefficients=np.linspace(0, 1, 7))
    checkpoints.save_params(str(tmp_path), "svrm", svrm)
    checkpoints.save_params(str(tmp_path), "mvd", mvd)
    stored = backends.make_reconstruction("hunyuan3d", tiny=True, ckpt_dir=str(tmp_path),
                                          device="cpu")
    nv = MVDStdViews(tiny=True, device="cpu").set_params(mvd)
    memory = SVRMReconstruction(novel_views=nv, cfg=SVRMConfig.tiny_test(), params=svrm,
                                device="cpu")
    _assert_same_module(stored._ensure(), memory._ensure())
    _assert_same_module(stored.novel_views.unet, nv.unet)
    np.testing.assert_array_equal(stored.novel_views.ramping, nv.ramping)
    # With views='zero123' the view source reads the store's 'zero123' (absent
    # here: random), and the carver reads nothing.
    z = backends.make_reconstruction("hunyuan3d", tiny=True, ckpt_dir=str(tmp_path),
                                     views="zero123", device="cpu")
    _assert_same_module(z._ensure(), memory._ensure())
    assert backends.make_reconstruction("hunyuan3d_carve", tiny=True, ckpt_dir=str(tmp_path),
                                        device="cpu").novel_views is not None


def test_an_orbax_store_raises_rather_than_giving_random_weights(tmp_path):
    from labelany3d_tpu.models.checkpoints import save_params as jax_save_params

    jax_save_params(str(tmp_path), "svrm", {"w": np.ones(2, np.float32)})
    with pytest.raises(ValueError, match="convert_cli"):
        backends.make_reconstruction("hunyuan3d", tiny=True, ckpt_dir=str(tmp_path),
                                     device="cpu")
    jax_save_params(str(tmp_path), "trellis_cond", {"w": np.ones(2, np.float32)})
    tp = backends.make_reconstruction("trellis", tiny=True, ckpt_dir=str(tmp_path),
                                      device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        tp.init_params()


def _coco_root(tmp_path):
    from labelany3d_tpu_torch.utils.png import write_png

    root = tmp_path / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    write_png(root / "images" / "val2017" / "000000000001.jpg",
              np.zeros((32, 32, 3), np.uint8))
    (root / "annotations" / "coconut_val.json").write_text(json.dumps(
        {"images": [{"id": 1, "file_name": "000000000001.jpg", "height": 32, "width": 32}],
         "annotations": [], "categories": []}))
    return root


def test_runner_main_passes_ckpt_dir_to_stage_6(tmp_path, monkeypatch):
    """F12: the CLI's `models.ckpt_dir` reaches the reconstruction factory
    (and no other stage's)."""
    from labelany3d_tpu_torch.pipeline import runner

    seen = {}
    originals = {name: getattr(backends, f"make_{name}")
                 for name in ("reconstruction", "enhance", "completion", "elevation")}

    def spy(name):
        def factory(*args, **kw):
            seen[name] = kw
            return originals[name](*args, **kw)
        return factory

    for name in originals:
        monkeypatch.setattr(backends, f"make_{name}", spy(name))
    root = _coco_root(tmp_path)
    common = ["--dataset_root", str(root), "--save_dir", str(tmp_path / "out"),
              "models.tiny=true", f"models.ckpt_dir={tmp_path / 'store'}"]
    assert runner.main(["reconstruction", *common, "run.obj_rec=trellis"], device="cpu") == 0
    assert seen["reconstruction"]["ckpt_dir"] == str(tmp_path / "store")
    assert seen["reconstruction"]["backend"] == "trellis"
    assert runner.main(["enhance", *common], device="cpu") == 0
    assert "ckpt_dir" not in seen["enhance"]
    # Without the key, the factory is given None.
    assert runner.main(["reconstruction", *common[:4], "models.tiny=true"], device="cpu") == 0
    assert seen["reconstruction"]["ckpt_dir"] is None


def test_registry_lazy_load_and_unload():
    from labelany3d_tpu_torch.models.registry import ModelRegistry

    reg = ModelRegistry()
    calls = {"n": 0}

    def factory(value=7):
        calls["n"] += 1
        return {"value": value}

    reg.register("_test_model", factory, override=True)
    m1 = reg.get("_test_model")
    m2 = reg.get("_test_model")
    assert m1 is m2 and calls["n"] == 1
    assert "_test_model" in reg.loaded() and reg.available() == ["_test_model"]
    assert reg.unload("_test_model")
    assert not reg.unload("_test_model")
    reg.get("_test_model")
    assert calls["n"] == 2
    reg.unload_all()
    assert reg.loaded() == [] and reg.available() == ["_test_model"]


def test_all_route_frees_the_models_it_built(tmp_path, monkeypatch):
    """`run_stages("all")` at tiny on the CPU: when the runner builds a
    stage's model, a weak reference to each model it built for an earlier
    stage (the registry's enhance, completion, elevation and reconstruction
    backends) is dead, and after the route so is the layout's matcher; the
    depth backend the caller passed is alive, and so are the models of the
    stage objects in a `stages` dict the caller passed."""
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from tests.test_torch_pipeline_layout import RENDER, _ToyLoader, _world

    scene, img, depth, gts, images, annos = _world()
    refs, alive_at_build = {}, {}
    make_registry = backends.default_registry

    def recording_registry():
        reg = make_registry()
        for name, factory in list(reg._factories.items()):
            def record(*args, _name=name, _f=factory, **kw):
                alive_at_build[_name] = sorted(n for n, r in refs.items() if r() is not None)
                model = _f(*args, **kw)
                refs[_name] = weakref.ref(model)
                return model
            reg.register(name, record, override=True)
        return reg

    monkeypatch.setattr(backends, "default_registry", recording_registry)
    depth_backend = backends.FakeDepthBackend(depth[None], scene.intrinsics(), device="cpu")
    caller = weakref.ref(depth_backend)
    cfg = PipelineConfig(batch_size=1, image_height=scene.height, image_width=scene.width,
                         render_size=RENDER)
    loader = _ToyLoader(images, annos)

    def run(out, backend, stages=None):
        return run_stages("all", cfg, loader, ArrayImageSource({1: img}), str(out), "val", 0, 1,
                          backend=backend, tiny=True, device="cpu", stages=stages)

    counts = run(tmp_path / "a", depth_backend)
    assert counts["depth"] == 1 and counts["reconstruction"] == 1
    assert set(refs) == {"enhance", "completion", "elevation", "reconstruction", "matcher"}
    assert alive_at_build == dict.fromkeys(refs, [])
    assert {name: r() for name, r in refs.items()} == dict.fromkeys(refs)
    assert caller() is depth_backend  # the caller's backend stays the caller's

    refs.clear()
    alive_at_build.clear()
    stages = {}
    run(tmp_path / "b", backends.FakeDepthBackend(depth[None], scene.intrinsics(), device="cpu"),
        stages)
    assert refs["matcher"]() is stages["layout"].matcher
    assert refs["elevation"]() is stages["elevation"].backend
    assert alive_at_build["matcher"] == ["completion", "elevation", "enhance", "reconstruction"]
