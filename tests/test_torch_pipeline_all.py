"""Stages 2, 4 and 5, the reference-crop resize and the `all` route: the port
against the JAX package and Pillow.

  * `BicubicEnhance` against Pillow's BICUBIC 4x upscale at odd sizes. Both
    are Keys' kernel (a = -0.5) renormalised at the borders; Pillow sums in
    fixed point (22 fractional bits) and rounds once, the port in float32,
    so a pixel may differ by one level where the exact value lies near .5.
    Tolerance: at most 1 level anywhere, at least 99% of values equal.
  * `TorchMatcherBackend._prep_ref` against `JaxMatcherBackend._prep_ref`
    (8-bit truncation, then Pillow's default resize) at 512 -> 64 and
    300 -> 512: within 1/255, the same one-level rounding.
  * The enhance, completion and elevation stages against the JAX stages:
    completed crops and elevations equal, the enhanced image within 1 level.
  * The `all` chain on the scene of `tests/test_torch_pipeline_layout.py`
    (FakeDepthBackend, silhouette reconstruction, a geometry oracle for the
    matcher, crops and renders at 64 px): JAX runs its eight stages; the
    port runs its eight stages given JAX's `enhanced/input.png`, so crops
    (cut from the 4x image), crop params, object meshes, completed crops and
    elevations are compared exactly, and boxes within 0.15 of JAX's (the
    depth alignment's RANSAC draws differ) and 0.5 of the ground truth.
  * `runner.main(["all", ...])` end to end on the CPU at the tiny presets.
"""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

from labelany3d_tpu.data.meshio import load_glb as jload_glb
from labelany3d_tpu.pipeline import stages as jstages
from labelany3d_tpu.pipeline.backends import FakeDepthBackend as JFakeDepthBackend
from labelany3d_tpu.pipeline.backends import JaxMatcherBackend
from labelany3d_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from labelany3d_tpu_torch.data.meshio import load_glb
from labelany3d_tpu_torch.pipeline import runner, stages
from labelany3d_tpu_torch.pipeline.backends import (
    FakeDepthBackend,
    TorchMatcherBackend,
    default_registry,
)
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir
from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
from labelany3d_tpu_torch.utils.png import read_png, write_png
from tests.test_torch_pipeline_layout import BOX_TOL, GT_TOL, RENDER, SCENE, _oracle, _ToyLoader
from tests.test_torch_pipeline_layout import _world as _layout_world
from tests.torch_parity import interpret_yaw_minarea, jax_layout_draws

LEVEL_TOL = 1          # uint8 levels
EQUAL_SHARE = 0.99


@pytest.mark.parametrize("hw", [(37, 53), (5, 8), (48, 64)])
def test_bicubic_enhance_matches_pillow(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    img[0] = 255  # saturated and black borders: the clip and the renormalisation
    img[:, -1] = 0
    want = np.asarray(Image.fromarray(img).resize((hw[1] * 4, hw[0] * 4), Image.BICUBIC))
    got = stages.BicubicEnhance(device="cpu").enhance(img)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= LEVEL_TOL
    assert (diff == 0).mean() >= EQUAL_SHARE


@pytest.mark.parametrize("src,dst", [(512, 64), (300, 512)])
def test_prep_ref_matches_jax(src, dst):
    ref = np.random.default_rng(src).uniform(size=(src, src, 4)).astype(np.float32)
    ref[: src // 3] = 1.0
    want = JaxMatcherBackend._prep_ref(None, ref, dst, dst)
    got = TorchMatcherBackend._prep_ref(ref, dst, dst)
    assert got.shape == want.shape == (dst, dst, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LEVEL_TOL / 255 + 1e-6)
    assert (np.abs(got - want) < 1e-6).mean() >= EQUAL_SHARE
    np.testing.assert_array_equal(TorchMatcherBackend._prep_ref(ref, src, src), ref[..., :3])


def test_generative_backends_not_ported_raise():
    reg = default_registry()
    # TRELLIS ("trellis") is ported: tests/test_torch_trellis_pipeline.py; the
    # SD-class backends ("invsr", "our", "zero123") too:
    # tests/test_torch_diffusion_pipelines.py; and Hunyuan3D's
    # ("hunyuan3d", "hunyuan3d_carve"): tests/test_torch_hunyuan_route.py.
    # Every stage-6 name builds; an unknown one raises.
    for name, cls in (("hunyuan3d", "SVRMReconstruction"),
                      ("hunyuan3d_carve", "SpaceCarveReconstruction")):
        assert type(default_registry().get("reconstruction", backend=name, tiny=True,
                                           device="cpu")).__name__ == cls
    with pytest.raises(ValueError, match="hunyuan4d"):
        reg.get("reconstruction", backend="hunyuan4d")
    reg = default_registry()  # nothing cached after a raise, but start clean
    for kind, name, cls in (("enhance", "invsr", "InvSREnhance"),
                            ("completion", "our", "AmodalCompletion"),
                            ("elevation", "zero123", "MatchingElevationEstimator")):
        assert type(default_registry().get(kind, backend=name, tiny=True,
                                           device="cpu")).__name__ == cls
    assert isinstance(reg.get("enhance", device="cpu"), stages.BicubicEnhance)
    assert isinstance(reg.get("completion"), stages.PassthroughCompletion)
    assert isinstance(reg.get("elevation"), stages.ZeroElevation)
    assert isinstance(reg.get("reconstruction"), stages.SilhouetteExtrude)


def _chain_jax(tmp_path, kw, world):
    scene, img, depth, gts, images, annos = world
    loader = _ToyLoader(images, annos)
    jdir = str(tmp_path / "jax")
    jcfg = JPipelineConfig(**kw)
    jsource = jstages.common.ArrayImageSource({1: img})
    jstages.DepthStage(jcfg, JFakeDepthBackend(depth[None], scene.intrinsics()), loader,
                       jsource, jdir, "val").run(0, 1)
    jstages.EnhanceStage(jcfg, loader, jsource, jdir, "val").run(0, 1)
    jstages.CropStage(jcfg, loader, jsource, jdir, "val", crop_size=RENDER).run(0, 1)
    jstages.CompletionStage(jcfg, loader, jdir, "val").run(0, 1)
    jstages.ElevationStage(jcfg, loader, jdir, "val").run(0, 1)
    jstages.ReconstructionStage(jcfg, loader, jdir, "val",
                                backend=jstages.SilhouetteExtrude(depth_ratio=0.02)).run(0, 1)
    jsd = SceneDir(f"{jdir}/val/{SCENE}")
    assert jstages.LayoutStage(jcfg, loader, jdir, "val",
                               matcher=_oracle(jsd, scene, gts, jload_glb)).run(0, 1) == 1
    return jsd, jstages.ExportStage(jdir, "val").run()


def test_all_chain_matches_jax(tmp_path, monkeypatch):
    interpret_yaw_minarea(monkeypatch)
    world = _layout_world()
    scene, img, depth, gts, images, annos = world
    loader = _ToyLoader(images, annos)
    kw = dict(batch_size=1, max_instances=4, num_points=512, image_height=scene.height,
              image_width=scene.width, render_size=RENDER, bbox_method="minarea_pallas")
    jsd, jout = _chain_jax(tmp_path, kw, world)

    tdir = str(tmp_path / "torch")
    cfg = PipelineConfig(**kw)
    source = ArrayImageSource({1: img})
    tsd = SceneDir(f"{tdir}/val/{SCENE}")
    assert stages.DepthStage(cfg, FakeDepthBackend(depth[None], scene.intrinsics(), device="cpu"),
                             loader, source, tdir, "val").run(0, 1) == 1
    # The enhance stage keeps the image it is given (resume): JAX's.
    tsd.enhanced_image.parent.mkdir()
    shutil.copy(jsd.enhanced_image, tsd.enhanced_image)
    assert stages.EnhanceStage(cfg, loader, source, tdir, "val", device="cpu").run(0, 1) == 0
    assert stages.CropStage(cfg, loader, source, tdir, "val", crop_size=RENDER,
                            device="cpu").run(0, 1) == 1
    assert stages.CompletionStage(cfg, loader, tdir, "val").run(0, 1) == 1
    assert stages.ElevationStage(cfg, loader, tdir, "val").run(0, 1) == 1
    assert stages.ReconstructionStage(
        cfg, loader, tdir, "val", backend=stages.SilhouetteExtrude(depth_ratio=0.02)).run(0, 1) == 1
    layout = stages.LayoutStage(cfg, loader, tdir, "val",
                                matcher=_oracle(tsd, scene, gts, load_glb), device="cpu",
                                draws=jax_layout_draws(cfg.seed, [2]))
    assert layout.run(0, 1) == 1 and layout.failures == []
    tout = stages.ExportStage(tdir, "val").run()

    assert read_png(tsd.enhanced_image).shape == (4 * scene.height, 4 * scene.width, 3)
    ids = tsd.list_crop_ids()
    assert ids == jsd.list_crop_ids() and len(ids) == 2
    for obj_id in ids:
        for path in (SceneDir.crop, SceneDir.crop_completed):
            np.testing.assert_array_equal(read_png(path(tsd, obj_id)), read_png(path(jsd, obj_id)))
        np.testing.assert_array_equal(np.load(tsd.crop_params(obj_id)),
                                      np.load(jsd.crop_params(obj_id)))
        assert np.load(tsd.elevation(obj_id)) == np.load(jsd.elevation(obj_id)) == 0.0
        tm, jm = load_glb(tsd.object_mesh(obj_id)), jload_glb(jsd.object_mesh(obj_id))
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
        np.testing.assert_array_equal(tm.faces, jm.faces)

    tb, jb = tsd.read_bbox3d(), json.loads(jsd.bbox3d.read_text())
    assert [(b["obj_id"], b["category_name"]) for b in tb] == \
        [(b["obj_id"], b["category_name"]) for b in jb]
    assert len(tb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a["center_cam"], b["center_cam"], atol=BOX_TOL)
        np.testing.assert_allclose(a["dimensions"], b["dimensions"], atol=BOX_TOL)
        c = gts[int(a["obj_id"])]["center"]
        np.testing.assert_allclose(a["center_cam"], [-c[0], -c[1], c[2]], atol=GT_TOL)
    assert tout["images"] == jout["images"] and tout["categories"] == jout["categories"]
    assert len(tout["annotations"]) == len(jout["annotations"]) == 2


def test_runner_main_all_route(tmp_path):
    scene, img, depth, gts, images, annos = _layout_world()
    root = tmp_path / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    write_png(root / "images" / "val2017" / f"{SCENE}.jpg", img)  # decoded by content
    (root / "annotations" / "coconut_val.json").write_text(json.dumps(
        {"images": images, "annotations": annos[1], "categories": []}))
    out = tmp_path / "results"
    common = ["--dataset_root", str(root), "--save_dir", str(out), "--end_index", "1",
              "models.tiny=true", "compute.batch_size=1", f"compute.render_size={RENDER}",
              f"compute.image_height={scene.height}", f"compute.image_width={scene.width}",
              "run.bbox_method=minarea_pallas"]
    assert runner.main(["all", *common], device="cpu") == 0
    sd = SceneDir(out / "val" / SCENE)
    assert read_png(sd.enhanced_image).shape == (4 * scene.height, 4 * scene.width, 3)
    ids = sd.list_crop_ids()
    assert len(ids) == 2
    for obj_id in ids:
        # 512-px crops from the 4x image, params in original-image pixels.
        assert read_png(sd.crop_completed(obj_id)).shape == (512, 512, 4)
        ox, oy, sc = np.load(sd.crop_params(obj_id))
        side = 512 / sc
        assert 0 <= ox + side / 2 < scene.width and 0 <= oy + side / 2 < scene.height
        assert side < max(scene.width, scene.height)
        assert np.load(sd.elevation(obj_id)) == 0.0 and sd.object_mesh(obj_id).exists()
    boxes = sd.read_bbox3d()
    assert boxes and all(np.isfinite(b["bbox3D_cam"]).all() for b in boxes)
    coco = json.loads((out / "COCO3D_val.json").read_text())
    assert len(coco["images"]) == 1 and len(coco["annotations"]) == len(boxes)
    # The CLI reaches the generative factories with its run options: InvSR and
    # Hunyuan3D are ported (the enhanced image and the meshes exist, so the
    # stages resume past them), and an unknown stage-6 name raises.
    assert runner.main(["enhance", *common, "run.enhance=invsr"], device="cpu") == 0
    assert runner.main(["reconstruction", *common, "run.obj_rec=hunyuan3d"], device="cpu") == 0
    with pytest.raises(ValueError, match="hunyuan4d"):
        runner.main(["reconstruction", *common, "run.obj_rec=hunyuan4d"], device="cpu")
