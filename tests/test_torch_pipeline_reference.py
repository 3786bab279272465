"""The checkpoint-faithful models in the pipeline: the port against the JAX
package on the CPU.

  * `make_depth("tiny_reference")` builds the configurations the JAX
    package's `make_depth("tiny_reference")` builds, and the depth backend
    at them (MoGe with the reference head, the 35-patch DepthPro, which runs
    at its fixed 512 px here and is resized around) agrees with
    `JaxDepthBackend` given the same parameters. Both sides replace the
    configurations' bf16 ViTs by float32, where agreement can be held to a
    tolerance: 1e-3 relative for intrinsics and depth (the focal solve),
    masks equal.
  * The registration chain depth -> crops -> reconstruction -> layout ->
    export on the scene of `tests/test_torch_pipeline_layout.py`, with those
    depth models and the float32 `tiny_catmlpdpt_test` matcher (a rope
    encoder through K2's plain version), both given the JAX chain's
    parameters and random draws (the depth alignment's RANSAC draws and the
    PnP draws). Equal: crops, meshes, box ids and categories, COCO3D's
    images and categories; COCO3D's intrinsics, the depth maps and the box
    centres and dimensions within 1e-3 relative (boxes plus 1e-3 absolute:
    the depth maps agree to about 1e-4 relative and scale every registered
    box).

Parameters: the JAX trees of shapes filled from seeds (`random_flax_params`);
the MoGe seed's point map, with its x and y channels negated, recovers a
positive focal, so DepthPro's metric depth is not the clipped sentinel.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import labelany3d_tpu.ops.boxfit_pallas as jbp
from labelany3d_tpu.data.meshio import load_glb as jload_glb
from labelany3d_tpu.models import depth_pro as jdp
from labelany3d_tpu.models import matcher as jmatcher
from labelany3d_tpu.models import moge as jmoge
from labelany3d_tpu.pipeline import stages as jstages
from labelany3d_tpu.pipeline.backends import JaxDepthBackend, JaxMatcherBackend
from labelany3d_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from labelany3d_tpu_torch.data.meshio import load_glb
from labelany3d_tpu_torch.models import depth_pro, matcher, moge
from labelany3d_tpu_torch.pipeline import stages
from labelany3d_tpu_torch.pipeline.backends import (
    TorchDepthBackend,
    TorchMatcherBackend,
    make_depth,
)
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir
from labelany3d_tpu_torch.pipeline.stages import depth as depth_stage
from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
from labelany3d_tpu_torch.utils.png import read_png
from tests.test_torch_pipeline_layout import RENDER, SCENE, _ToyLoader, _world
from tests.torch_parity import jax_layout_draws, jax_ransac_draws, random_flax_params

RTOL = 1e-3
BOX_TOL = 1e-3
VITS = ("patch_encoder", "image_encoder", "fov_encoder")


def _f32_moge(cfg, dtype):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype=dtype))


def _f32_dp(cfg, dtype):
    return dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), dtype=dtype)
                                       for k in VITS})


def _f32_matcher(cfg, dtype):
    return dataclasses.replace(cfg, dtype=dtype,
                               encoder=dataclasses.replace(cfg.encoder, dtype=dtype))


@pytest.fixture(scope="module")
def world():
    """The scene, and both packages' depth backends at the reference
    configurations (float32 ViTs) with the same parameters, shared by the
    tests so that the JAX backend compiles its program once."""
    scene, img, _depth, _gts, images, annos = _world()
    hw = (scene.height, scene.width)
    jmc = _f32_moge(jmoge.MoGeConfig.tiny_reference_test(), jnp.float32)
    jdc = _f32_dp(jdp.DepthPro35Config.tiny_test(), jnp.float32)
    pm = random_flax_params(jmoge.MoGeModel(jmc).init, jnp.zeros((1, *hw, 3)), seed=3)
    out = pm["head"]["out0_conv_out"]  # negate x, y: a positive focal
    out["kernel"][..., :2] *= -1
    out["bias"][:2] *= -1
    s = jdc.img_size
    pd = random_flax_params(jdp.DepthPro35(jdc).init, jnp.zeros((1, s, s, 3)), seed=13)
    tmc = _f32_moge(moge.MoGeConfig.tiny_reference_test(), torch.float32)
    tdc = _f32_dp(depth_pro.DepthPro35Config.tiny_test(), torch.float32)
    jb = JaxDepthBackend(jmc, jdc, params_moge=pm, params_depth_pro=pd, pin_hw=hw)
    tb = TorchDepthBackend(tmc, tdc, params_moge=pm, params_depth_pro=pd, pin_hw=hw,
                           device="cpu")
    return scene, img, images, annos, jb, tb


def test_make_depth_tiny_reference_configs():
    from labelany3d_tpu.pipeline.backends import register_default_backends
    from labelany3d_tpu.models.registry import get_model

    register_default_backends()
    jb = get_model("depth", preset="tiny_reference")
    tb = make_depth("tiny_reference", device="cpu")
    assert isinstance(tb, TorchDepthBackend) and tb._dp35 and jb._dp35

    def fields(cfg):  # dtypes named alike across the two packages
        return {k: (str(v).split(".")[-1].replace("'>", "") if "dtype" in k else
                    fields(v) if dataclasses.is_dataclass(v) else v)
                for k, v in ((f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg))
                if k not in ("param_dtype", "fused_attn", "swiglu")}

    assert fields(tb.moge_cfg) == fields(jb.moge_cfg)
    assert fields(tb.dp_cfg) == fields(jb.dp_cfg)


def test_depth_backend_reference_matches_jax(world):
    _scene, img, _images, _annos, jb, tb = world
    want, got = jb.infer(img[None]), tb.infer(img[None])
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["depth_mask"].numpy(), np.asarray(want["depth_mask"]))
    mask = np.asarray(want["depth_mask"])
    assert mask.mean() > 0.1
    np.testing.assert_allclose(got["K_pixels"].numpy(), np.asarray(want["K_pixels"]), rtol=RTOL)
    assert float(want["K_pixels"][0, 0, 0]) > 0
    np.testing.assert_allclose(got["relative_depth"].numpy()[mask],
                               np.asarray(want["relative_depth"])[mask], rtol=RTOL)
    met = np.asarray(want["metric_depth"])
    assert met.min() < 9999.0  # not only the clipped sentinel
    np.testing.assert_allclose(got["metric_depth"].numpy(), met, rtol=RTOL)


def test_registration_chain_reference_models_match_jax(world, tmp_path, monkeypatch):
    orig_yaw = jbp.yaw_minarea_pallas
    monkeypatch.setattr(jbp, "yaw_minarea_pallas",
                        lambda p, v, num_angles=512, interpret=False:
                        orig_yaw(p, v, num_angles=num_angles, interpret=True))
    scene, img, images, annos, jb, tb = world
    loader = _ToyLoader(images, annos)
    hw = (scene.height, scene.width)
    kw = dict(batch_size=1, max_instances=4, num_points=512, image_height=hw[0],
              image_width=hw[1], render_size=RENDER, bbox_method="minarea_pallas")
    jmat = _f32_matcher(jmatcher.MatcherConfig.tiny_catmlpdpt_test(), jnp.float32)
    tmat = _f32_matcher(matcher.MatcherConfig.tiny_catmlpdpt_test(), torch.float32)
    img_m = jnp.zeros((1, RENDER, RENDER, 3))
    pmat = random_flax_params(jmatcher.TwoViewMatcher(jmat).init, img_m, img_m, seed=7)

    jdir = str(tmp_path / "jax")
    jcfg = JPipelineConfig(**kw)
    jsource = jstages.common.ArrayImageSource({1: img})
    jstages.DepthStage(jcfg, jb, loader, jsource, jdir, "val").run(0, 1)
    jstages.CropStage(jcfg, loader, jsource, jdir, "val", crop_size=RENDER).run(0, 1)
    jstages.ReconstructionStage(jcfg, loader, jdir, "val",
                                backend=jstages.SilhouetteExtrude(depth_ratio=0.02)).run(0, 1)
    jlayout = jstages.LayoutStage(jcfg, loader, jdir, "val",
                                  matcher=JaxMatcherBackend(cfg=jmat, params=pmat))
    assert jlayout.run(0, 1) == 1
    jout = jstages.ExportStage(jdir, "val").run()

    # The JAX depth stage's first batch aligns with the key split from
    # PRNGKey(seed); the port's stage gets the same RANSAC draws.
    key = jax.random.split(jax.random.PRNGKey(jcfg.seed))[1]
    draws = jax_ransac_draws(key, 1, hw[0] * hw[1])
    orig_fusion = depth_stage.depth_fusion
    monkeypatch.setattr(depth_stage, "depth_fusion",
                        lambda rel, met, mask, generator=None: orig_fusion(rel, met, mask, draws))
    tdir = str(tmp_path / "torch")
    cfg = PipelineConfig(**kw)
    source = ArrayImageSource({1: img})
    assert stages.DepthStage(cfg, tb, loader, source, tdir, "val").run(0, 1) == 1
    assert stages.CropStage(cfg, loader, source, tdir, "val", crop_size=RENDER,
                            device="cpu").run(0, 1) == 1
    assert stages.ReconstructionStage(
        cfg, loader, tdir, "val", backend=stages.SilhouetteExtrude(depth_ratio=0.02)).run(0, 1) == 1
    tmatcher = TorchMatcherBackend(cfg=tmat, params=pmat, device="cpu")
    layout = stages.LayoutStage(cfg, loader, tdir, "val", matcher=tmatcher, device="cpu",
                                draws=jax_layout_draws(cfg.seed, [2]))
    assert layout.run(0, 1) == 1 and layout.failures == []
    assert tmatcher.forwards > 0
    tout = stages.ExportStage(tdir, "val").run()

    tsd, jsd = SceneDir(f"{tdir}/val/{SCENE}"), SceneDir(f"{jdir}/val/{SCENE}")
    np.testing.assert_allclose(tsd.read_depth(), jsd.read_depth(), rtol=RTOL)
    ids = tsd.list_crop_ids()
    assert ids == jsd.list_crop_ids() and len(ids) == 2
    for obj_id in ids:
        np.testing.assert_array_equal(read_png(tsd.crop(obj_id)), read_png(jsd.crop(obj_id)))
        tm, jm = load_glb(tsd.object_mesh(obj_id)), jload_glb(jsd.object_mesh(obj_id))
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
    tb_, jb_ = json.loads(tsd.bbox3d.read_text()), json.loads(jsd.bbox3d.read_text())
    assert [(b["obj_id"], b["category_name"]) for b in tb_] == \
        [(b["obj_id"], b["category_name"]) for b in jb_]
    assert len(tb_) == 2
    for a, b in zip(tb_, jb_):
        for key in ("center_cam", "dimensions"):
            np.testing.assert_allclose(a[key], b[key], rtol=BOX_TOL, atol=BOX_TOL, err_msg=key)
    assert tout["categories"] == jout["categories"] and len(tout["images"]) == 1
    ti, ji = tout["images"][0], jout["images"][0]
    np.testing.assert_allclose(ti.pop("K"), ji.pop("K"), rtol=RTOL)
    assert ti == ji


def test_runner_main_depth_tiny_reference(tmp_path):
    """The CLI runs the depth stage at the checkpoint-faithful graphs on the
    CPU (`models.moge.preset=tiny_reference`, random weights)."""
    from labelany3d_tpu_torch.pipeline import runner
    from labelany3d_tpu_torch.utils.png import write_png

    scene, img, _depth, _gts, images, annos = _world()
    root = tmp_path / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    write_png(root / "images" / "val2017" / f"{SCENE}.jpg", img)
    (root / "annotations" / "coconut_val.json").write_text(json.dumps(
        {"images": images, "annotations": annos[1], "categories": []}))
    out = tmp_path / "results"
    assert runner.main(["depth", "--dataset_root", str(root), "--save_dir", str(out),
                        "--end_index", "1", "models.moge.preset=tiny_reference",
                        "compute.batch_size=1", f"compute.image_height={scene.height}",
                        f"compute.image_width={scene.width}"], device="cpu") == 0
    sd = SceneDir(out / "val" / SCENE)
    depth = sd.read_depth()
    assert depth.shape == (scene.height, scene.width) and np.isfinite(depth).all()
