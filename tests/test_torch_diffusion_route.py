"""The SD-class backends' factories and the `all` route with them: the port
against the JAX package on the CPU in float32.

  * The three factories: `make_enhance("invsr")`, `make_completion("our")`
    (and with `segment="isnet"`) and `make_elevation("zero123")` build the
    ported backends as the JAX factories do; Hunyuan3D's names build too
    (tests/test_torch_hunyuan_route.py holds them to the JAX factories).
  * `run_stages("all")` with `run.enhance=invsr`, `run.amodal_completion=our`
    and `run.elevation=zero123` at `models.tiny` on one 256-px scene with one
    object, the samplers at 2 steps on both sides: its enhanced image and
    completed crop against the JAX pipelines on the same inputs, with the
    same weights and draws (the tolerance of
    `tests/test_torch_diffusion_pipelines.py`: 8-bit outputs within 2 levels,
    a mean under 0.05 level), and its elevation equal to the JAX estimator's
    on the port's views.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models.diffusion import pipelines as jpipe
from labelany3d_tpu_torch.models import saliency as tsal
from labelany3d_tpu_torch.models.diffusion import pipelines as tpipe
from tests.test_torch_diffusion_pipelines import (
    STEPS,
    _close_u8,
    _f32_jax,
    _install,
    _one_torch_thread,  # noqa: F401  (a module fixture: one torch thread)
    _trees,
    jax_draws,
)
from tests.torch_parity import random_flax_params


def test_factories_build_the_sd_backends():
    from labelany3d_tpu.models.registry import get_model, unload_all_models
    from labelany3d_tpu.pipeline.backends import register_default_backends
    from labelany3d_tpu_torch.models.elevation import MatchingElevationEstimator
    from labelany3d_tpu_torch.pipeline import backends

    register_default_backends()
    try:
        for tiny in (False, True):
            unload_all_models()
            j = {k: get_model(k, backend=b, tiny=tiny) for k, b in
                 (("enhance", "invsr"), ("completion", "our"), ("elevation", "zero123"))}
            t = {"enhance": backends.make_enhance("invsr", tiny=tiny, device="cpu", seed=3),
                 "completion": backends.make_completion("our", tiny=tiny, device="cpu"),
                 "elevation": backends.make_elevation("zero123", tiny=tiny, device="cpu")}
            assert isinstance(t["enhance"], tpipe.InvSREnhance) and t["enhance"].seed == 3
            assert isinstance(t["completion"], tpipe.AmodalCompletion)
            assert isinstance(t["elevation"], MatchingElevationEstimator)
            for k in ("enhance", "completion"):
                assert t[k].image_size == j[k].image_size
                assert dataclasses.asdict(t[k].cfg) == dataclasses.asdict(j[k].cfg)
                assert t[k].unet is None  # built on first use
                assert t[k].unet_cfg.widths == tuple(j[k].unet_cfg.widths)
                assert t[k].unet_cfg.in_channels == j[k].unet_cfg.in_channels
            assert t["enhance"].noise_predictor is None and t["completion"].segmenter is None
            tv, jv = t["elevation"].novel_views, j["elevation"].novel_views
            assert isinstance(tv, tpipe.Zero123NovelView)
            assert (tv.image_size, dataclasses.asdict(tv.cfg), tv.unet_cfg.in_channels) == \
                (jv.image_size, dataclasses.asdict(jv.cfg), jv.unet_cfg.in_channels)
            np.testing.assert_allclose(t["elevation"].K, j["elevation"].K, rtol=1e-6)
            np.testing.assert_array_equal(t["elevation"].candidates, j["elevation"].candidates)
            assert t["elevation"].pair_matcher.matcher.cfg.encoder.width == 64  # tiny, as the JAX default
        seg = backends.make_completion("our", segment="isnet", device="cpu").segmenter
        assert isinstance(seg, tsal.RembgSegmenter) and seg.input_size == 1024
        assert seg.cfg == tsal.ISNetConfig.general_use() and seg.model is None
    finally:
        unload_all_models()
    for name, cls in (("hunyuan3d", "SVRMReconstruction"),
                      ("hunyuan3d_carve", "SpaceCarveReconstruction")):
        assert type(backends.make_reconstruction(name, device="cpu")).__name__ == cls
    with pytest.raises(ValueError, match="hunyuan4d"):
        backends.make_reconstruction("hunyuan4d", device="cpu")


ROUTE_HW = (256, 256)
ROUTE_SIZE = 64  # the factories' tiny image size


def _matcher_params(seed):
    """A seeded tree of the tiny matcher (float32) and its two configs."""
    from labelany3d_tpu.models.matcher import MatcherConfig as JMatcherConfig
    from labelany3d_tpu.models.matcher import TwoViewMatcher
    from labelany3d_tpu.models.vit import ViTConfig as JViTConfig
    from labelany3d_tpu_torch.models.matcher import MatcherConfig
    from labelany3d_tpu_torch.models.vit import ViTConfig

    jcfg = dataclasses.replace(
        JMatcherConfig.tiny_test(),
        encoder=dataclasses.replace(JViTConfig.tiny_test(), dtype=jnp.float32), dtype=jnp.float32)
    tcfg = dataclasses.replace(
        MatcherConfig.tiny_test(),
        encoder=dataclasses.replace(ViTConfig.tiny_test(), dtype=torch.float32),
        dtype=torch.float32)
    img = np.zeros((1, ROUTE_SIZE, ROUTE_SIZE, 3), np.float32)
    return random_flax_params(TwoViewMatcher(jcfg).init, img, img, seed=seed), jcfg, tcfg


def test_all_route_with_sd_backends_matches_jax(tmp_path, monkeypatch):
    """`run_stages("all")` with the three SD backends from the registry at
    `tiny` (the runner passes tiny, device and seed), float32, given the
    JAX pipelines' weights and draws. Stages 2 and 4 against the JAX
    pipelines on the same inputs; stage 5's elevation against the JAX
    estimator and matcher on the views the port generated (Zero123's views
    are held to JAX's in `test_zero123_matches_jax`)."""
    import chip_smoke
    from labelany3d_tpu.models.elevation import MatchingElevationEstimator as JEstimator
    from labelany3d_tpu.pipeline.backends import JaxMatcherBackend
    from labelany3d_tpu.registration.cameras import RENDER_K
    from labelany3d_tpu_torch.pipeline import backends
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils.png import read_png

    cfg = PipelineConfig(render_size=ROUTE_SIZE, bbox_method="minarea_pallas")
    loader = chip_smoke.SyntheticLoader(1, ROUTE_HW, seed=5, min_inst=1, max_inst=1)
    jax_side, seen, views = {}, [], []
    m_tree, jm_cfg, tm_cfg = _matcher_params(31)

    def wrap(name, make):
        def factory(backend, **kw):
            seen.append((name, backend, kw.get("tiny"), kw.get("device"), kw.get("seed")))
            be = make(backend, **kw)
            nv = be.novel_views if name == "elevation" else be
            kind = type(nv).__name__
            jp = _f32_jax(getattr(jpipe, kind)(tiny=True, image_size=ROUTE_SIZE,
                                               seed=kw["seed"]))
            nv.__init__(tiny=True, image_size=ROUTE_SIZE, seed=kw["seed"], device="cpu",
                        dtype=torch.float32)
            _install(jp, nv, _trees(jp, len(seen)))
            jax_draws(nv)
            # Two sampler steps on both sides, as the module tests run.
            jp.cfg = dataclasses.replace(jp.cfg, steps=STEPS)
            nv.cfg = dataclasses.replace(nv.cfg, steps=STEPS)
            if name == "elevation":
                be.pair_matcher.matcher.cfg, be.pair_matcher.matcher.params = tm_cfg, m_tree
                generate = nv.generate

                def record(*a, **k):
                    views.append(generate(*a, **k))
                    return views[-1]

                nv.generate = record
                jm = JaxMatcherBackend(cfg=jm_cfg, params=m_tree)

                def rgba(img):
                    return np.concatenate([img.astype(np.float32) / 255.0,
                                           np.ones(img.shape[:2] + (1,), np.float32)], -1)

                def pair_match(img0, img1):
                    class V:
                        pass
                    v = V()
                    v.rgba = rgba(img1)
                    return jm.match(rgba(img0), v)

                class PortViews:  # the views the port generated, in order
                    def generate(self, crop, de, da, seed=0):
                        return views[seed]

                jp = JEstimator(PortViews(), pair_match, be.K)
                np.testing.assert_allclose(be.K[:2], RENDER_K[:2] * ROUTE_SIZE / 512.0)
            jax_side[name] = jp
            return be
        return factory

    for name in ("enhance", "completion", "elevation"):
        monkeypatch.setattr(backends, f"make_{name}",
                            wrap(name, getattr(backends, f"make_{name}")))
    out = str(tmp_path / "out")
    stages = {}
    counts = run_stages(
        "all", cfg, loader, ArrayImageSource(loader.pixels), out, "val", 0, 1,
        backend=backends.make_depth("tiny_test", device="cpu"),
        matcher=backends.TorchMatcherBackend(tiny=True, device="cpu"),
        run_options={"enhance": "invsr", "amodal_completion": "our", "elevation": "zero123"},
        tiny=True, device="cpu", stages=stages)
    assert counts["export"] == 1 and stages["layout"].failures == []
    assert sorted(seen) == [("completion", "our", True, "cpu", cfg.seed),
                            ("elevation", "zero123", True, "cpu", cfg.seed),
                            ("enhance", "invsr", True, "cpu", cfg.seed)]
    info = loader.images[0]
    sd = SceneDir(f"{out}/val/{scene_dir_name(info['file_name'])}")
    src = loader.pixels[info["id"]]
    got = read_png(sd.enhanced_image)
    assert got.shape == (4 * ROUTE_HW[0], 4 * ROUTE_HW[1], 3)
    _close_u8(got, jax_side["enhance"].enhance(src))
    ids = sd.list_crop_ids()
    assert len(ids) == 1
    for obj_id in ids:
        crop = read_png(sd.crop(obj_id))
        label = obj_id.split("_", 1)[-1].replace("_", " ")
        done = read_png(sd.crop_completed(obj_id))
        assert done.shape == crop.shape[:2] + (4,) and (done[..., 3] == 255).all()
        _close_u8(done[..., :3], jax_side["completion"].complete(crop, label)[..., :3])
        elev = float(np.load(sd.elevation(obj_id)))
        assert len(views) == 4 and elev == jax_side["elevation"].estimate(done)
