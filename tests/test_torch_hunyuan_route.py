"""Stage 6's Hunyuan3D backends: the space carver, the factories and
`run_stages("reconstruction")` with `run.obj_rec=hunyuan3d`, the port
against the JAX package on the CPU.

  * `carve_occupancy` recovering a cube from six rendered silhouettes (the
    JAX test's IoU > 0.75) with the JAX function's occupancy (equal: the
    same float32 projections), and `SpaceCarveReconstruction` end to end
    and with one view, as `tests/test_spacecarve.py` checks the JAX one,
    each against the JAX mesh (equal: one occupancy, one extraction);
  * `make_reconstruction("hunyuan3d")` (mvd_std views, or Zero123's with
    `views="zero123"`) and `make_reconstruction("hunyuan3d_carve")` build the
    JAX factories' backends; an unknown name raises `ValueError`;
  * `run_stages("reconstruction")` with `run.obj_rec=hunyuan3d` at `tiny`
    (the runner passes tiny, device and seed) in float32 with the JAX
    package's weights and `jax.random` draws, against the JAX stage on the
    same crop: the same surface (`same_surface` at 0.98: Pillow's resizes
    in the JAX package and the port's within one level of them move the
    views by a level here and there, and the SVRM lattice with them).
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import spacecarve as jsc
from labelany3d_tpu_torch.models import spacecarve as tsc
from tests.test_spacecarve import _cube_mesh, _RenderedViews
from tests.test_torch_svrm import _one_torch_thread, same_surface  # noqa: F401


def _cube_views(cfg):
    views = _RenderedViews(_cube_mesh(0.5), cfg)
    alphas, Rs, ts = [], [], []
    for azim in cfg.views_azimuths:
        _, alpha = views.render(azim)
        R, t = jsc.opencv_orbit_pose(cfg.elevation, azim, cfg.radius)
        alphas.append(alpha)
        Rs.append(R)
        ts.append(t)
    return views, np.stack(alphas), np.stack(Rs), np.stack(ts)


def _tcfg(jcfg):
    return tsc.SpaceCarveConfig(**dataclasses.asdict(jcfg))


def test_carve_recovers_cube_occupancy():
    jcfg = jsc.SpaceCarveConfig(grid_size=32, extent=0.6)
    views, alphas, Rs, ts = _cube_views(jcfg)
    want = np.asarray(jsc.carve_occupancy(jnp.asarray(alphas), jnp.asarray(Rs), jnp.asarray(ts),
                                          jnp.asarray(views.K), jcfg))
    got = tsc.carve_occupancy(torch.from_numpy(alphas), Rs, ts, views.K, _tcfg(jcfg)).numpy()
    np.testing.assert_array_equal(got, want)
    g = jcfg.grid_size
    tsl = ((np.arange(g) + 0.5) / g * 2 - 1) * jcfg.extent
    gx, gy, gz = np.meshgrid(tsl, tsl, tsl, indexing="ij")
    gt = (np.abs(gx) <= 0.25) & (np.abs(gy) <= 0.25) & (np.abs(gz) <= 0.25)
    assert (got & gt).sum() / (got | gt).sum() > 0.75


def _equal_mesh(got, want):
    assert len(got.vertices) == len(want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-6)
    np.testing.assert_allclose(got.colors, want.colors, atol=1e-6)


def test_spacecarve_backend_end_to_end():
    jcfg = jsc.SpaceCarveConfig(grid_size=32, extent=0.6)
    views = _RenderedViews(_cube_mesh(0.5), jcfg)
    rgb, alpha = views.render(0.0)
    crop = np.concatenate([rgb, (alpha[..., None] * 255).astype(np.uint8)], axis=-1)
    want = jsc.SpaceCarveReconstruction(jcfg, novel_views=views).reconstruct(crop)
    out = tsc.SpaceCarveReconstruction(_tcfg(jcfg), novel_views=views,
                                       device="cpu").reconstruct(crop)
    assert not out.is_empty
    _equal_mesh(out, want)
    # The JAX test's bounds: the hull contains the cube, well inside the grid.
    ext = out.vertices.max(0) - out.vertices.min(0)
    assert (ext >= 0.45).all() and (ext <= 0.80).all(), ext
    assert ((np.abs(out.vertices) < 0.20).all(axis=1)).mean() < 0.05


def test_spacecarve_single_view_and_resized_crop():
    """No view source: the input silhouette alone. A view source of
    another size: the crop resized as Pillow's NEAREST resizes it."""
    from PIL import Image

    jcfg = jsc.SpaceCarveConfig(grid_size=16, extent=0.6)
    crop = np.zeros((64, 64, 4), np.uint8)
    crop[16:48, 24:40, 3] = 255
    crop[16:48, 24:40, :3] = 128
    want = jsc.SpaceCarveReconstruction(jcfg, novel_views=None).reconstruct(crop)
    got = tsc.SpaceCarveReconstruction(_tcfg(jcfg), novel_views=None,
                                       device="cpu").reconstruct(crop)
    assert not got.is_empty
    _equal_mesh(got, want)
    odd = np.random.default_rng(0).integers(0, 256, (77, 77, 4)).astype(np.uint8)
    for size in (32, 64, 100):
        np.testing.assert_array_equal(
            tsc.resize_nearest(odd, size),
            np.asarray(Image.fromarray(odd).resize((size, size), Image.NEAREST)))


def test_factories_build_the_hunyuan_backends():
    from labelany3d_tpu.pipeline.backends import register_default_backends
    from labelany3d_tpu.models.registry import get_model, unload_all_models
    from labelany3d_tpu_torch.models.diffusion import MVDStdViews, Zero123NovelView
    from labelany3d_tpu_torch.models.svrm import SVRMReconstruction
    from labelany3d_tpu_torch.pipeline.backends import default_registry, make_reconstruction

    register_default_backends()
    try:
        for tiny in (False, True):
            for name, kw in (("hunyuan3d", {}), ("hunyuan3d", {"views": "zero123"}),
                             ("hunyuan3d_carve", {})):
                unload_all_models()
                j = get_model("reconstruction", backend=name, tiny=tiny, **kw)
                t = make_reconstruction(name, tiny=tiny, device="cpu", seed=2, **kw)
                assert type(t).__name__ == type(j).__name__
                assert type(t.novel_views).__name__ == type(j.novel_views).__name__
                if isinstance(t.novel_views, Zero123NovelView):
                    assert t.novel_views.image_size == j.novel_views.image_size
                    assert t.novel_views.seed == 2
                else:
                    assert isinstance(t.novel_views, MVDStdViews)
                    assert dataclasses.asdict(t.novel_views.cfg) == \
                        dataclasses.asdict(j.novel_views.cfg)
                    assert t.novel_views.unet_cfg.widths == tuple(j.novel_views.unet_cfg.widths)
                    assert t.novel_views.unet is None  # built on first use
                if isinstance(t, SVRMReconstruction):
                    assert {k: v for k, v in dataclasses.asdict(t.cfg).items() if k != "dtype"} \
                        == {k: v for k, v in dataclasses.asdict(j.cfg).items()
                            if k not in ("dtype", "param_dtype")}
                    assert t.model is None and t._seed == 2
                else:
                    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    finally:
        unload_all_models()
    reg = default_registry()
    assert isinstance(reg.get("reconstruction", backend="hunyuan3d", tiny=True, device="cpu"),
                      SVRMReconstruction)
    for bad in ({"backend": "hunyuan4d"}, {"backend": "hunyuan3d", "views": "dreamgaussian"}):
        with pytest.raises(ValueError):
            make_reconstruction(tiny=True, device="cpu", **bad)


def test_reconstruction_stage_with_hunyuan3d_matches_jax(tmp_path, monkeypatch):
    """`run_stages("reconstruction")` with `run.obj_rec=hunyuan3d` on one
    scene with one 64-px crop: the factory's backend given the JAX
    backend's weights (SVRM and the mvd_std pipeline, float32) and draws,
    against the JAX `ReconstructionStage` over a copy of the scene."""
    import chip_smoke
    from labelany3d_tpu.models import svrm as js
    from labelany3d_tpu.pipeline.config import PipelineConfig as JConfig
    from labelany3d_tpu.pipeline.stages.generative import ReconstructionStage as JStage
    from labelany3d_tpu_torch.data.meshio import load_glb
    from labelany3d_tpu_torch.models.diffusion import mvd as tm
    from labelany3d_tpu_torch.models.svrm import SVRMConfig, SVRMReconstruction
    from labelany3d_tpu_torch.pipeline import backends
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.utils.png import write_png
    from tests.test_torch_mvd import _f32_jax_views, jax_mvd_draws, mvd_trees
    from tests.test_torch_svrm import svrm_params

    loader = chip_smoke.SyntheticLoader(1, (128, 128), seed=3, min_inst=1, max_inst=1)
    out = tmp_path / "port"
    sd = SceneDir(out / "val" / scene_dir_name(loader.images[0]["file_name"])).ensure()
    crop = chip_smoke.trellis_crop(5, 64)
    write_png(sd.crop("0_chair"), crop)
    shutil.copytree(out, tmp_path / "jax")

    jcfg = dataclasses.replace(js.SVRMConfig.tiny_test(dtype=jnp.float32))
    p = svrm_params(jcfg, seed=21)
    jviews = _f32_jax_views()
    trees = mvd_trees(jviews, seed=50)
    jviews.set_params(trees)
    seen = []
    make = backends.make_reconstruction

    def factory(backend, **kw):
        seen.append((backend, kw.get("tiny"), kw.get("device"), kw.get("seed")))
        be = make(backend, **kw)
        assert isinstance(be, SVRMReconstruction)
        assert isinstance(be.novel_views, tm.MVDStdViews)
        nv = tm.MVDStdViews(tiny=True, device="cpu", dtype=torch.float32).set_params(trees)
        nv._draws = lambda noise, seed: {k: torch.from_numpy(v)
                                         for k, v in jax_mvd_draws(nv, seed).items()}
        be.novel_views, be.params = nv, p
        be.cfg = dataclasses.replace(SVRMConfig.tiny_test(), dtype=torch.float32)
        return be

    monkeypatch.setattr(backends, "make_reconstruction", factory)
    counts = run_stages("reconstruction", PipelineConfig(), loader, None, str(out), "val", 0, 1,
                        run_options={"obj_rec": "hunyuan3d"}, tiny=True, device="cpu")
    assert counts["reconstruction"] == 1
    assert seen == [("hunyuan3d", True, "cpu", PipelineConfig().seed)]
    jrec = js.SVRMReconstruction(novel_views=jviews, cfg=jcfg, params=p)
    JStage(JConfig(), loader, str(tmp_path / "jax"), "val", backend=jrec).run(0, 1)
    got = load_glb(sd.object_mesh("0_chair"))
    want = load_glb(SceneDir(tmp_path / "jax" / "val" / sd.root.name).object_mesh("0_chair"))
    assert len(want.vertices) > 0
    assert same_surface(got, want, share=0.98)
