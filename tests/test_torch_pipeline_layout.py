"""The registration chain: the port against the JAX package on one scene.

Both packages run depth -> crops -> reconstruction -> layout -> export on a
synthetic scene with two fronto-parallel rectangles (`FakeScene`, analytic
boxes), with their `FakeDepthBackend`, the thin silhouette-extrusion
reconstructor, a geometry oracle in place of the matcher (the ground-truth
placement of each extruded mesh is known from the scene), crops and
renders at 64x64 (stage A's PnP reads crop pixels through the render
intrinsics, so the two sizes must agree), and
`bbox_method='minarea_pallas'` (the JAX kernel in interpret mode). The port
gets the JAX package's PnP draws; the depth alignment's RANSAC draws
differ (jax.random against a torch.Generator), so:
  * equal: crops, crop params, object meshes, box ids and categories, and
    the images and categories of COCO3D_val.json;
  * within 0.15 (the analytic tolerance of `tests/test_torch_pipeline_fast.py`):
    box centres and dimensions against each other;
  * within 0.5: box centres against the ground truth, as the JAX package's
    own full-path test holds them.
One port-only run of `runner.main` drives the new stages through the CLI on
the CPU with the tiny depth preset and the tiny matcher.
"""

import json

import numpy as np

import labelany3d_tpu.ops.boxfit_pallas as jbp
from labelany3d_tpu.data.meshio import load_glb as jload_glb
from labelany3d_tpu.data.rle import rle_encode
from labelany3d_tpu.models.fakes import FakeScene
from labelany3d_tpu.pipeline import stages as jstages
from labelany3d_tpu.pipeline.backends import FakeDepthBackend as JFakeDepthBackend
from labelany3d_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from labelany3d_tpu_torch.data.meshio import load_glb
from labelany3d_tpu_torch.pipeline import runner
from labelany3d_tpu_torch.pipeline import stages
from labelany3d_tpu_torch.pipeline.backends import FakeDepthBackend
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir
from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
from labelany3d_tpu_torch.registration.cameras import RENDER_K, RENDER_SIZE
from labelany3d_tpu_torch.utils.png import read_png, write_png
from tests.torch_parity import OracleMatcher, PairsMatcher, jax_layout_draws

BOX_TOL = 0.15
GT_TOL = 0.5
RENDER = 64
SCENE = "000000000042"


class _ToyLoader:
    def __init__(self, images, annos_by_id):
        self.images = images
        self.annos = annos_by_id

    def get_image_by_index(self, i):
        return self.images[i]

    def get_annotations(self, image_id):
        return self.annos.get(image_id, [])

    def __len__(self):
        return len(self.images)


def _world():
    scene = FakeScene(width=192, height=160, fx=150.0, fy=150.0)
    objects = [{"z": 4.0, "rect": (20, 40, 80, 110)}, {"z": 5.0, "rect": (110, 45, 175, 120)}]
    img, depth, masks, gts = scene.make(objects)
    annos = []
    for i, m in enumerate(masks):
        rle = rle_encode(m)
        ys, xs = np.nonzero(m)
        annos.append({
            "image_id": 1, "category_id": 62 if i == 0 else 3, "iscrowd": 0,
            "bbox": [float(xs.min()), float(ys.min()),
                     float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)],
            "segmentation": {"size": rle["size"], "counts": rle["counts"].decode()},
        })
    images = [{"id": 1, "file_name": f"{SCENE}.jpg", "height": scene.height,
               "width": scene.width}]
    return scene, img, depth, gts, images, {1: annos}


def _oracle(sd: SceneDir, scene, gts, mesh_loader):
    """Oracles for the objects in the order the layout stage registers them
    (crop ids reversed): each extruded mesh sits fronto-parallel at its
    object's centre, scaled to its metric width."""
    k_render = RENDER_K * np.array([[RENDER / RENDER_SIZE], [RENDER / RENDER_SIZE], [1.0]])
    oracles = []
    for obj_id in reversed(sd.list_crop_ids()):
        gt = gts[int(obj_id.split("_")[0])]
        v = mesh_loader(sd.object_mesh(obj_id)).vertices
        T = np.eye(4)
        T[:3, :3] = gt["extent_x"] / (v[:, 0].max() - v[:, 0].min()) * np.diag([1.0, -1.0, -1.0])
        T[:3, 3] = gt["center"]
        cp = np.load(sd.crop_params(obj_id))
        oracles.append(OracleMatcher(scene.intrinsics(), T, (scene.height, scene.width),
                                     tuple(float(c) for c in cp), k_render))
    return PairsMatcher(oracles)


def test_registration_chain_matches_jax(tmp_path, monkeypatch):
    orig = jbp.yaw_minarea_pallas
    monkeypatch.setattr(jbp, "yaw_minarea_pallas",
                        lambda p, v, num_angles=512, interpret=False:
                        orig(p, v, num_angles=num_angles, interpret=True))
    scene, img, depth, gts, images, annos = _world()
    loader = _ToyLoader(images, annos)
    kw = dict(batch_size=1, max_instances=4, num_points=512, image_height=scene.height,
              image_width=scene.width, render_size=RENDER, bbox_method="minarea_pallas")

    jdir = str(tmp_path / "jax")
    jcfg = JPipelineConfig(**kw)
    jsource = jstages.common.ArrayImageSource({1: img})
    jstages.DepthStage(jcfg, JFakeDepthBackend(depth[None], scene.intrinsics()), loader,
                       jsource, jdir, "val").run(0, 1)
    jstages.CropStage(jcfg, loader, jsource, jdir, "val", crop_size=RENDER).run(0, 1)
    jstages.ReconstructionStage(jcfg, loader, jdir, "val",
                                backend=jstages.SilhouetteExtrude(depth_ratio=0.02)).run(0, 1)
    jsd = SceneDir(f"{jdir}/val/{SCENE}")
    assert jstages.LayoutStage(jcfg, loader, jdir, "val",
                               matcher=_oracle(jsd, scene, gts, jload_glb)).run(0, 1) == 1
    jout = jstages.ExportStage(jdir, "val").run()

    tdir = str(tmp_path / "torch")
    cfg = PipelineConfig(**kw)
    source = ArrayImageSource({1: img})
    assert stages.DepthStage(cfg, FakeDepthBackend(depth[None], scene.intrinsics(), device="cpu"),
                             loader, source, tdir, "val").run(0, 1) == 1
    assert stages.CropStage(cfg, loader, source, tdir, "val", crop_size=RENDER,
                            device="cpu").run(0, 1) == 1
    assert stages.ReconstructionStage(
        cfg, loader, tdir, "val", backend=stages.SilhouetteExtrude(depth_ratio=0.02)).run(0, 1) == 1
    tsd = SceneDir(f"{tdir}/val/{SCENE}")
    layout = stages.LayoutStage(cfg, loader, tdir, "val",
                                matcher=_oracle(tsd, scene, gts, load_glb), device="cpu",
                                draws=jax_layout_draws(cfg.seed, [2]))
    assert layout.run(0, 1) == 1 and layout.failures == []
    tout = stages.ExportStage(tdir, "val").run()

    ids = tsd.list_crop_ids()
    assert ids == jsd.list_crop_ids() and len(ids) == 2
    for obj_id in ids:
        np.testing.assert_array_equal(read_png(tsd.crop(obj_id)), read_png(jsd.crop(obj_id)))
        np.testing.assert_array_equal(np.load(tsd.crop_params(obj_id)),
                                      np.load(jsd.crop_params(obj_id)))
        tm, jm = load_glb(tsd.object_mesh(obj_id)), jload_glb(jsd.object_mesh(obj_id))
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
        np.testing.assert_array_equal(tm.faces, jm.faces)
        assert tsd.scene_mesh(obj_id).exists() and tsd.canonical_upright(obj_id).exists()
    assert (tsd.root / "reconstruction" / "full_scene.glb").exists()

    tb, jb = json.loads(tsd.bbox3d.read_text()), json.loads(jsd.bbox3d.read_text())
    assert [(b["obj_id"], b["category_name"]) for b in tb] == \
        [(b["obj_id"], b["category_name"]) for b in jb]
    assert len(tb) == 2
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a["center_cam"], b["center_cam"], atol=BOX_TOL)
        np.testing.assert_allclose(a["dimensions"], b["dimensions"], atol=BOX_TOL)
        c = gts[int(a["obj_id"])]["center"]
        # The convention flip diag(-1, -1, 1) negates x and y.
        np.testing.assert_allclose(a["center_cam"], [-c[0], -c[1], c[2]], atol=GT_TOL)
    assert tout["images"] == jout["images"] and tout["categories"] == jout["categories"]
    assert len(tout["annotations"]) == len(jout["annotations"]) == 2


def test_runner_main_registration_chain(tmp_path):
    scene, img, depth, gts, images, annos = _world()
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
    for stage in ("depth", "crops", "reconstruction", "layout", "export"):
        assert runner.main([stage, *common], device="cpu") == 0
    sd = SceneDir(out / "val" / SCENE)
    ids = sd.list_crop_ids()
    assert len(ids) == 2 and all(sd.object_mesh(i).exists() for i in ids)
    # Crops at CropStage's 512 px, as the JAX runner cuts them; the matcher
    # resizes the reference crops to its 64-px views.
    assert read_png(sd.crop(ids[0])).shape == (512, 512, 4)
    assert (sd.root / "reconstruction" / "full_scene.glb").exists()
    boxes = json.loads(sd.bbox3d.read_text())
    assert boxes and all(np.isfinite(b["bbox3D_cam"]).all() for b in boxes)
    coco = json.loads((out / "COCO3D_val.json").read_text())
    assert len(coco["images"]) == 1 and len(coco["annotations"]) == len(boxes)


def test_layout_records_caught_errors(tmp_path):
    """A registration that raises skips its image, as in the JAX package
    (no placed meshes, no boxes), and is kept in `failures`."""
    scene, img, depth, gts, images, annos = _world()
    loader = _ToyLoader(images, annos)
    cfg = PipelineConfig(batch_size=1, max_instances=4, image_height=scene.height,
                         image_width=scene.width, render_size=RENDER)
    source, out = ArrayImageSource({1: img}), str(tmp_path)
    stages.DepthStage(cfg, FakeDepthBackend(depth[None], scene.intrinsics(), device="cpu"),
                      loader, source, out, "val").run(0, 1)
    stages.CropStage(cfg, loader, source, out, "val", crop_size=RENDER, device="cpu").run(0, 1)
    stages.ReconstructionStage(cfg, loader, out, "val").run(0, 1)

    class Broken:
        def match_pairs(self, refs, views, ref_index):
            raise RuntimeError("kernel launch failed")

    layout = stages.LayoutStage(cfg, loader, out, "val", matcher=Broken(), device="cpu")
    assert layout.run(0, 1) == 0
    assert layout.failures == [(f"{SCENE}.jpg", "RuntimeError('kernel launch failed')")]
    assert not SceneDir(f"{out}/val/{SCENE}").bbox3d.exists()
