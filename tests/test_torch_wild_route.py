"""The `fast` route in wild mode: the port against the JAX package.

`run_stages("fast", ..., instance_provider=WildInstanceProvider(...))`
against the JAX `FusedFastStage` -> `CropStage` -> `ExportStage` with the
JAX `WildInstanceProvider`, on two textured 128x160 images at a constant
depth of 2 m (`FakeDepthBackend` on both sides). The wild source is the
tiny SAM in float32 with the same parameters (`tests/test_torch_sam.py`'s),
the thresholds relaxed as the JAX package's own tests relax them
(`tests/test_wild.py`), the border-prior foreground and a tagger naming
an Omni3D category. The random draws of the box fit differ, so:
  * equal: the instances (`bboxes.json`), the crop params, cam_params.json,
    and COCO3D's images, ids, categories and 2D boxes; the crop pixels
    within one level at no more than CROP_SHARE of them;
  * within BOX_TOL: the 3D boxes (a fronto-parallel plane at 2 m, where a
    pixel is 13 mm, so the sampled extremes sit within a few pixels).
Then `runner.main(["fast", "--wild", ...], device="cpu")` over a folder of
PNGs with the default wild stack, end to end.
"""

import json

import numpy as np
import torch
from PIL import Image

from labelany3d_tpu.data import sources as jsources
from labelany3d_tpu.data import wild as jwild
from labelany3d_tpu.pipeline.backends import FakeDepthBackend as JFakeDepthBackend
from labelany3d_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from labelany3d_tpu.pipeline.stages import CropStage as JCropStage
from labelany3d_tpu.pipeline.stages import ExportStage as JExportStage
from labelany3d_tpu.pipeline.stages.common import ArrayImageSource as JArraySource
from labelany3d_tpu.pipeline.stages.fused import FusedFastStage as JFusedFastStage
from labelany3d_tpu_torch.data import sources as tsources
from labelany3d_tpu_torch.data import wild as twild
from labelany3d_tpu_torch.pipeline import runner
from labelany3d_tpu_torch.pipeline.backends import FakeDepthBackend
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
from tests.test_torch_pipeline_fast import _ToyLoader
from tests.test_torch_sam import RELAXED, _tcfg, sam  # noqa: F401  (a fixture)
from tests.test_wild import _toy_wild_image

BOX_TOL = 0.15
# Crop pixels: the port resamples on the device, in another order of sums,
# so a value near .5 may round to the next level.
CROP_SHARE = 1e-5
H, W, Z = 128, 160, 2.0
FLOAT_FIELDS = {"center_cam", "dimensions", "R_cam", "bbox3D_cam", "bbox2D_proj",
                "bbox2D_trunc", "bbox2D_tight"}

torch.set_num_threads(1)


class _ChairTagger:
    """Tags every mask 'chair', an Omni3D category, so that COCO3D keeps the
    boxes (export drops the constant tagger's 'object')."""

    def tag(self, image, masks):
        return ["chair"] * len(masks)


def _read(path):
    return json.loads(path.read_text())


def _world():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W]
    images = {}
    for i in (1, 2):
        base = np.stack([np.sin(xx / (5 + 3 * i)), np.cos(yy / (7 + i)),
                         np.sin((xx + yy) / 9)], -1)
        images[i] = np.clip(127 + 100 * base + 10 * rng.normal(size=(H, W, 3)), 0, 255) \
            .astype(np.uint8)
    infos = [{"id": i, "file_name": f"{i:012d}.jpg", "height": H, "width": W} for i in images]
    K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]])
    return images, _ToyLoader(infos, {}), np.full((2, H, W), Z), K


def test_fast_wild_route_matches_jax(tmp_path, sam):
    jcfg_sam, params, _ = sam
    images, loader, depths, K = _world()
    kw = dict(batch_size=2, max_instances=8, num_points=1024, image_height=H, image_width=W)

    jsrc = jwild.WildInstanceSource(
        jwild.SamSegmentation(cfg=jcfg_sam, params=params, points_per_side=4, **RELAXED),
        jwild.BorderPriorForeground(), _ChairTagger(), overlap_threshold=-1.0)
    jprov = jsources.WildInstanceProvider(jsrc)
    jdir = tmp_path / "jax"
    jcfg = JPipelineConfig(**kw)
    JFusedFastStage(jcfg, JFakeDepthBackend(depths, K), loader, JArraySource(images), str(jdir),
                    "val", instance_provider=jprov).run(0, 2)
    JCropStage(jcfg, loader, JArraySource(images), str(jdir), "val",
               instance_provider=jprov).run(0, 2)
    jout = JExportStage(str(jdir), "val").run()

    tsrc = twild.WildInstanceSource(
        twild.SamSegmentation(cfg=_tcfg(), params=params, points_per_side=4, device="cpu",
                              **RELAXED),
        twild.BorderPriorForeground(), _ChairTagger(), overlap_threshold=-1.0)
    tdir = tmp_path / "torch"
    counts = runner.run_stages(
        "fast", PipelineConfig(**kw), loader, ArrayImageSource(images), str(tdir), "val", 0, 2,
        backend=FakeDepthBackend(depths, K, device="cpu"), device="cpu",
        instance_provider=tsources.WildInstanceProvider(tsrc))
    assert counts == {"fused": 2, "crops": 2, "export": 2}
    tout = _read(tdir / "COCO3D_val.json")

    n_boxes = 0
    for info in loader.images:
        name = info["file_name"][:-4]
        js, ts = jdir / "val" / name, tdir / "val" / name
        assert _read(ts / "cam_params.json") == _read(js / "cam_params.json")
        assert _read(ts / "bboxes.json") == _read(js / "bboxes.json")
        crops = sorted(p.name for p in (js / "crops").iterdir())
        assert crops == sorted(p.name for p in (ts / "crops").iterdir())
        for c in crops:
            if c.endswith(".npy"):
                np.testing.assert_array_equal(np.load(ts / "crops" / c), np.load(js / "crops" / c))
                continue
            a, b = (np.asarray(Image.open(d / "crops" / c), np.int32) for d in (ts, js))
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= CROP_SHARE
        jb, tb = _read(js / "3dbbox.json"), _read(ts / "3dbbox.json")
        assert [(b["obj_id"], b["category_name"]) for b in tb] == \
            [(b["obj_id"], b["category_name"]) for b in jb]
        for a, b in zip(tb, jb):
            for field in ("center_cam", "dimensions", "bbox3D_cam"):
                np.testing.assert_allclose(a[field], b[field], atol=BOX_TOL)
            assert abs(a["center_cam"][2] - Z) < BOX_TOL
        n_boxes += len(tb)
    assert n_boxes >= 2

    assert tout["images"] == jout["images"] and tout["categories"] == jout["categories"]
    assert len(tout["annotations"]) == len(jout["annotations"]) == n_boxes
    for a, b in zip(tout["annotations"], jout["annotations"]):
        assert {k: a[k] for k in a.keys() - FLOAT_FIELDS} == \
            {k: b[k] for k in b.keys() - FLOAT_FIELDS}
        assert a["bbox2D_tight"] == b["bbox2D_tight"]
        np.testing.assert_allclose(a["bbox3D_cam"], b["bbox3D_cam"], atol=BOX_TOL)


def test_runner_main_fast_wild(tmp_path):
    folder = tmp_path / "photos"
    folder.mkdir()
    img = _toy_wild_image()
    Image.fromarray(img).save(folder / "a.png")
    Image.fromarray(img[:, ::-1].copy()).save(folder / "b.png")
    out = tmp_path / "results"
    rc = runner.main(["fast", "--wild", "--dataset_root", str(folder), "--save_dir", str(out),
                      "--end_index", "5", "models.tiny=true", "compute.batch_size=1",
                      "compute.image_height=96", "compute.image_width=128"], device="cpu")
    assert rc == 0
    coco = _read(out / "COCO3D_val.json")
    with_boxes = set()
    for name in ("a", "b"):
        sd = out / "val" / name
        for f in ("depth_map.npy", "cam_params.json", "3dbbox.json", "bboxes.json", "input.png"):
            assert (sd / f).exists(), f
        boxes = _read(sd / "3dbbox.json")
        assert all(b["category_name"] == "object" for b in boxes)
        if boxes:
            with_boxes.add(name)
    listed = {im["file_path"].rsplit("/", 1)[-1].rsplit(".", 1)[0] for im in coco["images"]}
    assert with_boxes and listed == with_boxes
