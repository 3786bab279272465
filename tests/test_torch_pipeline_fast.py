"""The `fast` route: the port against the JAX package on one synthetic scene.

Both packages run FusedFastStage -> CropStage -> ExportStage with their
`FakeDepthBackend` on the scene of `tests/test_pipeline_e2e.py` (two
fronto-parallel rectangles with analytic boxes). The random draws differ
(jax.random against a torch.Generator), so:
  * equal: cam_params.json, bboxes.json, input.png, crop pixels and crop
    params, and the structure, ids and categories of COCO3D_val.json;
  * within 2% relative: depth_map.npy (RANSAC on different subsets);
  * within the analytic 0.15 tolerance: box centres, dimensions, vertices.
One port-only run of `runner.main` with the `tiny_test` depth preset
checks the CLI end to end on the CPU. The fused pass keeps its spans
(`fused.*`) under a profiler, the writes on their own thread, and none
without one.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from labelany3d_tpu.data.rle import rle_encode
from labelany3d_tpu.export.hungarian import hungarian_match as jhungarian_match
from labelany3d_tpu.models.fakes import FakeScene
from labelany3d_tpu.pipeline.backends import FakeDepthBackend as JFakeDepthBackend
from labelany3d_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from labelany3d_tpu.pipeline.stages import CropStage as JCropStage
from labelany3d_tpu.pipeline.stages import ExportStage as JExportStage
from labelany3d_tpu.pipeline.stages.common import ArrayImageSource as JArraySource
from labelany3d_tpu.pipeline.stages.fused import FusedFastStage as JFusedFastStage
from labelany3d_tpu_torch.export.hungarian import hungarian_match
from labelany3d_tpu_torch.pipeline import runner
from labelany3d_tpu_torch.pipeline.backends import FakeDepthBackend
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
from labelany3d_tpu_torch.pipeline.stages.fused import FusedFastStage
from labelany3d_tpu_torch.utils import profiling
from labelany3d_tpu_torch.utils.png import write_png

BOX_TOL = 0.15
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
    """The `synthetic_world` scene of tests/test_pipeline_e2e.py."""
    scene = FakeScene(width=192, height=160, fx=150.0, fy=150.0)
    objects = [{"z": 4.0, "rect": (30, 40, 80, 110)}, {"z": 6.0, "rect": (110, 50, 170, 120)}]
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


def _read(path):
    return json.loads(path.read_text())


def test_fast_route_matches_jax(tmp_path):
    scene, img, depth, gts, images, annos = _world()
    loader = _ToyLoader(images, annos)
    kw = dict(batch_size=2, max_instances=8, num_points=512, image_height=scene.height,
              image_width=scene.width)

    jdir = tmp_path / "jax"
    jcfg = JPipelineConfig(**kw)
    JFusedFastStage(jcfg, JFakeDepthBackend(depth[None], scene.intrinsics()), loader,
                    JArraySource({1: img}), str(jdir), "val").run(0, 1)
    JCropStage(jcfg, loader, JArraySource({1: img}), str(jdir), "val").run(0, 1)
    jout = JExportStage(str(jdir), "val").run()

    tdir = tmp_path / "torch"
    counts = runner.run_stages(
        "fast", PipelineConfig(**kw), loader, ArrayImageSource({1: img}), str(tdir), "val", 0, 1,
        backend=FakeDepthBackend(depth[None], scene.intrinsics(), device="cpu"), device="cpu")
    assert counts == {"fused": 1, "crops": 1, "export": 1}
    tout = _read(tdir / "COCO3D_val.json")

    js, ts = jdir / "val" / SCENE, tdir / "val" / SCENE
    assert _read(ts / "cam_params.json") == _read(js / "cam_params.json")
    assert _read(ts / "bboxes.json") == _read(js / "bboxes.json")
    np.testing.assert_array_equal(np.asarray(Image.open(ts / "input.png")), img)
    np.testing.assert_allclose(np.load(ts / "depth_map.npy"), np.load(js / "depth_map.npy"),
                               rtol=2e-2)

    crops = sorted(p.name for p in (js / "crops").iterdir())
    assert crops == sorted(p.name for p in (ts / "crops").iterdir()) and len(crops) == 4
    for name in crops:
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(ts / "crops" / name)),
                                          np.asarray(Image.open(js / "crops" / name)))
        else:
            np.testing.assert_array_equal(np.load(ts / "crops" / name),
                                          np.load(js / "crops" / name))

    jb, tb = _read(js / "3dbbox.json"), _read(ts / "3dbbox.json")
    assert [(b["obj_id"], b["category_name"]) for b in tb] == \
        [(b["obj_id"], b["category_name"]) for b in jb]
    for a, b in zip(tb, jb):
        for field in ("center_cam", "dimensions", "bbox3D_cam"):
            np.testing.assert_allclose(a[field], b[field], atol=BOX_TOL)
        np.testing.assert_allclose(a["center_cam"], gts[int(a["obj_id"])]["center"],
                                   atol=BOX_TOL)

    assert tout.keys() == jout.keys()
    assert tout["info"] == jout["info"] and tout["categories"] == jout["categories"]
    assert tout["images"] == jout["images"]
    assert len(tout["annotations"]) == len(jout["annotations"]) == 2
    float_fields = {"center_cam", "dimensions", "R_cam", "bbox3D_cam", "bbox2D_proj",
                    "bbox2D_trunc", "bbox2D_tight"}
    for a, b in zip(tout["annotations"], jout["annotations"]):
        assert a.keys() == b.keys()
        assert {k: a[k] for k in a.keys() - float_fields} == \
            {k: b[k] for k in b.keys() - float_fields}
        np.testing.assert_allclose(a["bbox3D_cam"], b["bbox3D_cam"], atol=BOX_TOL)
        assert a["bbox2D_tight"] == b["bbox2D_tight"]


def test_runner_main_tiny_preset(tmp_path):
    scene, img, depth, gts, images, annos = _world()
    root = tmp_path / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    write_png(root / "images" / "val2017" / f"{SCENE}.jpg", img)  # decoded by content
    (root / "annotations" / "coconut_val.json").write_text(json.dumps(
        {"images": images, "annotations": annos[1], "categories": []}))
    out = tmp_path / "results"
    rc = runner.main(["fast", "--dataset_root", str(root), "--save_dir", str(out),
                      "--end_index", "5", "models.tiny=true", "compute.batch_size=1",
                      f"compute.image_height={scene.height}",
                      f"compute.image_width={scene.width}"], device="cpu")
    assert rc == 0
    sd = out / "val" / SCENE
    for name in ("depth_map.npy", "cam_params.json", "3dbbox.json", "bboxes.json",
                 "input.png"):
        assert (sd / name).exists(), name
    d = np.load(sd / "depth_map.npy")
    assert d.shape == (scene.height, scene.width) and np.isfinite(d).all()
    coco = _read(out / "COCO3D_val.json")
    assert coco["info"]["id"] == 22
    assert len(list((sd / "crops").glob("*_reproj.png"))) == 2


def test_hungarian_match_scores_non_finite_iou_zero():
    """F7: a 2D box projected from corners behind the camera has non-finite
    edges. The JAX `hungarian_match` raises (scipy refuses NaN); the port
    scores such a pair 0 and matches the rest as JAX does without it."""
    b0 = np.array([[0, 0, 10, 10], [np.nan, 0, 5, 5], [40, 40, 60, 70]], np.float32)
    b1 = np.array([[1, 1, 10, 10], [20, 20, 30, 30], [42, 40, 60, 66]], np.float32)
    with pytest.raises(ValueError):
        jhungarian_match(b0, b1)
    got = hungarian_match(b0, b1)
    assert [(i, j) for i, j, _ in got] == [(0, 0), (1, 1), (2, 2)]
    assert got[1][2] == 0.0
    finite = [0, 2]
    want = jhungarian_match(b0[finite], b1[finite])
    np.testing.assert_allclose([got[k][2] for k in finite], [w[2] for w in want], rtol=1e-6)


def test_fused_pass_spans(tmp_path):
    scene, img, depth, gts, images, annos = _world()
    ids = (1, 2, 3)  # three copies of the scene: a batch of 2, then of 1
    loader = _ToyLoader([dict(images[0], id=i, file_name=f"{i:012d}.jpg") for i in ids],
                        {i: annos[1] for i in ids})
    cfg = PipelineConfig(batch_size=2, max_instances=8, num_points=512,
                         image_height=scene.height, image_width=scene.width)

    def run(out):
        backend = FakeDepthBackend(np.repeat(depth[None], 3, 0), scene.intrinsics(),
                                   device="cpu")
        stage = FusedFastStage(cfg, backend, loader, ArrayImageSource(dict.fromkeys(ids, img)),
                               str(out), "val")
        return stage.run(0, 3)

    profiling.clear_spans()
    assert run(tmp_path / "plain") == 3
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert run(tmp_path / "traced") == 3
    spans = profiling.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert set(by) == {"fused.prefetch_wait", "fused.prep", "fused.dispatch", "depth.infer",
                       "labeling.program", "fused.write", "fused.drain"}
    assert len(by["fused.prep"]) == 3 and len(by["fused.prefetch_wait"]) == 4
    assert [s.unit for s in by["fused.dispatch"]] == [0, 1]
    assert sorted(s.unit for s in by["fused.write"]) == [0, 1]
    assert [s.unit for s in by["labeling.program"]] == [0, 1]
    for name in ("depth.infer", "labeling.program"):
        assert all(spans[s.parent].name == "fused.dispatch" for s in by[name])
    main = by["fused.dispatch"][0].thread
    assert all(s.thread == main for s in by["fused.prefetch_wait"] + by["fused.drain"])
    assert all(s.thread != main for s in by["fused.write"] + by["fused.prep"])
    assert all(s.parent is None for s in by["fused.write"])
    profiling.clear_spans()
