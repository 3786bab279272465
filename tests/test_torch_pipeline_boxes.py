"""The boxes stage and the depth stage's PLYs: the port against the JAX package.

  * `label_program` (mask unpack, instance sampling, box fit) on the same
    inputs and the JAX package's draws, with `pca` and with
    `minarea_pallas` (the JAX kernel in interpret mode);
  * `BoxStage` over two synthetic scenes (fronto-parallel rectangles of
    `FakeScene`, depth and camera written as stage 1 would), at batch sizes
    1 and 2, with the JAX stage's draws: the same `obj_id` lists and
    `bboxes.json`, boxes within tolerance;
  * `DepthStage(write_ply=True)`: its two PLYs are the bytes the JAX
    package's back-projection, edge filter and writers give for the port's
    depth map and camera;
  * `runner.main` through depth, boxes and export on the CPU.

Tolerances, float32 with the same draws: box centres, dimensions and
rotations 1e-3 (sums in another order), vertices 2e-3 (rounded to
float16); back-projected points 1e-5 relative and 1e-6 absolute; masks,
ids, counts, mesh
faces and colours exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.data.meshio import save_ply_mesh as jsave_ply_mesh
from labelany3d_tpu.data.meshio import save_ply_points as jsave_ply_points
from labelany3d_tpu.data.rle import rle_encode
from labelany3d_tpu.geometry.backproject import depth_to_points as jdepth_to_points
from labelany3d_tpu.geometry.edges import edge_filtered_scene_mesh as jedge_mesh
from labelany3d_tpu.models.fakes import FakeScene
from labelany3d_tpu.pipeline import labeling as jlab
from labelany3d_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from labelany3d_tpu.pipeline.stages import BoxStage as JBoxStage
from labelany3d_tpu_torch.data.meshio import load_ply_points
from labelany3d_tpu_torch.pipeline import labeling, runner, stages
from labelany3d_tpu_torch.pipeline.backends import FakeDepthBackend
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir
from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource, pack_instance_masks
from labelany3d_tpu_torch.utils.png import write_png
from tests.torch_parity import (
    depth_ok,
    interpret_yaw_minarea,
    jax_box_stage_draws,
    jax_sample_draws,
)

BOX_TOL = 1e-3
VERT_TOL = 2e-3
POINT_RTOL, POINT_ATOL = 1e-5, 1e-6  # as tests/test_torch_geometry.py::test_depth_to_points
FIELDS = (("center_cam", BOX_TOL), ("dimensions", BOX_TOL), ("R_cam", BOX_TOL),
          ("vertices", VERT_TOL))


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


SCENES = [[{"z": 3.0, "rect": (10, 12, 50, 60)}, {"z": 5.0, "rect": (64, 20, 110, 70)}],
          [{"z": 4.0, "rect": (20, 12, 60, 44)}, {"z": 2.5, "rect": (30, 50, 90, 70)},
           {"z": 6.0, "rect": (70, 12, 108, 40)}]]  # 10 px inside the borders


def _world():
    """Two 80x120 scenes of `FakeScene` rectangles with their annotations."""
    images, annos, pixels, depths = [], {}, {}, {}
    scene = FakeScene(width=120, height=80, fx=100.0, fy=100.0)
    for iid, objects in enumerate(SCENES, start=1):
        img, depth, masks, _ = scene.make(objects)
        images.append({"id": iid, "file_name": f"{iid:012d}.jpg", "height": scene.height,
                       "width": scene.width})
        annos[iid] = []
        for i, m in enumerate(masks):
            rle = rle_encode(m)
            ys, xs = np.nonzero(m)
            annos[iid].append({
                "image_id": iid, "category_id": (62, 3, 44)[i], "iscrowd": 0,
                "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)],
                "segmentation": {"size": rle["size"], "counts": rle["counts"].decode()}})
        pixels[iid], depths[iid] = img, depth.astype(np.float32)
    return scene, _ToyLoader(images, annos), pixels, depths


def _write_depth_artifacts(root, loader, pixels, depths, K):
    """What stage 1 leaves in each scene directory."""
    for info in loader.images:
        sd = SceneDir(f"{root}/val/{info['file_name'][:-4]}").ensure()
        sd.write_depth(depths[info["id"]])
        sd.write_cam_params(K, np.eye(4), info["width"], info["height"])
        write_png(sd.input_image, pixels[info["id"]])


def _label_inputs(rng, b=2, h=32, w=64, n_inst=5):
    depth = rng.uniform(1.0, 4.0, size=(b, h, w)).astype(np.float32)
    depth[:, :3, :5] = 10000.0  # the alignment's invalid sentinel
    K = np.broadcast_to(np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32),
                        (b, 3, 3)).copy()
    masks = np.zeros((b, n_inst, h, w), bool)
    for bi in range(b):
        for i in range(n_inst - 1):  # the last slot stays empty
            y0, x0 = rng.integers(0, h - 12), rng.integers(0, w - 16)
            masks[bi, i, y0:y0 + rng.integers(6, 12), x0:x0 + rng.integers(6, 16)] = True
    return depth, K, masks, np.stack([pack_instance_masks(m) for m in masks])


@pytest.mark.parametrize("method", ["pca", "minarea_pallas"])
def test_label_program_matches_jax(method, monkeypatch):
    interpret_yaw_minarea(monkeypatch)
    depth, K, masks, packed = _label_inputs(np.random.default_rng(0))
    n_inst, n_pts = masks.shape[1], 64
    key = jax.random.PRNGKey(3)
    want = jlab.label_program(n_inst, n_pts, method)(jnp.asarray(depth), jnp.asarray(K),
                                                     jnp.asarray(packed), key)
    draws = jax_sample_draws(key, masks & depth_ok(depth)[:, None], n_pts)
    got = labeling.label_program(torch.from_numpy(depth), torch.from_numpy(K),
                                 torch.from_numpy(packed), max_instances=n_inst,
                                 num_points=n_pts, method=method, draws=draws)
    ok = np.asarray(want.boxes.ok)
    np.testing.assert_array_equal(got.boxes.ok.numpy(), ok)
    assert ok.sum() == 8 and not ok[:, -1].any()
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-6)
    for field, tol in FIELDS:
        np.testing.assert_allclose(getattr(got.boxes, field).numpy()[ok],
                                   np.asarray(getattr(want.boxes, field))[ok], atol=tol,
                                   err_msg=field)


def _effective_masks(stage, loader, root, batch_size):
    """Each batch's effective masks, from the port stage's own host prep."""
    eff = []
    for info in loader.images:
        item = stage._prep((info, SceneDir(f"{root}/val/{info['file_name'][:-4]}")))
        masks = labeling.unpack_instance_masks(torch.as_tensor(item[6]),
                                               stage.cfg.max_instances).numpy()
        eff.append(masks & depth_ok(item[4])[None])
    return [np.stack(eff[i:i + batch_size]) for i in range(0, len(eff), batch_size)]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_box_stage_matches_jax(tmp_path, batch_size):
    scene, loader, pixels, depths = _world()
    # A bucket smaller than the images: depth and masks are resized nearest
    # and K is scaled with them.
    kw = dict(batch_size=batch_size, max_instances=4, num_points=64, image_height=64,
              image_width=96)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    for root in (jdir, tdir):
        _write_depth_artifacts(root, loader, pixels, depths, scene.intrinsics())
    assert JBoxStage(JPipelineConfig(**kw), loader, jdir, "val").run(0, 2) == 2

    cfg = PipelineConfig(**kw)
    probe = stages.BoxStage(cfg, loader, tdir, "val", device="cpu")
    draws = jax_box_stage_draws(cfg.seed, _effective_masks(probe, loader, tdir, batch_size),
                                cfg.num_points)
    stage = stages.BoxStage(cfg, loader, tdir, "val", device="cpu", draws=draws)
    assert stage.run(0, 2) == 2
    assert stage.run(0, 2) == 0  # resume: boxes exist

    for info in loader.images:
        name = info["file_name"][:-4]
        js, ts = SceneDir(f"{jdir}/val/{name}"), SceneDir(f"{tdir}/val/{name}")
        jb, tb = js.read_bbox3d(), ts.read_bbox3d()
        assert [(b["obj_id"], b["category_name"]) for b in tb] == \
            [(b["obj_id"], b["category_name"]) for b in jb]
        assert len(tb) == len(SCENES[info["id"] - 1])
        for a, b in zip(tb, jb):
            for field, tol in FIELDS:
                key = "bbox3D_cam" if field == "vertices" else field
                np.testing.assert_allclose(a[key], b[key], atol=tol, err_msg=field)
        assert ts.bboxes2d.read_text() == js.bboxes2d.read_text()


def _read_ply(path):
    """(header, coloured vertex records, face bytes) of a binary PLY."""
    raw = path.read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode()
    n = int(header.split("element vertex ")[1].split()[0])
    rec = np.frombuffer(raw, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)], count=n,
                        offset=end)
    return header, rec, raw[end + rec.nbytes:]


def test_depth_stage_ply_matches_jax(tmp_path):
    """The depth stage's PLYs against the JAX package's back-projection,
    edge filter and writers on the port's depth map and camera. Points
    within 1e-5 relative and 1e-6 absolute (K^-1 from two libraries differs
    in the last bit);
    headers, colours and mesh faces byte for byte."""
    scene, loader, pixels, depths = _world()
    cfg = PipelineConfig(batch_size=2, image_height=scene.height, image_width=scene.width)
    backend = FakeDepthBackend(np.stack([depths[1], depths[2]]), scene.intrinsics(),
                               device="cpu")
    stage = stages.DepthStage(cfg, backend, loader, ArrayImageSource(pixels), str(tmp_path),
                              "val", write_ply=True)
    assert stage.run(0, 2) == 2
    for info in loader.images:
        sd = SceneDir(tmp_path / "val" / info["file_name"][:-4])
        depth = sd.read_depth()
        K = np.asarray(sd.read_cam_params()["K"], np.float32)  # the stage's float32 K
        img = pixels[info["id"]]
        pts = np.asarray(jdepth_to_points(depth, K))
        jsave_ply_points(tmp_path / "points.ply", pts.reshape(-1, 3), img.reshape(-1, 3))
        valid = (depth > 0) & (depth < 9000)
        jsave_ply_mesh(tmp_path / "mesh.ply", *jedge_mesh(pts, img, depth, valid))
        for name, want in (("depth_scene.ply", "points.ply"),
                           ("depth_scene_no_edge.ply", "mesh.ply")):
            got, want = _read_ply(sd.root / name), _read_ply(tmp_path / want)
            assert got[0] == want[0]  # header: vertex and face counts
            np.testing.assert_allclose(got[1]["xyz"], want[1]["xyz"], rtol=POINT_RTOL,
                                       atol=POINT_ATOL)
            np.testing.assert_array_equal(got[1]["rgb"], want[1]["rgb"])
            np.testing.assert_array_equal(got[2], want[2])
        verts, cols = load_ply_points(sd.root / "depth_scene.ply")
        assert verts.shape == (scene.height * scene.width, 3)
        np.testing.assert_array_equal(cols, img.reshape(-1, 3))
        # The rectangles' outlines are depth and normal edges: dropped.
        assert 0 < len(load_ply_points(sd.root / "depth_scene_no_edge.ply")[0]) < len(verts)


def test_runner_main_boxes_route(tmp_path):
    scene, loader, pixels, _ = _world()
    root = tmp_path / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    for info in loader.images:  # decoded by content
        write_png(root / "images" / "val2017" / info["file_name"], pixels[info["id"]])
    (root / "annotations" / "coconut_val.json").write_text(json.dumps(
        {"images": loader.images, "annotations": sum(loader.annos.values(), []),
         "categories": []}))
    out = tmp_path / "results"
    common = ["--dataset_root", str(root), "--save_dir", str(out), "--end_index", "2",
              "models.tiny=true", "compute.batch_size=2", "compute.image_height=64",
              "compute.image_width=96", "run.bbox_method=minarea_pallas"]
    for stage in ("depth", "boxes", "export"):
        assert runner.main([stage, *common], device="cpu") == 0
    with_boxes = []
    for info in loader.images:
        sd = SceneDir(out / "val" / info["file_name"][:-4])
        boxes = sd.read_bbox3d()
        assert all(np.isfinite(b["bbox3D_cam"]).all() for b in boxes)
        assert len(json.loads(sd.bboxes2d.read_text())) == len(SCENES[info["id"] - 1])
        if boxes:
            with_boxes.append(info["file_name"][:-4])
    coco = json.loads((out / "COCO3D_val.json").read_text())
    assert sorted(im["file_path"].split("/")[-1][:-4] for im in coco["images"]) == with_boxes


def _cube(center, size=1.0):
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float)
    return (corners * size / 2 + np.asarray(center, float)).tolist()


def test_overlay_skips_boxes_at_or_behind_the_camera(tmp_path):
    """F6: the JAX overlay raises on a box corner on the camera plane (and
    draws a box behind it mirrored); the port skips both boxes and draws
    the rest, so its overlay equals the one of the box in front alone."""
    cv2 = pytest.importorskip("cv2")
    from labelany3d_tpu.utils.visualization import draw_cube_overlay as jdraw_cube_overlay
    from labelany3d_tpu_torch.utils.visualization import draw_cube_overlay

    K = np.array([[50.0, 0, 30], [0, 50.0, 20], [0, 0, 1]])
    image = np.full((40, 60, 3), 90, np.uint8)
    front = {"bbox3D_cam": _cube([0.0, 0.0, 4.0]), "category_name": "chair"}
    on_plane = {"bbox3D_cam": [[0.0, 0.0, 0.0]] + _cube([0.0, 0.0, 3.0])[1:],
                "category_name": "car"}
    behind = {"bbox3D_cam": _cube([0.0, 0.0, 0.5], 2.0), "category_name": "cup"}
    jsd, both, alone = (SceneDir(tmp_path / n).ensure() for n in ("jax", "both", "alone"))
    with pytest.raises(cv2.error):
        jdraw_cube_overlay(jsd, image=image, K=K, cubes=[on_plane, front])
    out = draw_cube_overlay(both, image=image, K=K, cubes=[on_plane, behind, front])
    ref = draw_cube_overlay(alone, image=image, K=K, cubes=[front])
    got, want = cv2.imread(out), cv2.imread(ref)
    np.testing.assert_array_equal(got, want)
    assert (got != cv2.cvtColor(image, cv2.COLOR_RGB2BGR)).any()  # the front box is drawn
