"""COCO3D scoring (`export/iou3d.py`, `export/evaluate.py`) against the JAX
package, on the CPU.

Tolerances. Each pair's IoU, and every statistic of `compare_coco3d`: none.
The port computes each grid point's box test with the same float32
operations as the JAX function (TF32 off), so on these seeded boxes every
IoU equals the JAX value exactly; a grid point that lies on a box face to
within rounding could flip between two implementations, which these inputs
do not hit. `mean_iou3d`, a float32 mean summed in another order: 1e-7
absolute (a few ulp of the mean). The box centres, a float32 mean of 8
corners about 6 m away: 1e-6 (the axes, half sizes and inside tests are
exact).

  * `box3d_iou` and `mean_iou3d` on seeded oriented boxes (batched, and one
    pair at a time), including identical and disjoint pairs;
  * `compare_coco3d` on the identical, perturbed and missing cases of
    `tests/test_evaluate.py`, and on a seeded 40-image pair with boxes moved,
    rotated, dropped and images missing;
  * `main`'s JSON;
  * a non-finite 2D box scores 0 (F7) where the JAX `hungarian_match` raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.export import evaluate as jeval
from labelany3d_tpu.export import iou3d as jiou
from labelany3d_tpu.geometry import convert_box_vertices as jax_corners
from labelany3d_tpu_torch.export import evaluate as teval
from labelany3d_tpu_torch.export import iou3d as tiou

torch.set_num_threads(1)


def corners(center, dims, yaw) -> np.ndarray:
    return np.asarray(jax_corners(jnp.asarray(center, jnp.float32),
                                  jnp.asarray(dims, jnp.float32), yaw), np.float32)


def seeded_pairs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    a, b = [], []
    for i in range(n):
        c = rng.uniform(-2, 2, 3) + [0, 0, 6]
        d = rng.uniform(0.3, 2.0, 3)
        y = float(rng.uniform(-np.pi, np.pi))
        a.append(corners(c, d, y))
        if i % 7 == 0:
            b.append(a[-1])  # identical
        elif i % 7 == 1:
            b.append(corners(c + 10.0, d, y))  # disjoint
        else:
            b.append(corners(c + rng.normal(0, 0.2, 3), d * rng.uniform(0.8, 1.2, 3),
                             y + float(rng.normal(0, 0.3))))
    return np.stack(a), np.stack(b)


@pytest.fixture(scope="module")
def jax_iou():
    return jax.jit(jiou.box3d_iou, static_argnames=("grid",))


@pytest.mark.parametrize("grid", [32, 17])
def test_box3d_iou_matches_jax(jax_iou, grid):
    a, b = seeded_pairs(30)
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), grid=grid))
    got = tiou.box3d_iou(torch.from_numpy(a), torch.from_numpy(b), grid).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[::7] == 1.0).all() and (got[1::7] == 0.0).all()
    assert ((got > 0) & (got < 1)).sum() > 15
    # One pair at a time (the JAX evaluator's calls) gives the same.
    for i in range(3):
        one = float(jax_iou(jnp.asarray(a[i + 2]), jnp.asarray(b[i + 2]), grid=grid))
        assert tiou.box3d_iou(torch.from_numpy(a[i + 2]), torch.from_numpy(b[i + 2]),
                              grid).item() == one
    # Leading dimensions batch.
    got2 = tiou.box3d_iou(torch.from_numpy(a[:28]).reshape(4, 7, 8, 3),
                          torch.from_numpy(b[:28]).reshape(4, 7, 8, 3), grid)
    np.testing.assert_array_equal(got2.reshape(-1).numpy(), want[:28])


def test_mean_iou3d_and_box_params_match_jax():
    a, b = seeded_pairs(12, seed=1)
    want = float(jiou.mean_iou3d(jnp.asarray(a), jnp.asarray(b)))
    assert tiou.mean_iou3d(torch.from_numpy(a), torch.from_numpy(b)).item() == \
        pytest.approx(want, abs=1e-7)
    for got, exp in zip(tiou.box_params_from_corners(torch.from_numpy(a)),
                        jiou.box_params_from_corners(jnp.asarray(a))):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)
    pts = torch.from_numpy(np.random.default_rng(2).uniform(-3, 3, (12, 50, 3)).astype(
        np.float32)) + torch.tensor([0.0, 0.0, 6.0])
    c, ax, h = tiou.box_params_from_corners(torch.from_numpy(a))
    jc, jax_, jh = jiou.box_params_from_corners(jnp.asarray(a))
    np.testing.assert_array_equal(tiou.points_in_box(pts, c, ax, h).numpy(),
                                  np.asarray(jiou.points_in_box(jnp.asarray(pts.numpy()),
                                                                jc, jax_, jh)))


def _coco3d(boxes_by_image):
    """`tests/test_evaluate.py::_coco3d`."""
    images, annotations = [], []
    img_id, anno_id = 1000000, 100000000
    for fp, boxes in boxes_by_image.items():
        images.append({"id": img_id, "file_path": fp, "width": 100, "height": 100})
        for center, dims, yaw, tight in boxes:
            annotations.append({"image_id": img_id, "id": anno_id,
                                "bbox3D_cam": corners(center, dims, yaw).tolist(),
                                "bbox2D_trunc": tight, "bbox2D_tight": tight})
            anno_id += 1
        img_id += 1
    return {"images": images, "annotations": annotations}


BASE = {"img/a.jpg": [([0, 0, 4], [1, 1, 1], 0.2, [10, 10, 30, 30]),
                      ([2, 0, 6], [2, 1, 1], 0.0, [50, 50, 80, 80])],
        "img/b.jpg": [([0, 1, 5], [1, 2, 1], 0.5, [20, 20, 60, 60])]}
MOVED = {"img/a.jpg": [([0.4, 0, 4], [1, 1, 1], 0.2, [12, 10, 32, 30])],
         "img/c.jpg": [([9, 9, 9], [1, 1, 1], 0.0, [0, 0, 5, 5])]}


def synthetic_pair(n_images: int, per_image: int, seed: int):
    """A COCO3D file and a copy with every box moved and rotated, some
    annotations dropped and some images missing (chip_smoke's phase 15(c)
    generator, at a small size)."""
    import chip_smoke

    return chip_smoke.synthetic_coco3d_pair(n_images, per_image, seed)


@pytest.mark.parametrize("case", ["identical", "perturbed_and_missing", "seeded"])
def test_compare_coco3d_matches_jax(case, monkeypatch):
    if case == "identical":
        ours, theirs, grid = _coco3d(BASE), _coco3d(BASE), 40
    elif case == "perturbed_and_missing":
        ours, theirs, grid = _coco3d(MOVED), _coco3d(BASE), 40
    else:
        ours, theirs = synthetic_pair(40, 4, seed=3)
        grid = 32
    want = jeval.compare_coco3d(ours, theirs, grid=grid)
    got = teval.compare_coco3d(ours, theirs, grid=grid, device="cpu")
    assert got == want
    if case == "identical":
        assert got["matched_pairs"] == 3 and got["mean_iou3d"] == 1.0
    elif case == "perturbed_and_missing":
        assert got["images_shared"] == 1 and got["matched_pairs"] == 1
    else:
        # The second file drops annotations and images: each of its boxes
        # is matched, not each of the first's.
        assert 0 < got["matched_pairs"] == got["annotations_theirs"] < got["annotations_ours"]
        assert 0.2 < got["mean_iou3d"] < 1.0
        # Chunks of any size give the same pairs.
        ca, cb, _ = teval.matched_corners(ours, theirs)
        whole = teval.pair_ious(ca, cb, grid, "cpu").numpy()
        monkeypatch.setattr(teval, "CHUNK", 7)
        np.testing.assert_array_equal(teval.pair_ious(ca, cb, grid, "cpu").numpy(), whole)
        self_score = teval.compare_coco3d(theirs, theirs, device="cpu")
        assert self_score["mean_iou3d"] == 1.0
        assert self_score["matched_pairs"] == self_score["annotations_theirs"]


def test_non_finite_2d_box_scores_zero():
    """F7: a 2D box with a NaN edge overlaps nothing (the JAX matcher raises)."""
    bad = {"img/a.jpg": [([0, 0, 4], [1, 1, 1], 0.2, [np.nan, 10, 30, 30]),
                         ([2, 0, 6], [2, 1, 1], 0.0, [50, 50, 80, 80])]}
    with pytest.raises(ValueError):
        jeval.compare_coco3d(_coco3d(bad), _coco3d(BASE), grid=16)
    got = teval.compare_coco3d(_coco3d(bad), _coco3d(BASE), grid=16, device="cpu")
    assert got["matched_pairs"] == 1 and got["mean_iou3d"] == 1.0


def test_main_prints_the_jax_json(tmp_path, capsys):
    (tmp_path / "ours.json").write_text(json.dumps(_coco3d(MOVED)))
    (tmp_path / "theirs.json").write_text(json.dumps(_coco3d(BASE)))
    args = [str(tmp_path / "ours.json"), str(tmp_path / "theirs.json"), "--grid", "24"]
    assert jeval.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert teval.main([*args, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == want
