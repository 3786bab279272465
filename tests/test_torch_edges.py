"""Scene-mesh geometry and PLY IO: the port against the JAX package.

`geometry/edges.py` runs on seeded point maps with NaN and inf holes, depth
steps and a border row and column unlike the opposite border (both packages
take neighbours by rolling, so border pixels see the opposite border).
Tolerances, float32: normals 1e-5 (the same cross products, normalised);
every mask, mesh index and colour exactly; mesh vertices exactly (they are
the input points). The PLY writers must give the JAX writers' bytes, and
`load_ply_points` must read back what they wrote.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.data import meshio as jmeshio
from labelany3d_tpu.geometry import edges as jedges
from labelany3d_tpu.geometry.backproject import depth_to_points as jdepth_to_points
from labelany3d_tpu_torch.data import meshio
from labelany3d_tpu_torch.geometry import edges

NORMAL_TOL = 1e-5
H, W = 24, 32


def _scene(seed: int):
    """Depth with a near box, a slanted far plane, holes, and a first row
    and last column far from the opposite border; its points, image, and
    the depth stage's valid mask."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 4.0 + 0.05 * xx + 0.02 * yy + 0.01 * rng.standard_normal((H, W)).astype(np.float32)
    depth[6:14, 8:20] = 2.0 + 0.01 * rng.standard_normal((8, 12)).astype(np.float32)
    depth[0, :] = 9.0       # the top row steps away from the bottom row
    depth[:, -1] = 1.5      # the right column steps away from the left column
    depth[3, 4] = np.nan
    depth[18, 25] = np.inf
    depth[10, 0] = 0.0      # invalid, finite
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    points = np.array(jdepth_to_points(jnp.asarray(depth), jnp.asarray(K)))
    image = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    valid = (depth > 0) & (depth < 9000)
    return depth, points, image, valid


@pytest.mark.parametrize("with_mask", [False, True])
def test_points_to_normals_matches_jax(with_mask):
    depth, points, _, valid = _scene(0)
    mask = valid if with_mask else None
    jn, jm = jedges.points_to_normals(jnp.asarray(points),
                                      None if mask is None else jnp.asarray(mask))
    tn, tm = edges.points_to_normals(torch.from_numpy(points),
                                     None if mask is None else torch.from_numpy(mask))
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=NORMAL_TOL)
    # The holes' neighbourhoods and both wrapped borders are covered.
    assert not jm[3, 4] and jm[0].any() and jm[:, -1].any()


@pytest.mark.parametrize("rtol", [0.03, 0.3])
def test_depth_edge_matches_jax(rtol):
    depth, _, _, valid = _scene(1)
    for mask in (None, valid):
        want = np.asarray(jedges.depth_edge(jnp.asarray(depth), rtol,
                                            None if mask is None else jnp.asarray(mask)))
        got = edges.depth_edge(torch.from_numpy(depth), rtol,
                               None if mask is None else torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want)
    # Windows at the border see only the image: the step under the top row
    # is an edge, and the window does not wrap to the bottom row.
    assert want[0].any() and want[1].any() and not want[-1, :8].any()


def test_normals_edge_matches_jax():
    depth, points, _, valid = _scene(2)
    jn, jm = jedges.points_to_normals(jnp.asarray(points), jnp.asarray(valid))
    for tol in (5.0, 30.0):
        want = np.asarray(jedges.normals_edge(jn, tol, jm))
        got = edges.normals_edge(torch.from_numpy(np.asarray(jn)), tol,
                                 torch.from_numpy(np.asarray(jm))).numpy()
        np.testing.assert_array_equal(got, want)
        assert want[0].any() and want[:, -1].any()


def test_edge_filtered_scene_mesh_matches_jax():
    depth, points, image, valid = _scene(3)
    jv, jf, jc = jedges.edge_filtered_scene_mesh(points, image, depth, valid)
    tv, tf, tc = edges.edge_filtered_scene_mesh(torch.from_numpy(points), image,
                                                torch.from_numpy(depth),
                                                torch.from_numpy(valid))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tc, jc)
    assert 0 < len(jv) < valid.sum() and len(jf) > 0  # some edge pixels are dropped
    # image_mesh alone, on an arbitrary mask and without colours.
    mask = np.random.default_rng(4).uniform(size=(H, W)) > 0.3
    for got, want in zip(edges.image_mesh(points, None, mask),
                         jedges.image_mesh(points, None, mask)):
        np.testing.assert_array_equal(got, want)


def test_ply_writers_match_jax_bytes(tmp_path):
    _, points, image, _ = _scene(5)
    pts = np.nan_to_num(points.reshape(-1, 3))
    cols = image.reshape(-1, 3)
    float_cols = cols.astype(np.float32) * 1.2 - 20.0  # clipped to uint8 by both
    faces = np.random.default_rng(6).integers(0, len(pts), size=(40, 3))
    cases = {"points": (meshio.save_ply_points, jmeshio.save_ply_points, (pts,)),
             "points_rgb": (meshio.save_ply_points, jmeshio.save_ply_points, (pts, cols)),
             "points_float_rgb": (meshio.save_ply_points, jmeshio.save_ply_points,
                                  (pts, float_cols)),
             "mesh": (meshio.save_ply_mesh, jmeshio.save_ply_mesh, (pts, faces)),
             "mesh_rgb": (meshio.save_ply_mesh, jmeshio.save_ply_mesh, (pts, faces, cols))}
    for name, (port, jax_writer, args) in cases.items():
        port(tmp_path / f"{name}.ply", *args)
        jax_writer(tmp_path / f"{name}_jax.ply", *args)
        assert (tmp_path / f"{name}.ply").read_bytes() == \
            (tmp_path / f"{name}_jax.ply").read_bytes(), name
        got_pts, got_cols = meshio.load_ply_points(tmp_path / f"{name}.ply")
        want_pts, want_cols = jmeshio.load_ply_points(tmp_path / f"{name}.ply")
        np.testing.assert_array_equal(got_pts, pts)
        np.testing.assert_array_equal(got_pts, want_pts)
        if len(args) > 1 + name.startswith("mesh"):
            np.testing.assert_array_equal(got_cols, want_cols)
            assert got_cols.dtype == np.uint8
        else:
            assert got_cols is None and want_cols is None
