"""Registration and its pieces: the port against the JAX package on the CPU.

Rasterizer, renderer, PnP (fed the JAX package's RANSAC draws),
`so3_exp`, `median_ratio_scale`, the crop inverse maps, the PNG reader and
the GLB IO, then `register_objects` with a geometry oracle standing in for
the matcher (as `tests/test_registration_pipeline.py` does). Renders run at
96x96 (the 512x512 render camera scaled down) to keep CPU time small.

Tolerances: rasters are the same f32 arithmetic, so depth and barycentrics
agree to 1e-5 and face ids on all but edge-grazing pixels (at most 0.2%);
PnP poses to 1e-3 (f32 linear algebra from two libraries: Cholesky, SVD,
solves); mesh IO is exact; the registered transforms to 1e-2, set by the
PnP poses through the median-ratio scale, and both near the ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from labelany3d_tpu.data import meshio as jmeshio
from labelany3d_tpu.geometry.align import median_ratio_scale as jmedian_ratio_scale
from labelany3d_tpu.geometry.crops import crop_to_image_coords as jcrop_to_image_coords
from labelany3d_tpu.geometry.crops import restore_mask_from_crop as jrestore_mask_from_crop
from labelany3d_tpu.geometry.pnp import solve_pnp_dlt as jsolve_pnp_dlt
from labelany3d_tpu.geometry.pnp import solve_pnp_ransac as jsolve_pnp_ransac
from labelany3d_tpu.geometry.transforms import so3_exp as jso3_exp
from labelany3d_tpu.ops.rasterize import rasterize_mesh as jrasterize_mesh
from labelany3d_tpu.registration import process as jprocess
from labelany3d_tpu.registration.renderer import OrbitRenderer as JOrbitRenderer
from labelany3d_tpu_torch.data import meshio
from labelany3d_tpu_torch.geometry.align import median_ratio_scale
from labelany3d_tpu_torch.geometry.crops import crop_to_image_coords, restore_mask_from_crop
from labelany3d_tpu_torch.geometry.pnp import solve_pnp_dlt, solve_pnp_ransac
from labelany3d_tpu_torch.geometry.transforms import so3_exp
from labelany3d_tpu_torch.ops.rasterize import rasterize_mesh
from labelany3d_tpu_torch.registration import process
from labelany3d_tpu_torch.registration.cameras import RENDER_K, RENDER_SIZE
from labelany3d_tpu_torch.registration.renderer import OrbitRenderer
from labelany3d_tpu_torch.utils.png import read_png, write_png
from tests.oracles import rotate_y_np
from tests.test_registration_pipeline import _textured_cube
from tests.torch_parity import OracleMatcher, PairsMatcher, jax_pnp_draws

RASTER_TOL = 1e-5
EDGE_SHARE = 2e-3
POSE_TOL = 1e-3
TRANSFORM_TOL = 1e-2
SIZE = 96
K_RENDER = RENDER_K * np.array([[SIZE / RENDER_SIZE], [SIZE / RENDER_SIZE], [1.0]], np.float32)


def _meshes():
    """The textured cube of the JAX registration test, in both packages."""
    j = _textured_cube()
    return j, meshio.Mesh(j.vertices.copy(), j.faces.copy(), j.colors.copy())


def _same_raster(got_depth, got_fid, want_depth, want_fid):
    fid_equal = got_fid == want_fid
    assert 1.0 - fid_equal.mean() <= EDGE_SHARE
    np.testing.assert_allclose(got_depth[fid_equal], want_depth[fid_equal], atol=RASTER_TOL)


def test_rasterize_matches_jax():
    jm, tm = _meshes()
    R = rotate_y_np(0.5) @ np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)],
                                     [0, np.sin(0.3), np.cos(0.3)]])
    cam = (jm.vertices @ R.T + np.array([0.1, -0.05, 2.5])).astype(np.float32)
    K = np.array([[90.0, 0, 40.0], [0, 95.0, 30.0], [0, 0, 1]], np.float32)
    want = jrasterize_mesh(jnp.asarray(cam), jnp.asarray(jm.faces), jnp.asarray(K), (64, 80),
                           faces_per_tile=128)
    got = rasterize_mesh(torch.from_numpy(cam), torch.from_numpy(tm.faces), torch.from_numpy(K),
                         (64, 80), faces_per_tile=128)
    _same_raster(got.depth.numpy(), got.face_id.numpy(), np.asarray(want.depth),
                 np.asarray(want.face_id))
    ok = got.face_id.numpy() == np.asarray(want.face_id)
    np.testing.assert_allclose(got.bary.numpy()[ok], np.asarray(want.bary)[ok], atol=RASTER_TOL)
    assert (got.face_id >= 0).float().mean() > 0.2  # the cube covers the view


def test_renderer_matches_jax():
    jm, tm = _meshes()
    jr = JOrbitRenderer(image_size=SIZE, K=K_RENDER, faces_per_tile=256)
    tr = OrbitRenderer(image_size=SIZE, K=K_RENDER, faces_per_tile=256, device="cpu")
    want = jr.render_orbit_views(jm, [-10.0, 20.0], [0.0, 135.0])
    got = tr.render_orbit_views(tm, [-10.0, 20.0], [0.0, 135.0])
    R, t = rotate_y_np(0.4).astype(np.float32), np.array([0.0, 0.1, 3.0], np.float32)
    K_img = np.array([[60.0, 0, 35.0], [0, 60.0, 25.0], [0, 0, 1]], np.float32)
    want.append(jr.render_pose(jm, R, t, image_size=(50, 70), K=K_img))
    got.append(tr.render_pose(tm, R, t, image_size=(50, 70), K=K_img))
    for g, w in zip(got, want):
        assert g.rgba.shape == w.rgba.shape and g.depth.shape == w.depth.shape
        hit = (g.depth > 0) & (w.depth > 0)
        assert ((g.depth > 0) != (w.depth > 0)).mean() <= EDGE_SHARE
        np.testing.assert_allclose(g.depth[hit], w.depth[hit], atol=RASTER_TOL)
        np.testing.assert_array_equal(g.R, w.R)
        np.testing.assert_array_equal(g.t, w.t)
        close = np.abs(g.rgba - w.rgba).max(-1) <= 1e-4
        assert close.mean() >= 1.0 - EDGE_SHARE


def _pnp_problem(rng, b, n=200):
    K = np.array([[300.0, 0, 160.0], [0, 310.0, 120.0], [0, 0, 1]], np.float32)
    obj = rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)
    R = np.stack([rotate_y_np(a) for a in rng.uniform(-1, 1, b)]).astype(np.float32)
    t = np.stack([[0.2 * k, -0.1, 5.0] for k in range(b)]).astype(np.float32)
    cam = np.einsum("bij,bnj->bni", R, obj) + t[:, None]
    img = cam[..., :2] / cam[..., 2:] * np.diag(K)[:2] + K[:2, 2]
    img = img + rng.normal(scale=0.5, size=img.shape)
    img[:, ::5] += rng.uniform(-80, 80, size=img[:, ::5].shape)  # 20% outliers
    valid = rng.uniform(size=(b, n)) > 0.1
    return obj, img.astype(np.float32), K, valid, R, t


def test_pnp_ransac_matches_jax_with_the_same_draws():
    rng = np.random.default_rng(0)
    obj, img, K, valid, R_gt, t_gt = _pnp_problem(rng, 2)
    draws = jax_pnp_draws(jax.random.PRNGKey(7), 2)
    want = [jsolve_pnp_ransac(jnp.asarray(obj[i]), jnp.asarray(img[i]), jnp.asarray(K),
                              jnp.asarray(valid[i]), jax.random.split(
                                  jax.random.split(jax.random.PRNGKey(7))[0], 2)[i])
            for i in range(2)]
    d = torch.stack([draws(0, i, int(valid[i].sum())) for i in range(2)])
    got = solve_pnp_ransac(torch.from_numpy(obj), torch.from_numpy(img), torch.from_numpy(K),
                           torch.from_numpy(valid), d)
    for i, w in enumerate(want):
        assert bool(got.ok[i]) and bool(w.ok)
        np.testing.assert_allclose(got.rotation[i].numpy(), np.asarray(w.rotation), atol=POSE_TOL)
        np.testing.assert_allclose(got.translation[i].numpy(), np.asarray(w.translation),
                                   atol=POSE_TOL)
        np.testing.assert_array_equal(got.inliers[i].numpy(), np.asarray(w.inliers))
        np.testing.assert_allclose(got.error[i].item(), float(w.error), rtol=1e-3)
        np.testing.assert_allclose(got.rotation[i].numpy(), R_gt[i], atol=0.02)
        np.testing.assert_allclose(got.translation[i].numpy(), t_gt[i], atol=0.1)


def test_pnp_ransac_reports_too_few_points():
    rng = np.random.default_rng(1)
    obj, img, K, valid, _, _ = _pnp_problem(rng, 1, n=20)
    valid[:] = False
    valid[0, :4] = True
    res = solve_pnp_ransac(torch.from_numpy(obj), torch.from_numpy(img), torch.from_numpy(K),
                           torch.from_numpy(valid), generator=torch.Generator().manual_seed(0))
    assert not bool(res.ok[0])


def test_pnp_zero_focal_is_non_finite_like_jax():
    """F9: a zero focal makes K^-1 infinite (`inv_ex`, as `jnp.linalg.inv`).
    The DLT then has no pose: NaN where the JAX result is NaN, without
    raising, and the other batch element as JAX's; RANSAC reports not ok
    (as the JAX RANSAC does on a zero focal)."""
    rng = np.random.default_rng(3)
    obj = rng.uniform(-1, 1, size=(2, 40, 3)).astype(np.float32)
    img = rng.uniform(0, 100, size=(2, 40, 2)).astype(np.float32)
    K = np.array([[[0, 0, 50], [0, 0, 40], [0, 0, 1]],
                  [[80, 0, 50], [0, 80, 40], [0, 0, 1]]], np.float32)
    want_R, want_t = (np.asarray(a) for a in jsolve_pnp_dlt(*map(jnp.asarray, (obj, img, K))))
    got_R, got_t = (a.numpy() for a in solve_pnp_dlt(*map(torch.from_numpy, (obj, img, K))))
    np.testing.assert_array_equal(np.isfinite(got_R), np.isfinite(want_R))
    np.testing.assert_array_equal(np.isfinite(got_t), np.isfinite(want_t))
    assert not np.isfinite(want_R[0]).any() and np.isfinite(want_R[1]).all()
    np.testing.assert_allclose(got_R[1], want_R[1], atol=POSE_TOL)
    np.testing.assert_allclose(got_t[1], want_t[1], atol=POSE_TOL)

    got = solve_pnp_ransac(torch.from_numpy(obj[:1]), torch.from_numpy(img[:1]),
                           torch.from_numpy(K[0]), torch.ones(1, 40, dtype=torch.bool),
                           generator=torch.Generator().manual_seed(1))
    assert not bool(got.ok[0]) and int(got.inliers.sum()) == 0
    assert not torch.isfinite(got.rotation).any()


def test_so3_exp_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-9
    np.testing.assert_allclose(so3_exp(torch.from_numpy(w)).numpy(),
                               np.asarray(jso3_exp(jnp.asarray(w))), atol=1e-6)


def test_median_ratio_scale_matches_jax():
    rng = np.random.default_rng(3)
    scene = rng.uniform(1, 5, size=(20, 24)).astype(np.float32)
    render = rng.uniform(0.5, 2, size=(3, 20, 24)).astype(np.float32)
    render[:, :5] = 0.0
    overlap = rng.uniform(size=(3, 20, 24)) > 0.4
    overlap[2] = False
    s, has = median_ratio_scale(torch.from_numpy(scene), torch.from_numpy(render),
                                torch.from_numpy(overlap))
    for i in range(3):
        ws, wh = jmedian_ratio_scale(jnp.asarray(scene), jnp.asarray(render[i]),
                                     jnp.asarray(overlap[i]))
        assert bool(has[i]) == bool(wh)
        np.testing.assert_allclose(s[i].item(), float(ws), rtol=1e-6)


@pytest.mark.parametrize("crop,offset,scale,out_hw", [
    (256, (10.4, 20.6), 2.048, (160, 192)),  # 256 / 2.048 lands just below 125 in f32
    (64, (-5.0, 3.2), 0.5, (90, 100)),       # crop larger than the image window
])
def test_restore_mask_and_crop_coords_match_jax(crop, offset, scale, out_hw):
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=(crop, crop)) > 0.5
    want = np.asarray(jrestore_mask_from_crop(jnp.asarray(mask), jnp.float32(offset[0]),
                                              jnp.float32(offset[1]), jnp.float32(scale),
                                              out_hw))
    got = restore_mask_from_crop(torch.from_numpy(mask), offset[0], offset[1], scale,
                                 out_hw).numpy()
    np.testing.assert_array_equal(got, want)
    pts = rng.uniform(0, crop, size=(7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        crop_to_image_coords(torch.from_numpy(pts), *offset, scale).numpy(),
        np.asarray(jcrop_to_image_coords(jnp.asarray(pts), *offset, scale)), rtol=1e-6)


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 2), (23, 31, 3), (23, 31, 4)])
def test_read_png_round_trips(tmp_path, shape):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    img[:10] = img[:10] // 16 * 16  # smooth rows: Pillow's encoder picks other filters
    Image.fromarray(img).save(tmp_path / "b.png", optimize=True)
    np.testing.assert_array_equal(read_png(tmp_path / "b.png"), img)
    if len(shape) == 2 or shape[2] != 2:  # the writer takes gray, RGB and RGBA
        write_png(tmp_path / "a.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)


def test_glb_io_matches_jax(tmp_path):
    jm, tm = _meshes()
    meshio.save_glb(tmp_path / "port.glb", tm)
    jmeshio.save_glb(tmp_path / "jax.glb", jm)
    assert (tmp_path / "port.glb").read_bytes() == (tmp_path / "jax.glb").read_bytes()
    back = meshio.load_glb(tmp_path / "jax.glb")
    np.testing.assert_array_equal(back.vertices, jm.vertices)
    np.testing.assert_array_equal(back.faces, jm.faces)
    np.testing.assert_array_equal(back.colors, jm.colors)
    np.testing.assert_array_equal(tm.sample(300, seed=3), jm.sample(300, seed=3))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = 2.0 * rotate_y_np(0.3), [1.0, 2.0, 3.0]
    np.testing.assert_allclose(tm.apply_transform(T).vertices, jm.apply_transform(T).vertices,
                               rtol=0, atol=0)
    textured = jmeshio.Mesh(jm.vertices, jm.faces, uv=np.zeros((len(jm.vertices), 2), np.float32),
                            texture=np.zeros((4, 4, 3), np.uint8))
    textured.texture[1:, 2:] = 200  # vertices sample more than one texel value
    textured.uv[::2] = 0.9
    jmeshio.save_glb(tmp_path / "tex.glb", textured)
    # A textured GLB (TRELLIS's output) reads back as the JAX package reads
    # it: UVs, texture, and vertex colours sampled from the texture.
    got, want = meshio.load_glb(tmp_path / "tex.glb"), jmeshio.load_glb(tmp_path / "tex.glb")
    for name in ("vertices", "faces", "uv", "texture", "colors"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert len(np.unique(got.colors, axis=0)) > 1


def test_register_objects_matches_jax():
    jm, tm = _meshes()
    K_img = np.array([[120.0, 0, 48.0], [0, 120.0, 40.0], [0, 0, 1]], np.float32)
    hw = (80, 96)
    jr = JOrbitRenderer(image_size=SIZE, K=K_RENDER, faces_per_tile=256)
    tr = OrbitRenderer(image_size=SIZE, K=K_RENDER, faces_per_tile=256, device="cpu")
    gts, depths = [], []
    for s, yaw, t, crop in ((1.0, 0.4, (-0.6, 0.0, 4.0), (0.0, 0.0, 1.0)),
                            (0.7, -0.6, (0.8, 0.1, 5.0), (40.0, 10.0, 2.0))):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = s * rotate_y_np(yaw), s * np.asarray(t)
        placed = jmeshio.Mesh(jm.vertices.copy(), jm.faces, jm.colors).apply_transform(T)
        depths.append(jr.render_pose(placed, np.eye(3, dtype=np.float32),
                                     np.zeros(3, np.float32), image_size=hw, K=K_img).depth)
        gts.append((T, crop))
    masks = [d > 0 for d in depths]
    near = np.where(masks[0], depths[0], np.inf) <= np.where(masks[1], depths[1], np.inf)
    scene_depth = np.where(masks[0] & near, depths[0], np.where(masks[1], depths[1], 5.0))
    ref = np.zeros((SIZE, SIZE, 4), np.float32)
    oracles = PairsMatcher([OracleMatcher(K_img, T, hw, crop, K_RENDER) for T, crop in gts])

    def objects(pkg, mesh):
        return [pkg.ObjectToRegister(mesh, ref, 0.0, crop, m) for (_, crop), m in zip(gts, masks)]

    want = jprocess.register_objects(objects(jprocess, jm), K_img, hw, scene_depth, oracles,
                                     key=jax.random.PRNGKey(3), renderer=jr)
    got = process.register_objects(objects(process, tm), K_img, hw, scene_depth, oracles,
                                   renderer=tr, draws=jax_pnp_draws(jax.random.PRNGKey(3), 2))
    for g, w, (T, _) in zip(got, want, gts):
        assert g.ok and w.ok
        np.testing.assert_allclose(g.transform, w.transform, atol=TRANSFORM_TOL)
        assert abs(g.num_inliers - w.num_inliers) <= 2
        np.testing.assert_allclose(g.transform[:3, :3], T[:3, :3], atol=0.1)
        np.testing.assert_allclose(g.transform[:3, 3], T[:3, 3], atol=0.3)
