"""TRELLIS's ops in the port against the JAX package on the CPU, float32,
the same numpy inputs made from a seed.

  * Morton and Hilbert codes: equal (integers).
  * `subm_sparse_conv3d` (gather-first and matmul-first branches),
    `sparse_pool_pair`, `sparse_unpool`, `sparse_downsample`: pooling
    equal in slot order, features within 1e-5 relative (sums reordered).
  * `windowed_attention_3d` (both shifts, and a window overflowing its
    slots) and `serialized_attention`: within 1e-5.
  * `marching_cubes`: equal triangles; `rasterize_gaussians`: within 1e-5
    of the JAX render (exp and cumprod in another order).
  * `flexicubes_to_mesh`, `uv_unwrap_box`: the same host numpy, equal.
  * `bake_texture`: texture within 1 level, vertex colours within 1/255.
  * The 8-bit bilinear preprocess against Pillow: at most 1 level, at least
    99% of values equal (Pillow sums in fixed point).
  * Textured and empty GLBs: the port's writer read back by both readers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from labelany3d_tpu.data import meshio as jmeshio
from labelany3d_tpu.models.trellis import bake as jbake
from labelany3d_tpu.models.trellis import decoders as jdec
from labelany3d_tpu.ops import attention as jatt
from labelany3d_tpu.ops import marching_cubes as jmc
from labelany3d_tpu.ops import morton as jmorton
from labelany3d_tpu.ops import sparse_conv as jsc
from labelany3d_tpu.ops import splat as jsplat
from labelany3d_tpu_torch.data import meshio
from labelany3d_tpu_torch.models.layers import resize_bilinear_8bit
from labelany3d_tpu_torch.models.trellis import bake
from labelany3d_tpu_torch.models.trellis import decoders as tdec
from labelany3d_tpu_torch.ops import attention as tatt
from labelany3d_tpu_torch.ops import marching_cubes as tmc
from labelany3d_tpu_torch.ops import morton
from labelany3d_tpu_torch.ops import sparse_conv as tsc
from labelany3d_tpu_torch.ops import splat

RTOL = ATOL = 1e-5
LEVEL_TOL = 1
EQUAL_SHARE = 0.99


def _t(a):
    return torch.from_numpy(np.asarray(a))


def voxels(n_valid: int, n: int, grid: int, seed: int):
    """`n` slots whose first `n_valid` hold distinct voxels of a `grid`^3
    grid (a blob, so neighbourhoods are populated), the rest garbage."""
    rng = np.random.default_rng(seed)
    c = grid // 2
    cells = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"), -1).reshape(-1, 3)
    d = np.linalg.norm(cells - c + rng.normal(0, 0.3, cells.shape), axis=-1)
    pick = cells[np.argsort(d)[:n_valid]]
    rng.shuffle(pick)
    coords = rng.integers(0, grid, (n, 3)).astype(np.int32)
    coords[:n_valid] = pick
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return coords, valid


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
def test_space_filling_codes_match_jax(curve):
    c = np.random.default_rng(0).integers(0, 1024, (4096, 3)).astype(np.int32)
    enc = {"morton": (jmorton.morton_encode_3d, morton.morton_encode_3d,
                      morton.morton_decode_3d),
           "hilbert": (jmorton.hilbert_encode_3d, morton.hilbert_encode_3d,
                       morton.hilbert_decode_3d)}[curve]
    want = np.asarray(enc[0](jnp.asarray(c)))
    got = enc[1](_t(c))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(enc[2](got).numpy(), c)


@pytest.mark.parametrize("cin,cout", [(8, 12), (16, 4)])  # gather-first, matmul-first
def test_subm_sparse_conv3d_matches_jax(cin, cout):
    coords, valid = voxels(150, 200, 12, seed=cin)
    rng = np.random.default_rng(1)
    f = rng.standard_normal((200, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jax.jit(lambda *a: jsc.subm_sparse_conv3d(*a, grid_size=12))(f, coords, valid, w, b)
    got = tsc.subm_sparse_conv3d(_t(f), _t(coords), _t(valid), _t(w), _t(b), grid_size=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got[~_t(valid)].any()


def test_sparse_pooling_matches_jax():
    coords, valid = voxels(300, 384, 16, seed=3)
    f = np.random.default_rng(2).standard_normal((384, 6)).astype(np.float32)
    want = jax.jit(lambda *a: jsc.sparse_pool_pair(*a, 2, 16))(f, coords, valid)
    got = tsc.sparse_pool_pair(_t(f), _t(coords), _t(valid), 2, 16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = int(got[2].sum()) + 3  # a torso slice that keeps every parent
    np.testing.assert_array_equal(
        tsc.sparse_unpool(got[0][:m], got[3]).numpy(),
        np.asarray(jsc.sparse_unpool(want[0][:m], want[3])))
    np.testing.assert_array_equal(  # under-budgeted: lost parents unpool to 0
        tsc.sparse_unpool(got[0][:20], got[3]).numpy(),
        np.asarray(jsc.sparse_unpool(want[0][:20], want[3])))
    wd = jsc.sparse_downsample(jnp.asarray(f), jnp.asarray(coords), jnp.asarray(valid))
    gd = tsc.sparse_downsample(_t(f), _t(coords), _t(valid))
    np.testing.assert_allclose(gd[0].numpy(), np.asarray(wd[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gd[1].numpy(), np.asarray(wd[1]))
    np.testing.assert_array_equal(gd[2].numpy(), np.asarray(wd[2]))


@pytest.mark.parametrize("shift,max_per_window", [(0, 512), (2, 512), (2, 24)])
def test_windowed_attention_matches_jax(shift, max_per_window):
    # 24 slots a window: the blob's central windows overflow, and their
    # overflow voxels pass v through.
    coords, valid = voxels(300, 340, 16, seed=4)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((340, 2, 8)).astype(np.float32) for _ in range(3))
    want = jax.jit(lambda *a: jatt.windowed_attention_3d(
        *a, grid_size=16, window_size=4, shift=shift, max_per_window=max_per_window))(
        q, k, v, coords, valid)
    got = tatt.windowed_attention_3d(*map(_t, (q, k, v, coords, valid)), grid_size=16,
                                     window_size=4, shift=shift, max_per_window=max_per_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if max_per_window == 24:
        assert (np.abs(got.numpy() - v).max(axis=(1, 2)) == 0)[valid].sum() > 10


@pytest.mark.parametrize("shift,curve", [(0, "z_order"), (37, "hilbert")])
def test_serialized_attention_matches_jax(shift, curve):
    coords, valid = voxels(200, 300, 16, seed=6)
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((300, 2, 8)).astype(np.float32) for _ in range(3))
    want = jax.jit(lambda *a: jatt.serialized_attention(
        *a, window_size=64, shift=shift, curve=curve))(q, k, v, coords, valid)
    got = tatt.serialized_attention(*map(_t, (q, k, v, coords, valid)), window_size=64,
                                    shift=shift, curve=curve)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_marching_cubes_matches_jax():
    x = np.linspace(-1, 1, 11)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    f = (X ** 2 + 0.7 * Y ** 2 + Z ** 2 - 0.5).astype(np.float32)
    tris, ok = tmc.marching_cubes(_t(f))
    jtris, jok = jax.jit(jmc.marching_cubes)(f)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tris.numpy(), np.asarray(jtris), atol=1e-6)
    assert ok.sum() > 100


def gaussians(n: int, seed: int, sphere: float = 0.0):
    """`n` random Gaussians in [0.3, 0.7]^3, or on the sphere of radius
    `sphere` about (0.5, 0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    if sphere:
        d = rng.standard_normal((n, 3))
        means = (0.5 + sphere * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    scales = rng.uniform(0.005, 0.03, (n, 3)).astype(np.float32)
    rots = rng.standard_normal((n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    op = rng.uniform(0.2, 1.0, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, rots, op, cols


def test_rasterize_gaussians_matches_jax():
    from labelany3d_tpu_torch.registration.cameras import opencv_orbit_pose

    g = gaussians(400, 8)
    R, t = opencv_orbit_pose(20.0, 30.0, 2.0, target=np.full(3, 0.5))
    K = np.array([[76.8, 0, 32], [0, 76.8, 32], [0, 0, 1]], np.float32)
    want = jax.jit(lambda *a: jsplat.rasterize_gaussians(*a, (64, 64), gaussians_per_tile=64))(
        *g, R, t, K)
    got = splat.rasterize_gaussians(*map(_t, (*g, R, t, K)), (64, 64), gaussians_per_tile=64)
    assert float(got.alpha.max()) > 0.5
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def fc_features(m: int, seed: int, res: int = 16):
    """FlexiCubes features of `m` voxels around a sphere of a `res` grid."""
    coords, valid = voxels(m, m + 30, res, seed)
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 0.3, (m + 30, 101)).astype(np.float32)
    corner = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                       [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])
    pos = (coords[:, None, :] + corner[None]) / res - 0.5
    feats[:, :8] = np.linalg.norm(pos, axis=-1) - 0.3
    return feats, coords, valid, res


def test_flexicubes_to_mesh_matches_jax():
    args = fc_features(500, 9)
    got = tdec.flexicubes_to_mesh(*args)
    want = jdec.flexicubes_to_mesh(*args)
    assert len(got[1]) > 100
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    empty = tdec.flexicubes_to_mesh(args[0], args[1], np.zeros_like(args[2]), 16)
    assert [e.shape for e in empty] == [(0, 3)] * 3


@pytest.fixture(scope="module")
def baked():
    """A flexicubes mesh (object frame [0, 1]^3) baked by both packages."""
    v, f, _ = tdec.flexicubes_to_mesh(*fc_features(400, 10))
    g = gaussians(1500, 11, sphere=0.3)
    gs = tdec.GaussianSet(*map(_t, g), valid=torch.ones(1500, dtype=torch.bool))
    jgs = jdec.GaussianSet(*map(jnp.asarray, g), valid=jnp.ones(1500, bool))
    got = bake.bake_texture(meshio.Mesh(v + 0.5, f), gs, texture_size=64, num_views=4,
                            image_size=64)
    want = jbake.bake_texture(jmeshio.Mesh(v + 0.5, f), jgs, texture_size=64, num_views=4,
                              image_size=64)
    return got, want


def test_bake_texture_matches_jax(baked):
    got, want = baked
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.uv, want.uv)
    assert np.abs(got.texture.astype(int) - want.texture).max() <= LEVEL_TOL
    assert len(np.unique(got.texture.reshape(-1, 3), axis=0)) > 10  # a bake, not a fill
    np.testing.assert_allclose(got.colors, want.colors, atol=LEVEL_TOL / 255 + 1e-6)


def test_bake_vertex_colors_matches_jax():
    v, f, _ = tdec.flexicubes_to_mesh(*fc_features(300, 12))
    g = gaussians(1000, 13, sphere=0.3)
    got = bake.bake_vertex_colors(meshio.Mesh(v + 0.5, f), tdec.GaussianSet(
        *map(_t, g), valid=torch.ones(1000, dtype=torch.bool)), num_views=4, image_size=64)
    want = jbake.bake_vertex_colors(jmeshio.Mesh(v + 0.5, f), jdec.GaussianSet(
        *map(jnp.asarray, g), valid=jnp.ones(1000, bool)), num_views=4, image_size=64)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_textured_glb_roundtrip(tmp_path, baked):
    mesh = baked[0]
    meshio.save_glb(tmp_path / "t.glb", mesh)
    for load in (meshio.load_glb, jmeshio.load_glb):
        back = load(tmp_path / "t.glb")
        np.testing.assert_array_equal(back.faces, mesh.faces)
        np.testing.assert_array_equal(back.vertices, mesh.vertices)
        np.testing.assert_array_equal(back.texture, mesh.texture)
        np.testing.assert_array_equal(back.uv, mesh.uv)
        np.testing.assert_allclose(back.colors, mesh.colors)
    # Without COLOR_0 both readers sample the vertex colours from the texture.
    mesh.colors = None
    jmeshio.save_glb(tmp_path / "j.glb", jmeshio.Mesh(mesh.vertices, mesh.faces, uv=mesh.uv,
                                                      texture=mesh.texture))
    meshio.save_glb(tmp_path / "p.glb", mesh)
    got, want = meshio.load_glb(tmp_path / "j.glb"), jmeshio.load_glb(tmp_path / "p.glb")
    np.testing.assert_array_equal(got.colors, want.colors)
    np.testing.assert_array_equal(got.texture, want.texture)


def test_empty_glb_roundtrip_like_jax(tmp_path):
    """TRELLIS with its zero-initialised decoders gives empty meshes; both
    packages write them and read them back the same way."""
    empty = meshio.Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    meshio.save_glb(tmp_path / "p.glb", empty)
    jmeshio.save_glb(tmp_path / "j.glb", jmeshio.Mesh(empty.vertices, empty.faces))
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    for load in (meshio.load_glb, jmeshio.load_glb):
        back = load(tmp_path / "p.glb")
        assert back.vertices.shape == (0, 3) and back.faces.shape == (0, 3) and back.is_empty


@pytest.mark.parametrize("hw", [(300, 170), (20, 31), (700, 700)])
def test_bilinear_preprocess_matches_pillow(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    img[: hw[0] // 3] = 255
    want = np.asarray(Image.fromarray(img).resize((518, 518), Image.BILINEAR))
    got = resize_bilinear_8bit(_t(img).permute(2, 0, 1)[None], (518, 518))
    got = got[0].permute(1, 2, 0).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= LEVEL_TOL and (diff == 0).mean() >= EQUAL_SHARE
