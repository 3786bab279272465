"""The port's SVRM reconstructor and its ops against the JAX package, on the
CPU in float32.

  * `ops/sampling.py` (`grid_sample` with out-of-range points and both
    `align_corners`, `deformable_sample`), `ops/knn.py` and
    `marching_cubes_mesh` against their JAX functions: 1e-5 absolute (the
    same float32 arithmetic in another order; the mesh compaction exact);
  * the positional-grid resize, 37 -> 36 bicubic without antialias, against
    `jax.image.resize`: 1e-5 (a float32 weight matrix per axis);
  * `AdaNorm`, `CamModViT` (at `tiny_test` and at a tiny config whose
    position grid is resized), `_LRMBlock`, `SVRM`, `TriplaneField` and
    `grid` with the JAX package's parameters (seeded trees of its shapes):
    relative 1e-5 and 1e-5 absolute (float32, sums reordered);
  * `convert_svrm` of a `tests/svrm_replica.py` state: the same tree as the
    JAX converter's, and the port loaded from it against the replica;
  * `camera_vector`, and `mesh_from_lattice`'s conventions on the handcrafted
    cylinder field of `tests/test_svrm.py`;
  * `SVRMReconstruction.reconstruct` at `tiny_test` with a stub view source
    against the JAX backend on the same weights: the same views, cameras
    and lattice (1e-5), and the same surface (`same_surface`: the mesh
    compaction rounds vertices at 1e-5 grid units, so lattices 1e-6 apart
    may merge a few vertices differently; on one lattice the meshes are
    equal): face counts within 0.5%, 99.5% of the vertices within 1e-3 of
    the JAX mesh's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import svrm as js
from labelany3d_tpu_torch.models import svrm as ts
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.torch_parity import random_flax_params

ATOL = 1e-5
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    from labelany3d_tpu.ops.sampling import grid_sample as jgs
    from labelany3d_tpu_torch.ops.sampling import grid_sample

    rng = _rng(1)
    img = rng.standard_normal((9, 13, 5)).astype(np.float32)
    # Inside, on the border, and well outside [-1, 1] (zero padding).
    grid = rng.uniform(-1.6, 1.6, (4, 7, 2)).astype(np.float32)
    grid[0, :3] = [[-1, -1], [1, 1], [-3, 0.2]]
    want = jgs(jnp.asarray(img), jnp.asarray(grid), align_corners=align_corners)
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid), align_corners)
    assert got.shape == (4, 7, 5)
    close(got, want)


def test_deformable_sample_matches_jax():
    from labelany3d_tpu.ops.sampling import deformable_sample as jds
    from labelany3d_tpu_torch.ops.sampling import deformable_sample

    rng = _rng(2)
    levels = [rng.standard_normal((h, w, 6)).astype(np.float32) for h, w in ((8, 10), (4, 5))]
    loc = rng.uniform(-0.1, 1.1, (11, 2, 3, 2)).astype(np.float32)
    wts = rng.uniform(0, 1, (11, 2, 3)).astype(np.float32)
    want = jds([jnp.asarray(v) for v in levels], jnp.asarray(loc), jnp.asarray(wts))
    got = deformable_sample([torch.from_numpy(v) for v in levels], torch.from_numpy(loc),
                            torch.from_numpy(wts))
    close(got, want)


def test_knn_distances_matches_jax():
    from labelany3d_tpu.ops.knn import knn_distances as jknn
    from labelany3d_tpu.ops.knn import mean_knn_distance as jmean
    from labelany3d_tpu_torch.ops.knn import knn_distances, mean_knn_distance

    pts = _rng(3).standard_normal((300, 3)).astype(np.float32)
    # Tiles smaller than the cloud: the self-exclusion crosses tile edges.
    close(knn_distances(torch.from_numpy(pts), 3, tile=128), jknn(jnp.asarray(pts), 3, tile=128),
          atol=1e-5)
    close(mean_knn_distance(torch.from_numpy(pts)), jmean(jnp.asarray(pts)), atol=1e-5)


def test_marching_cubes_mesh_matches_jax_on_a_sphere():
    from labelany3d_tpu.ops.marching_cubes import marching_cubes_mesh as jmc
    from labelany3d_tpu_torch.ops.marching_cubes import marching_cubes_mesh

    g = np.linspace(-1, 1, 21, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    field = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6
    want_v, want_f = jmc(field)
    got_v, got_f = marching_cubes_mesh(torch.from_numpy(field))
    assert got_v.dtype == np.float32 and got_f.dtype == np.int32
    assert len(got_v) > 100
    np.testing.assert_array_equal(got_f, want_f)
    close(got_v, want_v, atol=1e-5)
    # Every vertex lies on the sphere (radius 0.6 = 6 grid units).
    r = np.linalg.norm(got_v - 10.0, axis=-1)
    assert np.abs(r - 6.0).max() < 0.5
    empty_v, empty_f = marching_cubes_mesh(np.ones((4, 4, 4), np.float32))
    assert empty_v.shape == (0, 3) and empty_f.shape == (0, 3)


def test_position_grid_resize_matches_jax():
    """dinov2's 37^2 grid to SVRM's 36^2 patch grid: bicubic (a = -0.5),
    no antialias, as `jax.image.resize(..., 'bicubic', antialias=False)`."""
    from labelany3d_tpu_torch.models.layers import resize

    pos = _rng(4).standard_normal((1, 37, 37, 8)).astype(np.float32)
    for hw in ((36, 36), (40, 29)):
        want = jax.image.resize(jnp.asarray(pos), (1, *hw, 8), method="bicubic",
                                antialias=False)
        got = resize(torch.from_numpy(pos).permute(0, 3, 1, 2), hw, method="bicubic",
                     antialias=False).permute(0, 2, 3, 1)
        close(got, want)


# ---------------------------------------------------------------- modules


def _cfgs(**kw):
    return (dataclasses.replace(js.SVRMConfig.tiny_test(dtype=jnp.float32), **kw),
            dataclasses.replace(ts.SVRMConfig.tiny_test(dtype=torch.float32), **kw))


def _inputs(cfg, seed=0):
    rng = _rng(seed)
    views = rng.standard_normal((1, cfg.num_views, cfg.image_size, cfg.image_size, 3))
    cams = rng.standard_normal((1, cfg.num_views, cfg.cam_dim))
    return views.astype(np.float32), cams.astype(np.float32)


_PARAMS: dict = {}


def svrm_params(jcfg, seed=1):
    """A seeded tree of the JAX `SVRM`'s shapes (every submodule, the field
    included), traced once per config."""
    key = (dataclasses.astuple(jcfg), seed)
    if key not in _PARAMS:
        views, cams = _inputs(jcfg)
        _PARAMS[key] = random_flax_params(
            lambda k, v, c: js.SVRM(jcfg).init(k, v, c, method=js.SVRM.init_all), views, cams,
            seed=seed)
    return _PARAMS[key]


def _port(module, tree):
    module.load_state_dict(flax_to_state_dict(tree, module))
    return module.eval()


def test_adanorm_matches_jax():
    rng = _rng(5)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    c = rng.standard_normal((2, 16)).astype(np.float32)
    p = random_flax_params(js.AdaNorm(16).init, x, c, seed=6)
    want = js.AdaNorm(16).apply({"params": p}, x, c)
    with torch.no_grad():
        got = _port(ts.AdaNorm(16), p)(torch.from_numpy(x), torch.from_numpy(c))
    close(got, want)


@pytest.mark.parametrize("pos_grid", [4, 5])
def test_cam_mod_vit_matches_jax(pos_grid):
    """At `tiny_test` (a 4^2 position grid on a 4^2 patch grid) and with a
    5^2 grid resized to the 4^2 patches."""
    jcfg, tcfg = _cfgs(enc_pos_grid=pos_grid)
    views, cams = _inputs(jcfg, 7)
    p = svrm_params(jcfg)["encoder"]
    want = js.CamModViT(jcfg).apply({"params": p}, views[0], cams[0])
    with torch.no_grad():
        got = _port(ts.CamModViT(tcfg), p)(torch.from_numpy(views[0]), torch.from_numpy(cams[0]))
    assert got.shape == (jcfg.num_views, 1 + 16, jcfg.enc_width)
    close(got, want)


def test_lrm_block_matches_jax():
    jcfg, tcfg = _cfgs()
    rng = _rng(8)
    x = rng.standard_normal((1, 3 * jcfg.plane_size ** 2, jcfg.token_dim)).astype(np.float32)
    ctx = rng.standard_normal((1, 19, jcfg.context_dim)).astype(np.float32)
    p = svrm_params(jcfg)["block1"]
    want = js._LRMBlock(jcfg).apply({"params": p}, x, ctx)
    with torch.no_grad():
        got = _port(ts._LRMBlock(tcfg), p)(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got, want)


@pytest.mark.parametrize("pos_grid", [4, 5])
def test_svrm_triplanes_field_and_grid_match_jax(pos_grid):
    jcfg, tcfg = _cfgs(enc_pos_grid=pos_grid)
    views, cams = _inputs(jcfg, 9)
    p = svrm_params(jcfg)
    jm = js.SVRM(jcfg)
    planes = jm.apply({"params": p}, views, cams)
    pts = _rng(10).uniform(-0.7, 0.7, (2, 5, 3)).astype(np.float32)
    q = jm.apply({"params": p}, planes[0], pts, method=js.SVRM.query)
    sdf, rgb = jm.apply({"params": p}, planes[0], method=js.SVRM.grid)
    tm = _port(ts.SVRM(tcfg), p)
    with torch.no_grad():
        got = tm(torch.from_numpy(views), torch.from_numpy(cams))
        planes_t = torch.from_numpy(np.asarray(planes[0]))
        got_q = tm.query(planes_t, torch.from_numpy(pts))
        got_sdf, got_rgb = tm.grid(planes_t)
    r = jcfg.plane_size * jcfg.upsample_ratio
    assert got.shape == (1, 3, r, r, jcfg.triplane_dim)
    close(got, planes)
    close(got_q["sdf"], q["sdf"])
    close(got_q["rgb"], q["rgb"])
    assert got_sdf.shape == (jcfg.grid_size,) * 3 and got_rgb.shape == (jcfg.grid_size,) * 3 + (3,)
    close(got_sdf, sdf)
    close(got_rgb, rgb)


def test_random_init_follows_flax():
    """Without weights: zero plane tokens and class token, LayerScale at
    its init value, N(0, 0.02) position grid."""
    cfg = ts.SVRMConfig.tiny_test()
    m = ts.init_svrm_(ts.SVRM(cfg), torch.Generator().manual_seed(0))
    assert not m.pos_emb.any() and not m.encoder.cls_token.any()
    assert (m.encoder.block0.ls1 == cfg.layerscale_init).all()
    assert 0.005 < float(m.encoder.pos_embed.std()) < 0.05


# ---------------------------------------------------------------- conversion


def test_convert_svrm_matches_jax_and_the_replica():
    """A `svrm.safetensors`-named state of the torch replica: the port's
    converter gives the JAX converter's tree, and the port loaded from it
    computes the replica's triplanes and field."""
    import svrm_replica as rep

    from tests.test_svrm_convert import TINY, _replica

    tcfg = ts.SVRMConfig(**{f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)
                            if f.name not in ("dtype", "param_dtype")}, dtype=torch.float32)
    torch.manual_seed(0)
    ref_m = _replica(TINY)
    state = rep.state_np(ref_m)
    tree = ts.convert_svrm(state, tcfg)
    want_tree = js.convert_svrm(state, TINY)
    assert (jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want_tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_array_equal(a, b)
    views, cams = _inputs(TINY, 11)
    pts = (_rng(12).random((40, 3)).astype(np.float32) - 0.5) * 2 * TINY.aabb
    with torch.no_grad():
        ref = ref_m(torch.from_numpy(views.transpose(0, 1, 4, 2, 3)), torch.from_numpy(cams))
        m = _port(ts.SVRM(tcfg), tree)
        planes = m(torch.from_numpy(views), torch.from_numpy(cams))
        ref_f = ref_m.render.forward_points(ref, torch.from_numpy(pts), box_warp=TINY.box_warp)
        got_f = m.query(planes[0], torch.from_numpy(pts))
    close(planes, ref.numpy().transpose(0, 1, 3, 4, 2), rtol=1e-3, atol=2e-4)
    close(got_f["sdf"], ref_f["sdf"].numpy(), rtol=1e-3, atol=2e-4)
    close(got_f["rgb"], ref_f["rgb"].numpy(), rtol=1e-3, atol=2e-4)


# ---------------------------------------------------------------- backend


def test_camera_vector_matches_jax():
    for el, az in ((0.0, 0.0), (0.0, 120.0), (20.0, 300.0)):
        np.testing.assert_allclose(ts.SVRMReconstruction.camera_vector(el, az),
                                   js.SVRMReconstruction.camera_vector(el, az), atol=1e-7)
    np.testing.assert_allclose(ts.create_camera_to_world(10.0, 60.0),
                               js.create_camera_to_world(10.0, 60.0), atol=1e-12)


def test_mesh_from_lattice_cylinder_conventions():
    """The handcrafted field of `tests/test_svrm.py`: sdf(p) = r0 - |(x,
    y)|, positive inside. The port's extraction gives the JAX mesh, a
    z-axis cylinder whose axis is output coordinate 1 after the (y, z, x)
    permutation."""
    jcfg, tcfg = _cfgs()
    p = jax.tree_util.tree_map(np.array, svrm_params(jcfg))
    r, c, r0, shift = jcfg.plane_size * jcfg.upsample_ratio, jcfg.triplane_dim, 0.3, 0.35
    wx = ((np.arange(r) + 0.5) / r * 2 - 1) * jcfg.box_warp / 2
    gy, gx = np.meshgrid(wx, wx, indexing="ij")
    planes = np.zeros((3, r, r, c), np.float32)
    planes[0, :, :, 0] = (r0 - np.sqrt(gx ** 2 + gy ** 2)) + shift
    fp = p["field"]
    for leaf in ("kernel", "bias"):
        fp["fc0"][leaf][:] = 0
        fp["out"][leaf][:] = 0
    fp["fc0"]["kernel"][0, 0], fp["fc0"]["kernel"][0, 1] = 1.0, -1.0
    fp["out"]["kernel"][0, 0], fp["out"]["kernel"][1, 0] = 1.0, -1.0
    fp["out"]["bias"][0] = -shift
    sdf, rgb = js.SVRM(jcfg).apply({"params": p}, jnp.asarray(planes), method=js.SVRM.grid)
    want = js.SVRMReconstruction(cfg=jcfg, params=p).mesh_from_lattice(np.asarray(sdf),
                                                                        np.asarray(rgb))
    recon = ts.SVRMReconstruction(cfg=tcfg, params=p, device="cpu")
    with torch.no_grad():
        tsdf, trgb = recon._ensure().grid(torch.from_numpy(planes))
    close(tsdf, sdf)
    close(trgb, rgb)
    # The extraction itself, on the JAX lattice: the JAX mesh exactly.
    got = recon.mesh_from_lattice(torch.from_numpy(np.array(sdf)), np.array(rgb))
    assert len(got.vertices) == len(want.vertices) > 0
    np.testing.assert_array_equal(got.faces, want.faces)
    close(got.vertices, want.vertices, atol=1e-6)
    close(got.colors, want.colors, atol=1e-6)
    own = recon.mesh_from_lattice(tsdf, trgb)
    assert same_surface(own, want)
    side = own.vertices[np.abs(own.vertices[:, 1]) < jcfg.aabb * 0.8]
    assert abs(np.median(np.hypot(side[:, 2], side[:, 0])) - r0) < 0.06


def same_surface(got, want, share=0.995, tol=1e-3):
    """Meshes extracted from nearly equal lattices: the same surface, though
    the compaction's 1e-5 keys may merge a few vertices differently. Face
    counts within 1 - `share`, and `share` of the port's vertices within
    `tol` (object units; a lattice cell is 0.05 at `tiny_test`) of a JAX
    vertex."""
    if not len(got.vertices) or abs(len(got.faces) - len(want.faces)) > (1 - share) * len(
            want.faces):
        return False
    a, b = torch.from_numpy(got.vertices), torch.from_numpy(want.vertices)
    near = torch.cat([torch.cdist(a[i:i + 1024], b).min(-1).values
                      for i in range(0, len(a), 1024)])
    return bool((near <= tol).float().mean() >= share)


class _StubViews:
    """A per-view source that renders a flat colour per azimuth at the
    model's input size (no resize on either side)."""

    def __init__(self, size):
        self.size = size
        self.calls = []

    def generate(self, rgba, d_elev, d_azim, d_dist=0.0, seed=0):
        self.calls.append(d_azim)
        img = np.full((self.size, self.size, 3), 255, np.uint8)
        img[4:-4, 6:-6] = [(40 + int(d_azim)) % 256, 90, 200 - int(d_azim) // 2]
        return img


def test_reconstruct_matches_jax():
    """`reconstruct` with a stub view source (Zero123-like: the input is the
    azimuth-0 view) at `tiny_test`, the JAX backend's weights: the same
    views, cameras, lattice and mesh."""
    jcfg, tcfg = _cfgs()
    p = svrm_params(jcfg, seed=13)
    rng = _rng(14)
    crop = rng.integers(0, 256, (jcfg.image_size, jcfg.image_size, 4)).astype(np.uint8)
    crop[..., 3] = np.where(rng.random(crop.shape[:2]) > 0.3, 255, 0)
    jrec = js.SVRMReconstruction(novel_views=_StubViews(jcfg.image_size), cfg=jcfg, params=p)
    want = jrec.reconstruct(crop)
    stub = _StubViews(tcfg.image_size)
    trec = ts.SVRMReconstruction(novel_views=stub, cfg=tcfg, params=p, device="cpu")
    views, cams = trec.views(crop)
    assert stub.calls == []  # tiny_test has 2 views: the azimuth-0 orbit view is the input
    assert len(views) == tcfg.num_views
    np.testing.assert_array_equal(cams[0], js.SVRMReconstruction.camera_vector(0.0, 0.0))
    assert not cams[-1].any()
    jrec._ensure()
    x = trec.preprocess(views)
    jsdf, jrgb = jrec._jit(p, jnp.asarray(x.numpy()), jnp.asarray(cams)[None])
    sdf, rgb = trec.lattice(x, cams)
    close(sdf, jsdf)
    close(rgb, jrgb)
    got = trec.reconstruct(crop)
    assert same_surface(got, want)
    assert np.isfinite(got.vertices).all() and np.abs(got.vertices).max() <= tcfg.aabb + 1e-5


def test_preprocess_matches_pillow():
    """Views resized to the model's input as Pillow's BICUBIC resizes them
    (the JAX backend's), within one 8-bit level, then ImageNet-normalized."""
    from PIL import Image

    tcfg = ts.SVRMConfig.tiny_test(dtype=torch.float32)
    trec = ts.SVRMReconstruction(cfg=tcfg, device="cpu")
    views = [_rng(15 + i).integers(0, 256, (41, 37, 3)).astype(np.uint8) for i in range(2)]
    got = trec.preprocess(views)[0].numpy()
    mean, std = np.array(ts._IMAGENET_MEAN), np.array(ts._IMAGENET_STD)
    for g, v in zip(got, views):
        pil = np.asarray(Image.fromarray(v).resize((tcfg.image_size,) * 2, Image.BICUBIC))
        np.testing.assert_allclose(g * std + mean, pil / 255.0, atol=1 / 255 + 1e-5)
