"""The port's Hunyuan3D mvd_std multi-view diffusion against the JAX
package, on the CPU in float32.

  * `MVDTransformer` in the plain, write and read modes, and `MVDUNet` plain
    and in a write -> read reference round (two transformer blocks at the
    attention level, so the read pass must pop the recorded tokens in
    order), with the JAX package's parameters: relative 1e-5, absolute
    1e-5 (float32, sums reordered);
  * `euler_ancestral_schedule` for the three spacings (the same float64
    numpy, equal) and `euler_ancestral_step` (1e-6);
  * `MVDUNetConfig.from_hf_json`, `convert_mvd` of a `TMVDUNet` state (the
    JAX converter's tree, and the port against the replica at the JAX
    test's 5e-4: the replica's GEGLU is exact erf, Flax's tanh, ROADMAP.md
    F11), `CLIPVisionConfig.bigg14()`'s shapes (on the meta device);
  * `MVDStdViews.generate_views` at `tiny` with the JAX package's weights
    and `jax.random` draws: 8-bit views within one level (the condition
    image's resize is Pillow's in the JAX package, the port's within one
    level of it), and the float grid before its 8-bit step within 2 levels
    of the JAX views.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import clip as jclip
from labelany3d_tpu.models.diffusion import mvd as jm
from labelany3d_tpu.models.diffusion import vae as jvae
from labelany3d_tpu_torch.models.diffusion import mvd as tm
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


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(module, tree):
    module.load_state_dict(flax_to_state_dict(tree, module))
    return module.eval()


JCFG = jm.MVDUNetConfig.tiny_test()
TCFG = tm.MVDUNetConfig.tiny_test()


@pytest.fixture(scope="module")
def unet_params():
    lat = np.zeros((1, 12, 8, 4), np.float32)
    return random_flax_params(jm.MVDUNet(JCFG).init, lat, np.zeros(1, np.float32),
                              np.zeros((1, 4, JCFG.context_dim), np.float32),
                              np.zeros((1, JCFG.pooled_dim), np.float32),
                              np.zeros((1, 6), np.float32), seed=1)


def test_mvd_transformer_modes_match_jax():
    """Plain, write (records each block's normed tokens) and read (attends
    over [own | recorded]) at depth 2; the read input has another size."""
    c, depth = 16, 2
    jt = jm.MVDTransformer(depth, 8, 12, jnp.float32)
    x, xr = _rand(2, 2, 4, 6, c), _rand(3, 2, 3, 5, c)
    ctx = _rand(4, 2, 5, 12)
    p = random_flax_params(lambda k, a, b: jt.init(k, a, b, "plain", []), x, ctx, seed=5)
    tt = _port(tm.MVDTransformer(c, depth, 8, 12, torch.float32), p)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    with torch.no_grad():
        got = tt(nchw(x), torch.from_numpy(ctx), "plain", []).permute(0, 2, 3, 1)
        close(got, jt.apply({"params": p}, x, ctx, "plain", []))
        jrefs, trefs = [], []
        want_w = jt.apply({"params": p}, x, ctx, "write", jrefs)
        got_w = tt(nchw(x), torch.from_numpy(ctx), "write", trefs).permute(0, 2, 3, 1)
        close(got_w, want_w)
        assert len(trefs) == len(jrefs) == depth
        for a, b in zip(trefs, jrefs):
            close(a, b)
        want_r = jt.apply({"params": p}, xr, ctx, "read", list(jrefs))
        got_r = tt(nchw(xr), torch.from_numpy(ctx), "read", list(trefs)).permute(0, 2, 3, 1)
        close(got_r, want_r)
        # Read order matters: swapped records give another result.
        swapped = tt(nchw(xr), torch.from_numpy(ctx), "read", trefs[::-1]).permute(0, 2, 3, 1)
        assert not np.allclose(swapped.numpy(), np.asarray(want_r), atol=1e-3)


def _unet_args(seed, b=2):
    t = np.array([0.537, 0.221][:b], np.float32)
    ctx = _rand(seed, b, 5, JCFG.context_dim)
    pooled = _rand(seed + 1, b, JCFG.pooled_dim)
    tids = np.tile(np.array([[48.0, 32.0, 0.0, 0.0, 48.0, 32.0]], np.float32), (b, 1))
    return t, ctx, pooled, tids


def test_mvd_unet_plain_matches_jax(unet_params):
    x = _rand(10, 2, 12, 8, 4)
    args = _unet_args(11)
    want, wr = jm.MVDUNet(JCFG).apply({"params": unet_params}, x, *args)
    with torch.no_grad():
        got, gr = _port(tm.MVDUNet(TCFG), unet_params)(torch.from_numpy(x),
                                                         *map(torch.from_numpy, args))
    assert wr == [] and gr == []
    assert got.shape == (2, 12, 8, 4) and got.dtype == torch.float32
    close(got, want)


def test_mvd_unet_reference_round_matches_jax(unet_params):
    """Write over the reference latent (8x8), read over the grid latent
    (12x8): the recorded tokens and the read output."""
    cond, x = _rand(12, 2, 8, 8, 4), _rand(13, 2, 12, 8, 4)
    args = _unet_args(14)
    jmod = jm.MVDUNet(JCFG)
    _, jrefs = jmod.apply({"params": unet_params}, cond, *args, mode="write")
    want, _ = jmod.apply({"params": unet_params}, x, *args, mode="read", refs=jrefs)
    tmod = _port(tm.MVDUNet(TCFG), unet_params)
    targs = tuple(map(torch.from_numpy, args))
    with torch.no_grad():
        _, trefs = tmod(torch.from_numpy(cond), *targs, mode="write")
        got, rest = tmod(torch.from_numpy(x), *targs, mode="read", refs=trefs)
    # down1 (1 transformer), mid, up1 (2): 4 transformers of depth 2.
    assert len(trefs) == len(jrefs) == 8 and rest == []
    for a, b in zip(trefs, jrefs):
        close(a, b)
    close(got, want)


@pytest.mark.parametrize("spacing", ["trailing", "linspace", "leading"])
def test_euler_ancestral_schedule_matches_jax(spacing):
    for steps in (50, 3):
        ts_, sig = tm.euler_ancestral_schedule(steps, timestep_spacing=spacing)
        jts, jsig = jm.euler_ancestral_schedule(steps, timestep_spacing=spacing)
        assert ts_.dtype == sig.dtype == np.float32
        np.testing.assert_array_equal(ts_, jts)
        np.testing.assert_array_equal(sig, jsig)
        assert sig[-1] == 0.0 and len(sig) == steps + 1


def test_euler_ancestral_step_matches_jax():
    x, eps, noise = _rand(20, 1, 6, 4, 4), _rand(21, 1, 6, 4, 4), _rand(22, 1, 6, 4, 4)
    _, sig = jm.euler_ancestral_schedule(5)
    for i in range(5):
        want = jm.euler_ancestral_step(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(sig[i]),
                                       jnp.asarray(sig[i + 1]), jnp.asarray(noise))
        got = tm.euler_ancestral_step(torch.from_numpy(x), torch.from_numpy(eps), sig[i],
                                      sig[i + 1], torch.from_numpy(noise))
        close(got, want, atol=1e-6)


def test_mvd_unet_config_from_hf_json():
    hf = {"block_out_channels": [320, 640, 1280],
          "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
          "transformer_layers_per_block": [1, 2, 10], "attention_head_dim": [5, 10, 20],
          "layers_per_block": 2, "cross_attention_dim": 2048,
          "projection_class_embeddings_input_dim": 2816, "addition_time_embed_dim": 256,
          "in_channels": 4, "out_channels": 4}
    for cfg in (hf, dict(hf, transformer_layers_per_block=3, attention_head_dim=64)):
        got, want = tm.MVDUNetConfig.from_hf_json(cfg), jm.MVDUNetConfig.from_hf_json(cfg)
        assert {f: getattr(got, f) for f in ("widths", "attn_levels", "transformer_depth",
                                             "head_dim", "pooled_dim", "context_dim",
                                             "num_res_blocks", "addition_time_embed_dim")} == \
            {f: getattr(want, f) for f in ("widths", "attn_levels", "transformer_depth",
                                           "head_dim", "pooled_dim", "context_dim",
                                           "num_res_blocks", "addition_time_embed_dim")}
    assert tm.MVDUNetConfig.from_hf_json(hf).head_dim == 64


def test_convert_mvd_matches_jax_and_the_replica():
    """A diffusers-named SDXL state of the torch replica: the port's
    `convert_mvd` gives the JAX converter's trees, and the port's `MVDUNet`
    from them follows the replica through a reference round."""
    from labelany3d_tpu.models.diffusion.convert import convert_mvd as jconvert
    from labelany3d_tpu_torch.models.diffusion.convert import convert_mvd
    from tests.test_mvd_convert import CFG, TMVDUNet, _state_numpy

    torch.manual_seed(0)
    rep = TMVDUNet(CFG).eval()
    state = _state_numpy(rep)
    extras = dict(uc_text_emb=np.zeros((1, 7, CFG.context_dim)),
                  uc_text_emb_2=np.ones((1, CFG.pooled_dim)),
                  ramping_coefficients=np.linspace(0, 1, 7))
    got = convert_mvd(state, unet_cfg=TCFG, **extras)
    want = jconvert(state, unet_cfg=CFG, **extras)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert got["uc_text_emb"].dtype == np.float32
    cond, x = _rand(30, 2, 8, 8, 4), _rand(31, 2, 12, 8, 4)
    t, ctx, pooled, tids = _unet_args(32)
    tmod = _port(tm.MVDUNet(TCFG), got["unet"])
    with torch.no_grad():
        targs = (torch.from_numpy(t * 1000.0), torch.from_numpy(ctx), torch.from_numpy(pooled),
                 torch.from_numpy(tids))
        _, rrefs = rep(torch.from_numpy(cond).permute(0, 3, 1, 2), *targs, mode="w")
        ref, _ = rep(torch.from_numpy(x).permute(0, 3, 1, 2), *targs, mode="r", refs=rrefs)
        pargs = (torch.from_numpy(t),) + targs[1:]
        _, prefs = tmod(torch.from_numpy(cond), *pargs, mode="write")
        out, _ = tmod(torch.from_numpy(x), *pargs, mode="read", refs=prefs)
    close(out, ref.permute(0, 2, 3, 1).numpy(), rtol=5e-4, atol=5e-4)


def test_bigg14_config_shapes():
    """ViT-bigG/14: width 1664, depth 48, 16 heads, MLP 8192, exact GELU,
    projection 1280; the parameters of the JAX tree's shapes (built on
    the meta device: 1.84 G parameters)."""
    from labelany3d_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionEncoder

    cfg, jcfg = CLIPVisionConfig.bigg14(), jclip.CLIPVisionConfig.bigg14()
    for f in ("image_size", "patch_size", "width", "depth", "num_heads", "mlp_ratio",
              "projection_dim", "hidden_act"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    with torch.device("meta"):
        m = CLIPVisionEncoder(cfg)
    shapes = jax.eval_shape(lambda: jclip.CLIPVisionEncoder(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert tuple(m.layer47.fc1.weight.shape) == (8192, 1664)
    assert tuple(m.visual_projection.weight.shape) == (1280, 1664)
    assert 1.8e9 < sum(p.numel() for p in m.parameters()) < 1.9e9


# ---------------------------------------------------------------- the pipeline


def _f32_jax_views():
    """The JAX tiny pipeline with every component in float32 (its tiny VAE
    and CLIP configs say bf16)."""
    jp = jm.MVDStdViews(tiny=True)
    f32 = jnp.float32
    jp.vae = jvae.AutoencoderKL(dataclasses.replace(jp.vae.cfg, dtype=f32), seed=0,
                                scaling_factor=jm.SDXL_LATENT_SCALE)
    jp.vision_cfgs = tuple(dataclasses.replace(c, dtype=f32) for c in jp.vision_cfgs)
    jp.vision = tuple(jclip.CLIPVisionEncoder(c) for c in jp.vision_cfgs)
    return jp


def mvd_trees(jp, seed=40):
    """Seeded trees of the JAX tiny pipeline's shapes, by component."""
    u = jp.unet_cfg
    lf = 2 ** (len(jp.vae.cfg.widths) - 1)
    cs = jp.cfg.cond_size
    rng = np.random.default_rng(seed)
    vs = [c.image_size for c in jp.vision_cfgs]
    return {
        "unet": random_flax_params(jp.unet.init, np.zeros((1, 24, 16, 4), np.float32),
                                   np.zeros(1, np.float32),
                                   np.zeros((1, 4, u.context_dim), np.float32),
                                   np.zeros((1, u.pooled_dim), np.float32),
                                   np.zeros((1, 6), np.float32), seed=seed),
        "vae": {"encoder": random_flax_params(jp.vae.encoder.init,
                                              np.zeros((1, cs, cs, 3), np.float32),
                                              seed=seed + 1),
                "decoder": random_flax_params(jp.vae.decoder.init,
                                              np.zeros((1, cs // lf, cs // lf, 4), np.float32),
                                              seed=seed + 2)},
        "vision": random_flax_params(jp.vision[0].init,
                                     np.zeros((1, vs[0], vs[0], 3), np.float32), seed=seed + 3),
        "vision_2": random_flax_params(jp.vision[1].init,
                                       np.zeros((1, vs[1], vs[1], 3), np.float32), seed=seed + 4),
        "uc_text_emb": rng.standard_normal((1, 77, u.context_dim)).astype(np.float32),
        "uc_text_emb_2": rng.standard_normal((1, u.pooled_dim)).astype(np.float32),
        "ramping_coefficients": np.linspace(0, 1, 77).astype(np.float32),
    }


def jax_mvd_draws(tp, seed):
    """What `labelany3d_tpu`'s `generate_views(rgba, seed)` draws: the
    latent, the posterior noise, then each step's reference and ancestral
    noise from the same key splits."""
    sh = tp.draw_shapes()
    k_lat, k_cond, k = jax.random.split(jax.random.PRNGKey(seed), 3)
    refs, ancs = [], []
    for _ in range(tp.cfg.steps):
        k, k_ref, k_anc = jax.random.split(k, 3)
        refs.append(np.asarray(jax.random.normal(k_ref, sh["ref"][1:])))
        ancs.append(np.asarray(jax.random.normal(k_anc, sh["anc"][1:])))
    return {"latent": np.asarray(jax.random.normal(k_lat, sh["latent"])),
            "cond": np.asarray(jax.random.normal(k_cond, sh["cond"])),
            "ref": np.stack(refs), "anc": np.stack(ancs)}


@pytest.fixture(scope="module")
def views_pair():
    jp = _f32_jax_views()
    trees = mvd_trees(jp)
    jp.set_params(trees)
    tp = tm.MVDStdViews(tiny=True, device="cpu", dtype=torch.float32).set_params(trees)
    return jp, tp


def test_generate_views_matches_jax(views_pair):
    jp, tp = views_pair
    rgba = np.random.default_rng(41).integers(0, 256, (40, 36, 4)).astype(np.uint8)
    want = jp.generate_views(rgba, seed=3)
    noise = jax_mvd_draws(tp, 3)
    got = tp.generate_views(rgba, noise=noise)
    assert len(got) == 6 and all(v.shape == (16, 16, 3) and v.dtype == np.uint8 for v in got)
    for g, w in zip(got, want):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    assert np.stack(got).std() > 8.0  # the views have content
    # The float grid before the 8-bit step.
    grid = tp.generate_grid(rgba, noise=noise).numpy()
    tiles = [grid[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] for r in range(3) for c in range(2)]
    for i, w in zip(jm.MVDStdViews.ORDER, want):
        assert np.abs(tiles[i] * 255 - w).max() <= 2.0
    # The novel_views protocol: one cached run (seed 0), tiles by azimuth.
    own = tp.generate_views(rgba, seed=0)
    for azim, i in ((120.0, 2), (300.0, 5), (0.0, 0)):
        assert np.array_equal(tp.generate(rgba, 0.0, azim), own[i])
    assert len(tp._cache) == 1


def test_generate_views_draws_from_its_seed(views_pair):
    """Without draws, a torch generator seeded with `seed`: the same seed
    the same views, another seed others; a draw given replaces its own."""
    _, tp = views_pair
    rgba = np.random.default_rng(42).integers(0, 256, (24, 24, 3)).astype(np.uint8)
    a, b = tp.generate_grid(rgba, seed=1), tp.generate_grid(rgba, seed=1)
    assert torch.equal(a, b) and not torch.equal(a, tp.generate_grid(rgba, seed=2))
    lat = torch.zeros(tp.draw_shapes()["latent"])
    assert not torch.equal(tp.generate_grid(rgba, seed=1, noise={"latent": lat}), a)
