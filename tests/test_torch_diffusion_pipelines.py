"""The port's diffusion pipelines and their stage backends against the JAX
package's, on the CPU in float32.

  * `InvSREnhance` (with and without the learned noise predictor),
    `AmodalCompletion` (with and without ISNet re-segmentation) and
    `Zero123NovelView` at `tiny=True`, 32 px and 2 steps, with the same
    parameters (seeded trees of the JAX shapes) and JAX's own draws
    (`jax.random.normal` from the key the JAX pipeline uses). Their outputs
    are 8-bit images: the port's resizes agree with Pillow's within one
    level (fixed-point sums), and a level's difference at the input moves
    the float32 pipeline's output across a rounding boundary at a few
    pixels. Tolerance: at most LEVEL_TOL levels anywhere and a mean
    difference under MEAN_TOL levels.
  * The factories and `run_stages("all")` with the three backends:
    `tests/test_torch_diffusion_route.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.models import clip as jclip
from labelany3d_tpu.models import saliency as jsal
from labelany3d_tpu.models.diffusion import noise_predictor as jnp_mod
from labelany3d_tpu.models.diffusion import pipelines as jpipe
from labelany3d_tpu.models.diffusion import unet as junet
from labelany3d_tpu.models.diffusion import vae as jvae
from labelany3d_tpu_torch.models import saliency as tsal
from labelany3d_tpu_torch.models.diffusion import pipelines as tpipe
from tests.torch_parity import fill_flax_params, flax_param_shapes, random_flax_params

SIZE = 32
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one thread: its tiny models gain nothing from
    more, and the suite's parallel workers would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LEVEL_TOL = 2      # uint8 levels
MEAN_TOL = 0.05    # mean |difference| in levels
ALPHA_SHARE = 0.01  # share of matte pixels that may flip at the 127 threshold


def _f32_jax(p):
    """The JAX pipeline's components at float32 (its configs say bf16)."""
    f32 = jnp.float32
    p.unet_cfg = dataclasses.replace(p.unet_cfg, dtype=f32)
    p.unet = junet.UNet2D(p.unet_cfg)
    p.vae_cfg = dataclasses.replace(p.vae_cfg, dtype=f32)
    p.vae = jvae.AutoencoderKL(p.vae_cfg, seed=p.seed)
    p.text = jpipe.TextConditioner(dataclasses.replace(p.text.cfg, dtype=f32), seed=p.seed)
    if isinstance(p, jpipe.Zero123NovelView):
        p.vision_cfg = dataclasses.replace(p.vision_cfg, dtype=f32)
        p.image_encoder = jclip.CLIPVisionEncoder(p.vision_cfg)
    return p


_SHAPES: dict = {}


def _shapes(key, init, *args):
    """`flax_param_shapes`, traced once a module test run for each
    component (they do not depend on the image size)."""
    if key not in _SHAPES:
        _SHAPES[key] = flax_param_shapes(init, *args)
    return _SHAPES[key]


def _trees(p, seed):
    """Seeded trees of the JAX pipeline's shapes, by component."""
    lf = p.latent_factor
    s = p.image_size // lf
    lat = np.zeros((1, s, s, p.unet_cfg.in_channels), np.float32)
    ctx = np.zeros((1, 8, p.unet_cfg.context_dim), np.float32)
    img = np.zeros((1, p.image_size, p.image_size, 3), np.float32)
    ids = np.zeros((1, p.text.cfg.max_len), np.int32)
    trees = {
        "unet": fill_flax_params(_shapes(("unet", p.unet_cfg.in_channels), p.unet.init, lat,
                                         np.zeros(1, np.float32), ctx), seed),
        "vae": {"encoder": fill_flax_params(_shapes("vae_enc", p.vae.encoder.init, img),
                                            seed + 1),
                "decoder": fill_flax_params(_shapes("vae_dec", p.vae.decoder.init,
                                                    lat[..., :4]), seed + 2)},
        "text": fill_flax_params(_shapes("text", p.text.model.init, ids), seed + 3),
    }
    if isinstance(p, jpipe.Zero123NovelView):
        vs = p.vision_cfg.image_size
        trees["vision"] = fill_flax_params(_shapes(
            "vision", p.image_encoder.init, np.zeros((1, vs, vs, 3), np.float32)), seed + 4)
        emb = p.vision_cfg.projection_dim or p.vision_cfg.width
        trees["cc"] = fill_flax_params(_shapes(
            "cc", p.cc_projection.init, np.zeros((1, emb), np.float32),
            np.zeros((1, 4), np.float32)), seed + 5)
    return trees


def _install(jp, tp, trees):
    jp.params, jp.vae.params, jp.text.params = trees["unet"], trees["vae"], trees["text"]
    if isinstance(jp, jpipe.Zero123NovelView):
        jp._enc_params, jp._cc_params = trees["vision"], trees["cc"]
    tp.set_params(trees)


def jax_draws(tp):
    """Make the port pipeline draw what the JAX pipeline draws: the standard
    normal of the same shape from `jax.random.PRNGKey(seed)`."""
    def draw(noise, shape=(), seed=0):
        if noise is None:
            noise = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))
        return torch.as_tensor(noise, dtype=torch.float32)
    tp._noise = draw
    return tp


def _pair(kind, seed=0, **kw):
    jp = _f32_jax(getattr(jpipe, kind)(tiny=True, image_size=SIZE, steps=STEPS, seed=seed, **kw))
    tp = getattr(tpipe, kind)(tiny=True, image_size=SIZE, steps=STEPS, seed=seed, device="cpu",
                              dtype=torch.float32, **kw)
    _install(jp, tp, _trees(jp, 10 * seed + 1))
    return jp, jax_draws(tp)


def _close_u8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= LEVEL_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())


def _image(seed, hw, ch):
    return np.random.default_rng(seed).integers(0, 256, hw + (ch,)).astype(np.uint8)


def isnet_params(cfg, size, seed):
    """A seeded ISNet tree whose BatchNorm variances are positive."""
    params = random_flax_params(jsal.ISNet(cfg).init, np.zeros((1, size, size, 3), np.float32),
                                seed=seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.abs(a) + 0.5 if path[-1].key == "bn_var" else a, params)


def _isnet_pair(seed=7):
    cfg = jsal.ISNetConfig.tiny_test()
    params = isnet_params(cfg, 64, seed)
    return (jsal.RembgSegmenter(cfg, params=params, input_size=64),
            tsal.RembgSegmenter(tsal.ISNetConfig.tiny_test(), params=params, input_size=64,
                                device="cpu"))


def test_invsr_noise_predictor_matches_jax():
    jp, tp = _pair("InvSREnhance", seed=2, noise_predictor=True)
    params = random_flax_params(jnp_mod.NoisePredictor(jnp_mod.NoisePredictorConfig.tiny_test())
                                .init, np.zeros((1, SIZE, SIZE, 3), np.float32),
                                np.zeros(1, np.float32), seed=21)
    jp._np_params, tp._np_params = params, params
    img = _image(1, (16, 12), 3)
    _close_u8(tp.enhance(img), jp.enhance(img))


def test_amodal_completion_with_isnet_matches_jax():
    jseg, tseg = _isnet_pair()
    jp, tp = _pair("AmodalCompletion", seed=3, segmenter=jseg)
    tp.segmenter = tseg
    crop = _image(3, (48, 40), 4)
    crop[..., 3] = np.where(np.arange(40)[None] < 25, 255, 0)
    want, got = jp.complete(crop, "chair"), tp.complete(crop, "chair")
    _close_u8(got[..., :3], want[..., :3])
    # The alpha is a re-binarised matte, opaque over the original mask.
    assert (got[..., 3] != want[..., 3]).mean() <= ALPHA_SHARE
    assert (got[..., 3][crop[..., 3] > 127] == 255).all()


def test_zero123_matches_jax():
    jp, tp = _pair("Zero123NovelView", seed=4)
    crop = _image(4, (40, 36), 4)
    _close_u8(tp.generate(crop, 0.0, -10.0, seed=3), jp.generate(crop, 0.0, -10.0, seed=3))
