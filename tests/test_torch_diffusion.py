"""The port's diffusion modules (`models/diffusion/`) against the JAX
package's, on the CPU in float32 at `tiny_test()` sizes.

  * `ResBlock`, `TransformerBlock`, `UNet2D` (4 and 8 input channels), the
    VAE's encode (mean, and the posterior sample with JAX's draw) and
    decode, and `NoisePredictor` (its moments and `sample` with JAX's draw)
    on the same inputs and the same parameters (a seeded tree of the JAX
    shapes, carried across by `flax_to_state_dict`; the UNet's output conv
    is random, not zero, so every branch reaches the output): 1e-4 relative
    and absolute (float32 through a few blocks whose sums run in another
    order).
  * `ddim_sample` with the same eps function, and `cfg_eps` /
    `dual_cfg_eps`, whose branches the port evaluates as one batch: 1e-5.
    The timesteps the sampler visits (float32 linspace truncated to int32)
    equal the JAX package's exactly; the alpha-bar schedule agrees within
    5e-6 relative (a float32 cumulative product of 1000 factors, taken in
    another order).
  * The converters (`convert_sd_unet`, `convert_sd_vae`, `convert_zero123`,
    `convert_noise_predictor`) on seeded state dicts with the released
    diffusers names (`chip_smoke.released_*_state`) give the JAX
    converters' trees exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.models.diffusion import convert as jconv
from labelany3d_tpu.models.diffusion import noise_predictor as jnp_mod
from labelany3d_tpu.models.diffusion import sampler as jsampler
from labelany3d_tpu.models.diffusion import unet as junet
from labelany3d_tpu.models.diffusion import vae as jvae
from labelany3d_tpu_torch.models.diffusion import convert as tconv
from labelany3d_tpu_torch.models.diffusion import noise_predictor as tnp_mod
from labelany3d_tpu_torch.models.diffusion import sampler as tsampler
from labelany3d_tpu_torch.models.diffusion import unet as tunet
from labelany3d_tpu_torch.models.diffusion import vae as tvae
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_convert import _assert_same_tree
from tests.torch_parity import random_flax_params

TOL = 1e-4
SAMPLER_TOL = 1e-5
SCHEDULE_RTOL = 5e-6


def _port(model, params):
    model.load_state_dict(flax_to_state_dict(params, model))
    return model.eval().requires_grad_(False)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("c_in,c_out", [(8, 16), (16, 16)])
def test_resblock_matches_jax(c_in, c_out):
    rng = np.random.default_rng(0)
    x, temb = _rand(rng, 2, 6, 5, c_in), _rand(rng, 2, 12)
    jm = junet.ResBlock(c_out, jnp.float32)
    params = random_flax_params(jm.init, x, temb, seed=1)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, temb))(params)
    got = _port(tunet.ResBlock(c_in, c_out, 12, torch.float32), params)(_nchw(x),
                                                                        torch.from_numpy(temb))
    _close(got.permute(0, 2, 3, 1), want)


def test_transformer_block_matches_jax():
    rng = np.random.default_rng(2)
    x, ctx = _rand(rng, 2, 4, 6, 16), _rand(rng, 2, 5, 12)
    jm = junet.TransformerBlock(2, 12, jnp.float32)
    params = random_flax_params(jm.init, x, ctx, seed=3)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, ctx))(params)
    got = _port(tunet.TransformerBlock(16, 2, 12, torch.float32), params)(
        _nchw(x), torch.from_numpy(ctx))
    _close(got.permute(0, 2, 3, 1), want)


def _unet_cfgs(in_channels=4):
    j = dataclasses.replace(junet.UNetConfig.tiny_test(), dtype=jnp.float32,
                            in_channels=in_channels)
    t = tunet.UNetConfig.tiny_test(dtype=torch.float32, in_channels=in_channels)
    return j, t


@pytest.mark.parametrize("in_channels", [4, 8])
def test_unet_matches_jax(in_channels):
    jcfg, tcfg = _unet_cfgs(in_channels)
    rng = np.random.default_rng(4)
    x, ctx = _rand(rng, 2, 16, 16, in_channels), _rand(rng, 2, 6, jcfg.context_dim)
    t = np.array([0.5, 0.037], np.float32)
    jm = junet.UNet2D(jcfg)
    params = random_flax_params(jm.init, x[:1], t[:1], ctx[:1], seed=5)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, t, ctx))(params)
    got = _port(tunet.UNet2D(tcfg), params)(torch.from_numpy(x), torch.from_numpy(t),
                                            torch.from_numpy(ctx))
    assert got.shape == (2, 16, 16, 4)
    _close(got, want)


def test_unet_default_init_is_zero_gated():
    model = tunet.init_unet_(tunet.UNet2D(_unet_cfgs()[1]), torch.Generator().manual_seed(0))
    out = model(torch.randn(1, 8, 8, 4), torch.tensor([0.3]), torch.randn(1, 3, 16))
    assert torch.count_nonzero(out) == 0  # out_conv starts at zero, as in the JAX package


def test_vae_matches_jax():
    jcfg = dataclasses.replace(jvae.VAEConfig.tiny_test(), dtype=jnp.float32)
    tcfg = tvae.VAEConfig.tiny_test(dtype=torch.float32)
    rng = np.random.default_rng(6)
    img = np.tanh(_rand(rng, 2, 32, 32, 3))
    jv = jvae.AutoencoderKL(jcfg)
    lat0 = np.zeros((1, 16, 16, 4), np.float32)
    jv.params = {"encoder": random_flax_params(jv.encoder.init, img[:1], seed=7),
                 "decoder": random_flax_params(jv.decoder.init, lat0, seed=8)}
    tv = _port(tvae.AutoencoderKL(tcfg), jv.params)
    key = jax.random.PRNGKey(9)
    draw = np.array(jax.random.normal(key, (2, 16, 16, 4)))
    _close(tv.encode(torch.from_numpy(img)), jv.encode(jnp.asarray(img)))
    _close(tv.encode(torch.from_numpy(img), noise=torch.from_numpy(draw)),
           jv.encode(jnp.asarray(img), key=key))
    _close(tv.encode(torch.from_numpy(img), scale=False), jv.encode(jnp.asarray(img), scale=False))
    lat = _rand(rng, 2, 16, 16, 4)
    _close(tv.decode(torch.from_numpy(lat)), jv.decode(jnp.asarray(lat)))


@pytest.mark.parametrize("start,steps", [(999, 50), (999, 20), (250, 5), (999, 2), (600, 7)])
def test_ddim_timesteps_match_jax(start, steps):
    want = np.asarray(jnp.linspace(start, 0, steps + 1).astype(jnp.int32)).tolist()
    assert tsampler.ddim_timesteps(tsampler.DDIMConfig(steps=steps, start_timestep=start)) == want


def test_ddim_sample_and_schedule_match_jax():
    np.testing.assert_allclose(tsampler.make_alphas().numpy(), np.asarray(jsampler.make_alphas()),
                               rtol=SCHEDULE_RTOL, atol=0)
    rng = np.random.default_rng(10)
    noise, x0 = _rand(rng, 2, 4, 4, 3), _rand(rng, 2, 4, 4, 3)
    cfg = dict(steps=6, start_timestep=700)
    want = jsampler.ddim_sample(lambda x, t: 0.3 * x + t[:, None, None, None] / 1000.0,
                                jnp.asarray(noise), jsampler.DDIMConfig(**cfg))
    got = tsampler.ddim_sample(lambda x, t: 0.3 * x + t[:, None, None, None] / 1000.0,
                               torch.from_numpy(noise), tsampler.DDIMConfig(**cfg))
    _close(got, want, SAMPLER_TOL)
    _close(tsampler.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), 321),
           jsampler.add_noise(jnp.asarray(x0), jnp.asarray(noise), 321), SAMPLER_TOL)


def _model_fn(xp):
    """A per-row stand-in for the UNet, in either framework."""
    def fn(x, t, ctx):
        s = ctx.mean(axis=(1, 2)) if xp is jnp else ctx.mean(dim=(1, 2))
        out = x[..., :2] * s[:, None, None, None] + t[:, None, None, None] / 1000.0
        return out + (x[..., 2:] if x.shape[-1] > 2 else 0.0)
    return fn


def test_guidance_matches_jax():
    rng = np.random.default_rng(11)
    x, img, c, u = (_rand(rng, 1, 3, 3, 2), _rand(rng, 1, 3, 3, 2), _rand(rng, 1, 4, 5),
                    _rand(rng, 1, 4, 5))
    t = np.array([420], np.int32)
    J, T = (lambda a: jnp.asarray(a)), torch.from_numpy
    want = jsampler.cfg_eps(_model_fn(jnp), J(c), J(u), 3.0)(J(x), J(t))
    got = tsampler.cfg_eps(_model_fn(torch), T(c), T(u), 3.0)(T(x), T(t))
    _close(got, want, SAMPLER_TOL)
    want = jsampler.dual_cfg_eps(_model_fn(jnp), J(c), J(u), J(img), J(0 * img), 8.5,
                                 1.5)(J(x), J(t))
    got = tsampler.dual_cfg_eps(_model_fn(torch), T(c), T(u), T(img), T(0 * img), 8.5,
                                1.5)(T(x), T(t))
    _close(got, want, SAMPLER_TOL)


def test_noise_predictor_matches_jax():
    jcfg = jnp_mod.NoisePredictorConfig.tiny_test()
    tcfg = tnp_mod.NoisePredictorConfig.tiny_test()
    rng = np.random.default_rng(12)
    img = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([250.0, 17.0], np.float32)
    jm = jnp_mod.NoisePredictor(jcfg)
    params = random_flax_params(jm.init, img[:1], t[:1], seed=13)
    want = jax.jit(lambda p: jm.apply({"params": p}, img, t))(params)
    tm = _port(tnp_mod.NoisePredictor(tcfg), params)
    got = tm(torch.from_numpy(img), torch.from_numpy(t))
    assert got["mean"].shape == (2, 8, 8, 4)
    for k in ("mean", "logvar"):
        _close(got[k], want[k])
    key = jax.random.PRNGKey(14)
    draw = np.array(jax.random.normal(key, want["mean"].shape))
    want_s = jm.apply({"params": params}, img, t, key, method=jnp_mod.NoisePredictor.sample)
    _close(tm.sample(torch.from_numpy(img), torch.from_numpy(t), noise=torch.from_numpy(draw)),
           want_s)
    _close(tm.sample(torch.from_numpy(img), torch.from_numpy(t), sample_posterior=False),
           want["mean"])


def test_converters_match_jax():
    jcfg, tcfg = _unet_cfgs()
    unet = chip_smoke.released_sd_unet_state(tcfg, std=0.1)
    _assert_same_tree(tconv.convert_sd_unet(unet, tcfg), jconv.convert_sd_unet(unet, jcfg))
    jv, tv = jvae.VAEConfig.tiny_test(), tvae.VAEConfig.tiny_test()
    vae = chip_smoke.released_sd_vae_state(tv, std=0.1)
    _assert_same_tree(tconv.convert_sd_vae(vae, tv), jconv.convert_sd_vae(vae, jv))
    jcfg8, tcfg8 = _unet_cfgs(8)
    unet8 = chip_smoke.with_conv_in(unet, 8)
    cc = chip_smoke.released_cc_state(16, jcfg8.context_dim)
    _assert_same_tree(
        tconv.convert_zero123(unet8, vae, None, cc, unet_cfg=tcfg8, vae_cfg=tv),
        jconv.convert_zero123(unet8, vae, None, cc, unet_cfg=jcfg8, vae_cfg=jv))
    # The trees load into the port's modules.
    _port(tunet.UNet2D(tcfg8), tconv.convert_sd_unet(unet8, tcfg8))
    _port(tvae.AutoencoderKL(tv), tconv.convert_sd_vae(vae, tv))
    npc = tnp_mod.NoisePredictorConfig.tiny_test()
    nps = chip_smoke.released_noise_predictor_state(npc, std=0.1)
    tree = tnp_mod.convert_noise_predictor(nps, npc)
    _assert_same_tree(tree, jnp_mod.convert_noise_predictor(
        nps, jnp_mod.NoisePredictorConfig.tiny_test()))
    _port(tnp_mod.NoisePredictor(npc), tree)
