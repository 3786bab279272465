"""Task pipelines on the diffusion family: enhance, completion, novel view.

Counterpart of `labelany3d_tpu/models/diffusion/pipelines.py`. Each class
is the backend of a stage: `InvSREnhance` of stage 2 (`run.enhance=invsr`),
`AmodalCompletion` of stage 4 (`run.amodal_completion=our`) and
`Zero123NovelView` the view source of stage 5's `run.elevation=zero123`.
Text conditioning goes through a CLIP text encoder (`models/clip.py`) and
Zero123's image conditioning through a CLIP vision tower and its
cc_projection; the sampling math and the guidance scales follow the
reference.

Images enter and leave as uint8 numpy arrays; everything between runs on
the pipeline's `device` (CUDA unless the caller passes "cpu"). Pillow's
resizes are the port's 8-bit ones (`models/layers.py`), within one level of
Pillow's. Parameters: `set_params` takes Flax-layout trees (the JAX
package's, or released weights through `convert.py` and `models/clip.py`);
a component without one gets random weights from a `torch.Generator`
seeded as the JAX package seeds its key (UNet and VAE `seed`, vision tower
`seed + 1`, cc_projection `seed + 2`, noise predictor `seed + 3`), with a
warning. The random draws are arguments (`noise`); without them they come
from a `torch.Generator` seeded with `seed` (InvSR, completion) or the
view's `seed` (Zero123).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from labelany3d_tpu_torch.data.bpe import load_tokenizer
from labelany3d_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    init_clip_,
    preprocess_clip_image,
)
from labelany3d_tpu_torch.models.diffusion.sampler import (
    DDIMConfig,
    add_noise,
    cfg_eps,
    ddim_sample,
    dual_cfg_eps,
)
from labelany3d_tpu_torch.models.diffusion.unet import UNet2D, UNetConfig, init_unet_
from labelany3d_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from labelany3d_tpu_torch.models.layers import Dense, resize, resize_bicubic_8bit
from labelany3d_tpu_torch.models.weights import build_module
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.logging import warn_once


def _with_dtype(cfg, dtype):
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    """Decoded (H, W, 3) in [-1, 1] -> uint8, truncated as numpy's astype."""
    return ((img.clamp(-1, 1) + 1.0) * 127.5).to(torch.uint8)


def _resize_u8(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(H, W, C) 8-bit values -> (size, C) float32 integers, Pillow's
    default (BICUBIC) `Image.resize`."""
    return resize_bicubic_8bit(x.permute(2, 0, 1)[None], size)[0].permute(1, 2, 0)


class TextConditioner:
    """Prompt -> (1, L, D) CLIP text-encoder context for the UNet's cross
    attention, cached by prompt.

    `for_context_dim` picks the CLIP tower whose width matches the UNet's
    context_dim (768: the SD 1.x / InstructPix2Pix CLIP ViT-L/14 text
    tower; other widths a small tower for tests). Released weights install
    as `params=convert_clip_text(...)` with `tokenizer_path=<ckpt dir>`."""

    def __init__(self, cfg: CLIPTextConfig, params=None, tokenizer=None,
                 tokenizer_path: str | None = None, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.tokenizer = tokenizer or load_tokenizer(tokenizer_path, cfg.vocab_size)
        self._seed = seed
        self.model: CLIPTextEncoder | None = None
        self._cache: dict[str, torch.Tensor] = {}

    @staticmethod
    def for_context_dim(dim: int, max_len: int = 77, dtype=None, **kw) -> "TextConditioner":
        if dim == 768:
            cfg = CLIPTextConfig.sd15()
        elif dim == 1024:
            cfg = CLIPTextConfig.sd2()
        else:
            cfg = CLIPTextConfig(vocab_size=4096, width=dim, depth=2,
                                 num_heads=2 if dim % 2 == 0 else 1,
                                 max_len=min(max_len, 16), eos_token_id=4095)
        return TextConditioner(_with_dtype(cfg, dtype), **kw)

    def _ensure(self) -> None:
        if self.model is None:
            if self.params is None:
                warn_once("clip_text_random",
                          "text conditioning runs a random-initialized CLIP text encoder (no "
                          "converted weights installed): diffusion outputs are not "
                          "prompt-faithful")
            self.model = build_module(lambda: CLIPTextEncoder(self.cfg), self.device,
                                      self.params, self._seed, init_clip_)
            self.params = None  # the model holds them now
        if getattr(self.tokenizer, "is_fallback", False):
            warn_once("clip_tokenizer_fallback",
                      "no CLIP vocab files installed; prompts tokenize through a "
                      "deterministic hash fallback")

    @torch.inference_mode()
    def embed(self, prompt: str) -> torch.Tensor:
        self._ensure()
        if prompt not in self._cache:
            ids = torch.tensor([self.tokenizer(prompt, self.cfg.max_len)], device=self.device)
            self._cache[prompt] = self.model(ids)["last_hidden"]
        return self._cache[prompt]


class _Base:
    """A UNet, a VAE and a text conditioner on `device`. `dtype` replaces
    the compute dtype of every component's config (the configs' bf16 by
    default; the parity tests run float32)."""

    def __init__(self, unet_cfg: UNetConfig, vae_cfg: VAEConfig, image_size: int,
                 seed: int = 0, device=None, dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        self.unet_cfg = _with_dtype(unet_cfg, dtype)
        self.vae_cfg = _with_dtype(vae_cfg, dtype)
        self.image_size = image_size
        self.seed = seed
        self.unet: UNet2D | None = None
        self.vae: AutoencoderKL | None = None
        self._trees: dict = {}
        self.text = TextConditioner.for_context_dim(self.unet_cfg.context_dim, dtype=dtype,
                                                    seed=seed, device=self.device)

    @property
    def latent_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.widths) - 1)

    def set_params(self, trees: dict):
        """Install Flax-layout trees, any subset of {"unet", "vae" (with its
        "encoder" and "decoder"), "text"} (Zero123 adds "vision" and "cc");
        they load when the models are built. Missing components get random
        weights."""
        trees = dict(trees)
        if "text" in trees:
            self.text.params = trees.pop("text")
        self._trees.update(trees)
        return self

    def _random(self, key: str, what: str) -> None:
        warn_once(key, f"{what} runs with random-initialized weights (no converted "
                       "checkpoint): its outputs are not meaningful")

    def init_params(self) -> None:
        """Build the UNet and the VAE (from the installed trees, or random)."""
        unet_tree, vae_tree = self._trees.pop("unet", None), self._trees.pop("vae", None)
        if unet_tree is None:
            self._random(f"{type(self).__name__}_random", type(self).__name__)
        self.unet = build_module(lambda: UNet2D(self.unet_cfg), self.device, unet_tree,
                                 self.seed, init_unet_)
        self.vae = build_module(lambda: AutoencoderKL(self.vae_cfg), self.device, vae_tree,
                                self.seed)

    def _ensure(self) -> None:
        if self.unet is None:
            self.init_params()

    def _eps_model(self, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        return self.unet(x, t / 1000.0, ctx)

    def _input(self, proc: torch.Tensor) -> torch.Tensor:
        """(S, S, 3) 8-bit values -> the VAE's (1, S, S, 3) input in [-1, 1]."""
        return proc[None] / 127.5 - 1.0

    def _noise(self, noise, shape: tuple = (), seed: int = 0) -> torch.Tensor:
        """The given draw on the device, else a standard normal of `shape`
        from a generator seeded with `seed`."""
        if noise is not None:
            return torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device)


class InvSREnhance(_Base):
    """Partial-inversion super-resolution (InvSR, stage 2).

    Bicubic-upscale the image `factor` times, resize that to the processing
    size, encode, forward-diffuse to `start_timestep` (the inversion) and
    denoise the few remaining steps, then decode and resize to the upscaled
    size. Both guidance branches see the empty prompt at scale 1, so
    e_u + 1 * (e_c - e_u) is e_c: one UNet evaluation a step.

    `noise_predictor=True` builds InvSR's learned inversion noise
    (`NoisePredictor`, sd_turbo shape; tiny with `tiny`), whose posterior
    sample replaces the Gaussian starting noise; its weights come from
    `noise_predictor_params` (a Flax-layout tree) or are random."""

    def __init__(self, factor: int = 4, start_timestep: int = 250, steps: int = 5,
                 image_size: int = 256, tiny: bool = False, seed: int = 0,
                 noise_predictor=None, noise_predictor_params=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__(UNetConfig.tiny_test() if tiny else UNetConfig(),
                         VAEConfig.tiny_test() if tiny else VAEConfig(), image_size, seed,
                         device, dtype)
        self.factor = factor
        self.cfg = DDIMConfig(steps=steps, guidance_scale=1.0, start_timestep=start_timestep)
        if noise_predictor is True:
            from labelany3d_tpu_torch.models.diffusion.noise_predictor import (
                NoisePredictorConfig,
            )

            noise_predictor = (NoisePredictorConfig.tiny_test() if tiny
                               else NoisePredictorConfig.sd_turbo())
        # A NoisePredictorConfig until the model is built.
        self.noise_predictor = noise_predictor
        self._np_params = noise_predictor_params

    def _predictor(self):
        from labelany3d_tpu_torch.models.diffusion.noise_predictor import NoisePredictor

        if not isinstance(self.noise_predictor, NoisePredictor):
            cfg = self.noise_predictor
            if self._np_params is None:
                self._random("invsr_noise_predictor_random", "InvSR noise predictor")
            self.noise_predictor = build_module(lambda: NoisePredictor(cfg), self.device,
                                                self._np_params, self.seed + 3)
            self._np_params = None
        return self.noise_predictor

    @torch.inference_mode()
    def enhance(self, image: np.ndarray, noise=None) -> np.ndarray:
        """uint8 (H, W, 3) -> uint8 (H * factor, W * factor, 3). `noise` is
        the standard normal draw: the starting noise of the latents' shape,
        or with a noise predictor its posterior draw of the predictor's
        mean shape."""
        self._ensure()
        h, w = image.shape[:2]
        hw_up = (h * self.factor, w * self.factor)
        s = self.image_size
        up = _resize_u8(torch.from_numpy(np.ascontiguousarray(image)).to(self.device), hw_up)
        x = self._input(_resize_u8(up, (s, s)))
        lat = self.vae.encode(x)
        if self.noise_predictor is not None:
            pred = self._predictor()
            img01 = (x + 1.0) / 2.0
            t = torch.full((1,), float(self.cfg.start_timestep), device=self.device)
            n = s
            for _ in range(len(pred.cfg.widths) - 1):  # each (0, 1)-padded stride-2 conv
                n = (n - 2) // 2 + 1
            noise = pred.sample(img01, t, noise=self._noise(
                noise, (1, n, n, pred.cfg.latent_channels), self.seed))
            if noise.shape != lat.shape:  # latent grid mismatch: bilinear resize
                noise = resize(noise.permute(0, 3, 1, 2), tuple(lat.shape[1:3]),
                               method="bilinear").permute(0, 2, 3, 1)
        else:
            noise = self._noise(noise, tuple(lat.shape), self.seed)
        noised = add_noise(lat, noise, self.cfg.start_timestep)
        ctx = self.text.embed("")
        out_lat = ddim_sample(lambda z, t: self._eps_model(z, t, ctx), noised, self.cfg)
        out = _to_u8(self.vae.decode(out_lat)[0])
        return _resize_u8(out, hw_up).to(torch.uint8).cpu().numpy()


class AmodalCompletion(_Base):
    """InstructPix2Pix-style amodal completion (stage 4's `our`).

    Prompt = category label, 50 steps, image guidance 1.5, text guidance
    8.5 (dual CFG, the three branches as one batch); masked-out pixels are
    set to 0.5 grey before conditioning. `segmenter=True` re-segments the
    completed crop with ISNet (`models/saliency.py::RembgSegmenter` at 1024
    px, 64 with `tiny`) for the amodal alpha; None keeps an opaque alpha."""

    def __init__(self, steps: int = 50, text_scale: float = 8.5, image_scale: float = 1.5,
                 image_size: int = 256, tiny: bool = False, seed: int = 0, segmenter=None,
                 device=None, dtype: torch.dtype | None = None):
        ucfg = UNetConfig.tiny_test() if tiny else UNetConfig()
        ucfg = dataclasses.replace(ucfg, in_channels=2 * ucfg.in_channels)
        super().__init__(ucfg, VAEConfig.tiny_test() if tiny else VAEConfig(), image_size,
                         seed, device, dtype)
        self.cfg = DDIMConfig(steps=steps, guidance_scale=text_scale,
                              image_guidance_scale=image_scale)
        if segmenter is True:
            from labelany3d_tpu_torch.models.saliency import ISNetConfig, RembgSegmenter

            segmenter = RembgSegmenter(ISNetConfig.tiny_test() if tiny
                                       else ISNetConfig.general_use(),
                                       input_size=64 if tiny else 1024, device=self.device)
        self.segmenter = segmenter

    @torch.inference_mode()
    def complete(self, crop_rgba: np.ndarray, label: str, noise=None) -> np.ndarray:
        """uint8 (H, W, 3 or 4) crop -> uint8 (H, W, 4) completed RGBA.
        `noise`: the starting latents' standard normal draw."""
        self._ensure()
        img = np.asarray(crop_rgba)
        t = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        rgb = t[..., :3].float() / 255.0
        alpha = (t[..., 3:4].float() / 255.0 if img.shape[-1] == 4
                 else torch.ones_like(rgb[..., :1]))
        cond = rgb * alpha + 0.5 * (1.0 - alpha)  # grey outside the mask
        s = self.image_size
        x = self._input(_resize_u8((cond * 255).to(torch.uint8), (s, s)))
        img_lat = self.vae.encode(x)
        nch = self.unet_cfg.in_channels // 2
        noise = self._noise(noise, tuple(img_lat.shape[:-1]) + (nch,), self.seed)
        eps = dual_cfg_eps(self._eps_model, self.text.embed(label), self.text.embed(""),
                           img_lat, torch.zeros_like(img_lat), self.cfg.guidance_scale,
                           self.cfg.image_guidance_scale)
        out_lat = ddim_sample(eps, noise, self.cfg)
        out = _to_u8(self.vae.decode(out_lat)[0])
        out = _resize_u8(out, img.shape[:2]).to(torch.uint8).cpu().numpy()
        if self.segmenter is not None and img.shape[-1] == 4:
            from labelany3d_tpu_torch.models.saliency import segment_completed

            return segment_completed(out, img, self.segmenter)
        return np.concatenate([out, np.full(out.shape[:2] + (1,), 255, np.uint8)], axis=-1)


class _CCProjection(nn.Module):
    """Zero123's cc_projection: [CLIP image embed, 4-dof camera] -> one
    cross-attention context token."""

    def __init__(self, emb_dim: int, out_dim: int):
        super().__init__()
        self.proj = Dense(emb_dim + 4, out_dim, torch.float32)

    def forward(self, image_embed: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        return self.proj(torch.cat([image_embed, cam], dim=-1))[:, None, :]


class Zero123NovelView(_Base):
    """Image + relative-camera conditioned novel views (Zero123).

    Stage 5 calls it with 4 (d_elev, d_azim) deltas of +-10 degrees. The
    conditioning is zero123's: the CLIP vision image embedding concatenated
    with the camera vector [d_elev, sin(d_azim), cos(d_azim), d_dist]
    through cc_projection into one context token; CFG 3.0 against a zero
    token, both branches as one batch, 20 steps."""

    def __init__(self, steps: int = 20, guidance: float = 3.0, image_size: int = 256,
                 tiny: bool = False, seed: int = 0, device=None,
                 dtype: torch.dtype | None = None):
        ucfg = UNetConfig.tiny_test() if tiny else UNetConfig()
        ucfg = dataclasses.replace(ucfg, in_channels=2 * ucfg.in_channels)
        super().__init__(ucfg, VAEConfig.tiny_test() if tiny else VAEConfig(), image_size,
                         seed, device, dtype)
        self.cfg = DDIMConfig(steps=steps, guidance_scale=guidance)
        self.vision_cfg = _with_dtype(
            CLIPVisionConfig.tiny_test() if tiny else CLIPVisionConfig.vitl14(), dtype)
        self.image_encoder: CLIPVisionEncoder | None = None
        self.cc_projection: _CCProjection | None = None

    def init_params(self) -> None:
        super().init_params()
        vc = self.vision_cfg
        self.image_encoder = build_module(lambda: CLIPVisionEncoder(vc), self.device,
                                          self._trees.pop("vision", None), self.seed + 1,
                                          init_clip_)
        self.cc_projection = build_module(
            lambda: _CCProjection(vc.projection_dim or vc.width, self.unet_cfg.context_dim),
            self.device, self._trees.pop("cc", None), self.seed + 2)

    @torch.inference_mode()
    def generate(self, rgba: np.ndarray, d_elev: float, d_azim: float, d_dist: float = 0.0,
                 seed: int = 0, noise=None) -> np.ndarray:
        """uint8 (H, W, 3 or 4) -> uint8 (S, S, 3) view at the deltas (a
        transparent background becomes white). `noise`: the starting
        latents' standard normal draw, else drawn with `seed`."""
        self._ensure()
        img = np.asarray(rgba)
        t = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        rgb = t[..., :3]
        if img.shape[-1] == 4:
            a = t[..., 3:4].float() / 255.0
            rgb = (rgb * a + 255 * (1 - a)).to(torch.uint8)  # white background
        s = self.image_size
        proc = _resize_u8(rgb, (s, s))
        x = self._input(proc)
        enc = self.image_encoder(preprocess_clip_image(proc / 255.0, self.vision_cfg.image_size)
                                 [None])
        image_embed = enc.get("image_embeds", enc["pooled"]).float()
        cam = torch.tensor([[np.deg2rad(d_elev), np.sin(np.deg2rad(d_azim)),
                             np.cos(np.deg2rad(d_azim)), d_dist]], dtype=torch.float32,
                           device=self.device)
        ctx = self.cc_projection(image_embed, cam)
        img_lat = self.vae.encode(x)
        nch = self.unet_cfg.in_channels // 2
        noise = self._noise(noise, tuple(img_lat.shape[:-1]) + (nch,), seed)

        def eps_model(z, tt, c):
            z_full = torch.cat([z, img_lat.expand(z.shape[0], -1, -1, -1)], dim=-1)
            return self._eps_model(z_full, tt, c)

        eps = cfg_eps(eps_model, ctx, torch.zeros_like(ctx), self.cfg.guidance_scale)
        out_lat = ddim_sample(eps, noise, self.cfg)
        return _to_u8(self.vae.decode(out_lat)[0]).cpu().numpy()
