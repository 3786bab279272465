"""Hunyuan3D-1 mvd_std multi-view diffusion.

Counterpart of `labelany3d_tpu/models/diffusion/mvd.py`: the six orbit views
of the Hunyuan3D path come from a fine-tuned SDXL UNet that denoises ONE
3x2 grid latent (1536x1024 px) under reference-only attention. Every step
runs the UNet twice: a `write` pass over the noised condition-image latent
records each transformer block's normed tokens, and the `read` pass over
the grid latent attends over [own tokens | recorded tokens]. Both CFG rows
run as one batch of 2 in each pass (reference row j pairs with sample row
j), as the JAX package runs them; the step loop is a Python loop where the
JAX package runs `lax.scan`.

Conditioning: prompt = uc_text_emb + [CLIP ViT-L/14 | ViT-bigG/14 image
embeds] * ramping coefficients, pooled = uc_text_emb_2, SDXL time ids
(H, W, 0, 0, H, W); the CFG negatives are zeros and a black image's latent.
Released `weights/mvd_std` go through `convert.py::convert_mvd`.

`MVDUNet` keeps the JAX function's NHWC `x` and output; the convolutions
run NCHW inside. Its attention is plain PyTorch (`layers.dense_attention`,
float32), as the JAX package leaves it to XLA. The transformer GEGLU takes
Flax's tanh GELU, as the JAX package's (diffusers' is exact erf; ROADMAP.md
F11). Norms run in float32 (GroupNorm eps 1e-6, LayerNorms 1e-5, the output
GroupNorm 1e-5), the output conv in float32 from Flax's default
initialiser (not zero).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.clip import (
    CLIPVisionConfig,
    CLIPVisionEncoder,
    init_clip_,
    preprocess_clip_image,
)
from labelany3d_tpu_torch.models.diffusion.pipelines import _with_dtype
from labelany3d_tpu_torch.models.diffusion.unet import ResBlock
from labelany3d_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig, num_groups
from labelany3d_tpu_torch.models.layers import (
    Conv,
    Dense,
    GroupNorm32,
    LayerNorm32,
    dense_attention,
    resize_bicubic_8bit,
    white_composite,
)
from labelany3d_tpu_torch.models.trellis.dit import timestep_embedding
from labelany3d_tpu_torch.models.weights import build_module
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.logging import warn_once

SDXL_LATENT_SCALE = 0.13025  # SDXL vae config.json scaling_factor


def scale_latents(x):
    """The grid-latent normalization the mvd UNet was trained under."""
    return (x - 0.22) * 0.75


def unscale_latents(x):
    return x / 0.75 + 0.22


def unscale_image(x):
    """unscale_image(unscale_image_2(x)) composed: 0.8x + 0.5."""
    return x * 0.8 + 0.5


@dataclasses.dataclass(frozen=True)
class MVDUNetConfig:
    """SDXL-shaped UNet2DConditionModel: 3 levels, no attention at level 0,
    transformer depth (2, 10) at levels 1-2 and 10 in the mid block, linear
    proj_in/out, head dim 64, context 2048, the text_time additional
    embedding (pooled 1280 + 6 x 256 Fourier time-id features)."""

    in_channels: int = 4
    out_channels: int = 4
    widths: Sequence[int] = (320, 640, 1280)
    attn_levels: Sequence[int] = (1, 2)
    transformer_depth: Sequence[int] = (0, 2, 10)
    num_res_blocks: int = 2
    head_dim: int = 64
    context_dim: int = 2048
    pooled_dim: int = 1280
    addition_time_embed_dim: int = 256
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "MVDUNetConfig":
        return MVDUNetConfig(
            widths=(16, 32), attn_levels=(1,), transformer_depth=(0, 2),
            num_res_blocks=1, head_dim=8, context_dim=24, pooled_dim=12,
            addition_time_embed_dim=8, dtype=torch.float32,
        )

    @staticmethod
    def from_hf_json(cfg: dict) -> "MVDUNetConfig":
        """From the checkpoint's unet/config.json."""
        widths = tuple(cfg["block_out_channels"])
        attn_levels = tuple(i for i, t in enumerate(cfg["down_block_types"]) if "CrossAttn" in t)
        tdepth = cfg.get("transformer_layers_per_block", 1)
        if isinstance(tdepth, int):
            tdepth = tuple(tdepth if i in attn_levels else 0 for i in range(len(widths)))
        else:
            tdepth = tuple(tdepth)
        head = cfg.get("attention_head_dim", 64)
        if isinstance(head, (list, tuple)):
            # diffusers stores per-level head counts for SDXL; the shared
            # head dim comes from the deepest attention level.
            lvl = attn_levels[-1]
            head = widths[lvl] // head[lvl]
        return MVDUNetConfig(
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            widths=widths,
            attn_levels=attn_levels,
            transformer_depth=tdepth,
            num_res_blocks=cfg.get("layers_per_block", 2),
            head_dim=head,
            context_dim=cfg.get("cross_attention_dim", 2048),
            pooled_dim=cfg.get("projection_class_embeddings_input_dim", 2816)
            - 6 * cfg.get("addition_time_embed_dim", 256),
            addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
        )


class MVDTransformer(nn.Module):
    """SDXL Transformer2DModel on NCHW features: GroupNorm -> linear proj_in
    -> `depth` blocks (self attention, cross attention, GEGLU) -> linear
    proj_out, residual. Self attention takes the reference-only protocol
    (`mode`, `refs`): 'write' appends each block's normed tokens to `refs`;
    'read' pops them from its front and attends over [own | recorded]."""

    def __init__(self, c: int, depth: int, head_dim: int, context_dim: int, dtype: torch.dtype):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        self.heads = max(1, c // head_dim)
        self.norm = GroupNorm32(num_groups(c), c, eps=1e-6)
        self.proj_in = Dense(c, c, dtype)
        for d in range(depth):
            for i in (1, 2, 3):
                self.add_module(f"b{d}_ln{i}", LayerNorm32(c, eps=1e-5))
            for name, kv_dim in (("self", c), ("cross", context_dim)):
                self.add_module(f"b{d}_{name}_q", Dense(c, c, dtype, bias=False))
                self.add_module(f"b{d}_{name}_k", Dense(kv_dim, c, dtype, bias=False))
                self.add_module(f"b{d}_{name}_v", Dense(kv_dim, c, dtype, bias=False))
                self.add_module(f"b{d}_{name}_proj", Dense(c, c, dtype))
            self.add_module(f"b{d}_geglu", Dense(c, 8 * c, dtype))
            self.add_module(f"b{d}_ff_out", Dense(4 * c, c, dtype))
        self.proj_out = Dense(c, c, dtype)

    def _attn(self, q_in: torch.Tensor, kv_in: torch.Tensor, name: str) -> torch.Tensor:
        m = lambda part: getattr(self, f"{name}_{part}")  # noqa: E731
        q, k, v = (t.unflatten(-1, (self.heads, -1))
                   for t in (m("q")(q_in), m("k")(kv_in), m("v")(kv_in)))
        return m("proj")(dense_attention(q, k, v).flatten(-2))

    def forward(self, x: torch.Tensor, context: torch.Tensor, mode: str,
                refs: list) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))    # (B, HW, C)
        ctx = context.to(self.dtype)
        for d in range(self.depth):
            ln = lambda i: getattr(self, f"b{d}_ln{i}")(t).to(self.dtype)  # noqa: E731
            tn = ln(1)
            if mode == "write":
                refs.append(tn)
                kv = tn
            elif mode == "read":
                # to_k / to_v are linear: concat-then-project is
                # project-then-concat.
                kv = torch.cat([tn, refs.pop(0).to(self.dtype)], dim=1)
            else:
                kv = tn
            t = t + self._attn(tn, kv, f"b{d}_self")
            t = t + self._attn(ln(2), ctx, f"b{d}_cross")
            a, gate = getattr(self, f"b{d}_geglu")(ln(3)).chunk(2, dim=-1)
            t = t + getattr(self, f"b{d}_ff_out")(a * F.gelu(gate, approximate="tanh"))
        t = self.proj_out(t)
        return x + t.transpose(1, 2).reshape(b, c, h, w)


class MVDUNet(nn.Module):
    """SDXL-class conditional UNet with reference-only self attention.

    x (B, H, W, C_in) NHWC latents, t (B,) in [0, 1], context (B, M, ctx),
    pooled (B, pooled_dim), time_ids (B, 6). `mode`: 'plain'; 'write'
    (returns the per-block normed tokens); 'read' (each block's self
    attention gets the matching write-pass tokens of `refs` concatenated;
    row j pairs with ref row j). Returns (out (B, H, W, C_out) float32,
    refs): refs is the recorded list in 'write' mode and [] otherwise."""

    def __init__(self, cfg: MVDUNetConfig):
        super().__init__()
        self.cfg = cfg
        d, ws = cfg.dtype, list(cfg.widths)
        tdim = ws[0] * 4
        self.t1 = Dense(ws[0], tdim, d)
        self.t2 = Dense(tdim, tdim, d)
        self.add1 = Dense(cfg.pooled_dim + 6 * cfg.addition_time_embed_dim, tdim, d)
        self.add2 = Dense(tdim, tdim, d)
        self.in_conv = Conv(cfg.in_channels, ws[0], 3, d)

        def transformer(lvl, c):
            return MVDTransformer(c, cfg.transformer_depth[lvl], cfg.head_dim,
                                  cfg.context_dim, d)

        skips, c = [ws[0]], ws[0]
        for lvl, width in enumerate(ws):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down{lvl}_res{i}", ResBlock(c, width, tdim, d))
                c = width
                if lvl in cfg.attn_levels:
                    self.add_module(f"down{lvl}_attn{i}", transformer(lvl, c))
                skips.append(c)
            if lvl < len(ws) - 1:
                self.add_module(f"down{lvl}_ds", Conv(c, c, 3, d, stride=2, padding=1))
                skips.append(c)
        self.mid_res1 = ResBlock(c, c, tdim, d)
        self.mid_attn = transformer(len(ws) - 1, c)
        self.mid_res2 = ResBlock(c, c, tdim, d)
        for lvl in reversed(range(len(ws))):
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up{lvl}_res{i}", ResBlock(c + skips.pop(), ws[lvl], tdim, d))
                c = ws[lvl]
                if lvl in cfg.attn_levels:
                    self.add_module(f"up{lvl}_attn{i}", transformer(lvl, c))
            if lvl > 0:
                self.add_module(f"up{lvl}_us", Conv(c, c, 3, d))
        self.norm_out = GroupNorm32(num_groups(c), c, eps=1e-5)
        self.out_conv = Conv(c, cfg.out_channels, 3, torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                pooled: torch.Tensor, time_ids: torch.Tensor, mode: str = "plain",
                refs: list | None = None):
        cfg = self.cfg
        d = cfg.dtype
        out_refs: list = list(refs) if mode == "read" and refs else []
        temb = self.t1(timestep_embedding(t.float() * 1000.0, cfg.widths[0]).to(d))
        temb = self.t2(F.silu(temb))
        ids = timestep_embedding(time_ids.float().reshape(-1), cfg.addition_time_embed_dim)
        aug = torch.cat([pooled.float(), ids.reshape(time_ids.shape[0], -1)], dim=-1).to(d)
        temb = temb + self.add2(F.silu(self.add1(aug)))

        h = self.in_conv(x.permute(0, 3, 1, 2))
        skips = [h]
        for lvl in range(len(cfg.widths)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down{lvl}_res{i}")(h, temb)
                if lvl in cfg.attn_levels:
                    h = getattr(self, f"down{lvl}_attn{i}")(h, context, mode, out_refs)
                skips.append(h)
            if lvl < len(cfg.widths) - 1:
                h = getattr(self, f"down{lvl}_ds")(h)
                skips.append(h)
        h = self.mid_res1(h, temb)
        h = self.mid_res2(self.mid_attn(h, context, mode, out_refs), temb)
        for lvl in reversed(range(len(cfg.widths))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up{lvl}_res{i}")(torch.cat([h, skips.pop()], dim=1), temb)
                if lvl in cfg.attn_levels:
                    h = getattr(self, f"up{lvl}_attn{i}")(h, context, mode, out_refs)
            if lvl > 0:
                h = getattr(self, f"up{lvl}_us")(F.interpolate(h, scale_factor=2,
                                                               mode="nearest"))
        out = self.out_conv(F.silu(self.norm_out(h))).permute(0, 2, 3, 1)
        return out, (out_refs if mode == "write" else [])


# --------------------------------------------------------------------------
# Euler-ancestral schedule (diffusers EulerAncestralDiscreteScheduler math)
# --------------------------------------------------------------------------


def euler_ancestral_schedule(steps: int, num_train: int = 1000,
                             timestep_spacing: str = "trailing"):
    """(timesteps (steps,), sigmas (steps + 1,)) float32 numpy arrays for an
    epsilon-prediction Euler-ancestral run, computed in float64 as the JAX
    package computes them: sigma_t = sqrt((1 - abar) / abar) over SD's
    scaled-linear betas; 'trailing', 'linspace' or 'leading' spacing; the
    last sigma 0."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_train) ** 2
    ab = np.cumprod(1.0 - betas)
    sig = np.sqrt((1.0 - ab) / ab)
    if timestep_spacing == "linspace":
        ts = np.linspace(0, num_train - 1, steps)[::-1].copy()
    elif timestep_spacing == "trailing":
        ts = np.arange(num_train, 0, -num_train / steps) - 1.0
    else:  # leading
        ts = (np.arange(0, steps) * (num_train // steps))[::-1].astype(np.float64)
    sigmas = np.interp(ts, np.arange(num_train), sig)
    return ts.astype(np.float32), np.append(sigmas, 0.0).astype(np.float32)


def euler_ancestral_step(x: torch.Tensor, eps: torch.Tensor, sigma, sigma_next,
                         noise: torch.Tensor) -> torch.Tensor:
    """x_{t-1} from the epsilon prediction (ancestral variance split), the
    sigmas as float32 scalars."""
    s = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    sn = torch.as_tensor(sigma_next, dtype=torch.float32, device=x.device)
    pred_x0 = x - s * eps
    var = (s ** 2 - sn ** 2).clamp_min(0.0)
    sigma_up = torch.sqrt(sn ** 2 * var / (s ** 2).clamp_min(1e-12))
    sigma_down = torch.sqrt((sn ** 2 - sigma_up ** 2).clamp_min(0.0))
    d = (x - pred_x0) / s.clamp_min(1e-12)
    return x + d * (sigma_down - s) + noise * sigma_up


# --------------------------------------------------------------------------
# The Image2Views-equivalent pipeline
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MVDConfig:
    tile: int = 512              # one view tile; grid = (3 * tile, 2 * tile)
    cond_size: int = 512         # the condition image's size
    steps: int = 50
    guidance: float = 2.0
    timestep_spacing: str = "trailing"

    @staticmethod
    def tiny_test() -> "MVDConfig":
        return MVDConfig(tile=16, cond_size=16, steps=3)


class MVDStdViews:
    """Image -> six orbit views through ONE 3x2 grid diffusion, on `device`.

    The decoded (3H, 2W) grid splits row-major into 6 tiles; tile order
    `ORDER` gives azimuths 0, 60, ..., 300 at elevation 0. Implements the
    `novel_views` protocol of `SVRMReconstruction` (`generate(rgba, elev,
    azim)`) with `provides_zero_view`: the azimuth-0 view is generated too.

    Weights: `set_params` takes Flax-layout trees (`convert.py::convert_mvd`
    or the JAX package's) and builds those components at once; the others
    get random weights from a `torch.Generator` (the UNet and the VAE
    seeded with `seed`, vision tower i with `seed + 1 + i`), with a warning
    for the UNet. `dtype` replaces every component's compute dtype (the
    parity tests run float32). The random draws are arguments (`noise`);
    without them they come from a `torch.Generator` seeded with the call's
    `seed`."""

    ORDER = (0, 2, 4, 5, 3, 1)
    AZIMUTHS = (0.0, 60.0, 120.0, 180.0, 240.0, 300.0)
    provides_zero_view = True

    def __init__(self, cfg: MVDConfig | None = None, tiny: bool = False, seed: int = 0,
                 device=None, dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or (MVDConfig.tiny_test() if tiny else MVDConfig())
        self.unet_cfg = _with_dtype(MVDUNetConfig.tiny_test() if tiny else MVDUNetConfig(), dtype)
        self.vae_cfg = _with_dtype(VAEConfig.tiny_test() if tiny else VAEConfig(), dtype)
        d1 = self.unet_cfg.context_dim - self.unet_cfg.pooled_dim
        if tiny:
            vcfgs = (CLIPVisionConfig.tiny_test(projection_dim=d1),
                     CLIPVisionConfig.tiny_test(projection_dim=self.unet_cfg.pooled_dim))
        else:
            # ViT-L/14 (768) + ViT-bigG/14 (1280) = the 2048 context width.
            vcfgs = (CLIPVisionConfig.vitl14(), CLIPVisionConfig.bigg14())
        self.vision_cfgs = tuple(_with_dtype(c, dtype) for c in vcfgs)
        self.seed = seed
        self.unet: MVDUNet | None = None
        self.vae: AutoencoderKL | None = None
        self.vision: list = [None, None]
        self.uc_text_emb: np.ndarray | None = None    # (1, 77, ctx)
        self.uc_text_emb_2: np.ndarray | None = None  # (1, pooled)
        self.ramping: np.ndarray | None = None        # (77,)
        self._cache: dict = {}

    @property
    def latent_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.widths) - 1)

    # -- weights ---------------------------------------------------------

    def _build_unet(self, tree) -> None:
        self.unet = build_module(lambda: MVDUNet(self.unet_cfg), self.device, tree, self.seed)

    def _build_vae(self, tree) -> None:
        self.vae = build_module(lambda: AutoencoderKL(self.vae_cfg, SDXL_LATENT_SCALE),
                                self.device, tree, self.seed)

    def _build_vision(self, i: int, tree) -> None:
        vc = self.vision_cfgs[i]
        self.vision[i] = build_module(lambda: CLIPVisionEncoder(vc), self.device, tree,
                                      self.seed + 1 + i, init_clip_)

    def set_params(self, trees: dict):
        """Install any subset of {"unet", "vae", "vision", "vision_2",
        "uc_text_emb", "uc_text_emb_2", "ramping_coefficients"}; the
        networks are built on the device at once."""
        if "unet" in trees:
            self._build_unet(trees["unet"])
        if "vae" in trees:
            self._build_vae(trees["vae"])
        for i, key in enumerate(("vision", "vision_2")):
            if key in trees:
                self._build_vision(i, trees[key])
        for key in ("uc_text_emb", "uc_text_emb_2"):
            if key in trees:
                setattr(self, key, np.asarray(trees[key], np.float32))
        if "ramping_coefficients" in trees:
            self.ramping = np.asarray(trees["ramping_coefficients"], np.float32)
        return self

    def init_params(self) -> None:
        """Random weights for every component not installed; zero text
        embeddings and a linear ramp when none were given."""
        if self.unet is None:
            warn_once("mvd_random",
                      "mvd_std multi-view diffusion runs with random-initialized weights "
                      "(no converted checkpoint): views are not meaningful")
            self._build_unet(None)
        if self.vae is None:
            self._build_vae(None)
        for i in range(2):
            if self.vision[i] is None:
                self._build_vision(i, None)
        ucfg = self.unet_cfg
        if self.uc_text_emb is None:
            self.uc_text_emb = np.zeros((1, 77, ucfg.context_dim), np.float32)
        if self.uc_text_emb_2 is None:
            self.uc_text_emb_2 = np.zeros((1, ucfg.pooled_dim), np.float32)
        if self.ramping is None:
            self.ramping = np.linspace(0.0, 1.0, self.uc_text_emb.shape[1], dtype=np.float32)

    # -- sampling --------------------------------------------------------

    def draw_shapes(self) -> dict:
        """The shapes of the run's standard normal draws: the initial grid
        latent, the condition image's posterior noise, each step's
        reference noise (both CFG rows) and ancestral noise."""
        cfg, lf, ch = self.cfg, self.latent_factor, self.unet_cfg.in_channels
        lat = (1, 3 * cfg.tile // lf, 2 * cfg.tile // lf, ch)
        cond = (cfg.cond_size // lf, cfg.cond_size // lf, self.vae_cfg.latent_channels)
        return {"latent": lat, "cond": (1, *cond), "ref": (cfg.steps, 2, *cond),
                "anc": (cfg.steps, *lat)}

    def _draws(self, noise: dict | None, seed: int) -> dict:
        noise = dict(noise or {})
        gen = None
        out = {}
        for key, shape in self.draw_shapes().items():
            if noise.get(key) is not None:
                t = noise[key]
                t = t if torch.is_tensor(t) else torch.from_numpy(np.array(t, np.float32))
                out[key] = t.to(self.device, torch.float32)
                continue
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            out[key] = torch.randn(shape, generator=gen, device=self.device)
        return out

    def condition(self, cond: torch.Tensor) -> tuple:
        """(S, S, 3) 8-bit condition image -> the CFG pair's context (2, 77,
        ctx), pooled (2, pooled_dim) and time ids (2, 6)."""
        cfg = self.cfg
        embeds = []
        for enc, vc in zip(self.vision, self.vision_cfgs):
            out = enc(preprocess_clip_image(cond / 255.0, vc.image_size)[None])
            embeds.append(out.get("image_embeds", out["pooled"]).float())
        global_embeds = torch.cat(embeds, dim=-1)[:, None, :]             # (1, 1, ctx)
        ramp = torch.from_numpy(self.ramping).to(self.device)[None, :, None]
        prompt = torch.from_numpy(self.uc_text_emb).to(self.device) + global_embeds * ramp
        pooled = torch.from_numpy(self.uc_text_emb_2).to(self.device)
        gh, gw = cfg.tile * 3, cfg.tile * 2
        tid = torch.tensor([[gh, gw, 0, 0, gh, gw]], dtype=torch.float32, device=self.device)
        return (torch.cat([torch.zeros_like(prompt), prompt]),
                torch.cat([torch.zeros_like(pooled), pooled]), tid.expand(2, -1))

    def sample(self, lat: torch.Tensor, cond_lat2: torch.Tensor, ctx2, pooled2, tid2,
               ref_noise: torch.Tensor, anc_noise: torch.Tensor) -> torch.Tensor:
        """The Euler-ancestral loop: each step a write pass over both noised
        reference rows, a read pass over both CFG rows of the grid latent,
        the guidance and the ancestral update."""
        cfg = self.cfg
        ts, sigmas = euler_ancestral_schedule(cfg.steps, timestep_spacing=cfg.timestep_spacing)
        ts_t, sig_t = (torch.from_numpy(a).to(self.device) for a in (ts, sigmas))
        for i in range(cfg.steps):
            sigma, sigma_next = sig_t[i], sig_t[i + 1]
            tb = (ts_t[i] / 1000.0).expand(2)
            scale = torch.sqrt(sigma ** 2 + 1.0)
            noisy_ref = (cond_lat2 + sigma * ref_noise[i]) / scale
            _, refs = self.unet(noisy_ref, tb, ctx2, pooled2, tid2, mode="write")
            eps2, _ = self.unet(torch.cat([lat, lat]) / scale, tb, ctx2, pooled2, tid2,
                                mode="read", refs=refs)
            eps = eps2[:1] + cfg.guidance * (eps2[1:] - eps2[:1])
            lat = euler_ancestral_step(lat, eps, sigma, sigma_next, anc_noise[i])
        return lat

    @torch.inference_mode()
    def generate_grid(self, rgba: np.ndarray, seed: int = 0, noise: dict | None = None
                      ) -> torch.Tensor:
        """The decoded (3 * tile, 2 * tile, 3) float32 grid in [0, 1], on the
        device, before the 8-bit step. `noise`: any of the `draw_shapes()`
        draws ("latent", "cond", "ref", "anc")."""
        self.init_params()
        cfg = self.cfg
        draws = self._draws(noise, seed)
        rgb = torch.from_numpy(np.ascontiguousarray(white_composite(rgba))).to(self.device)
        cond = resize_bicubic_8bit(rgb.permute(2, 0, 1)[None],
                                   (cfg.cond_size,) * 2)[0].permute(1, 2, 0)
        x = cond[None] / 127.5 - 1.0
        # Raw (unscaled) posterior samples; the negative row encodes black.
        cond_lat = self.vae.encode(x, noise=draws["cond"], scale=False)
        neg_lat = self.vae.encode(torch.zeros_like(x), scale=False)
        ctx2, pooled2, tid2 = self.condition(cond)
        _, sigmas = euler_ancestral_schedule(cfg.steps, timestep_spacing=cfg.timestep_spacing)
        # diffusers' init_noise_sigma: sigma_max, or sqrt(sigma_max^2 + 1)
        # for 'leading'.
        init_sigma = float(sigmas[0])
        if cfg.timestep_spacing == "leading":
            init_sigma = float(np.sqrt(sigmas[0] ** 2 + 1.0))
        lat = self.sample(draws["latent"] * init_sigma, torch.cat([neg_lat, cond_lat]), ctx2,
                          pooled2, tid2, draws["ref"], draws["anc"])
        dec = self.vae.decode(unscale_latents(lat))
        return unscale_image(dec[0]).clamp(0.0, 1.0)

    def generate_views(self, rgba: np.ndarray, seed: int = 0,
                       noise: dict | None = None) -> list[np.ndarray]:
        """Six (tile, tile, 3) uint8 views in azimuth order 0, 60, ..., 300."""
        grid = (self.generate_grid(rgba, seed, noise) * 255.0 + 0.5).to(torch.uint8)
        grid = grid.cpu().numpy()
        t = self.cfg.tile
        tiles = [grid[r * t:(r + 1) * t, c * t:(c + 1) * t] for r in range(3) for c in range(2)]
        return [tiles[i] for i in self.ORDER]

    def generate(self, rgba: np.ndarray, d_elev: float, d_azim: float,
                 d_dist: float = 0.0, seed: int = 0) -> np.ndarray:
        """The novel_views protocol: one cached grid run serves all six views."""
        img = np.ascontiguousarray(np.asarray(rgba))
        key = (img.tobytes()[:: max(1, img.nbytes // 4096)], img.shape, seed)
        if key not in self._cache:
            if len(self._cache) > 4:
                self._cache.clear()
            self._cache[key] = self.generate_views(rgba, seed=seed)
        return self._cache[key][int(round((d_azim % 360.0) / 60.0)) % 6]
