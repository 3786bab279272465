"""DDIM sampling with (dual) classifier-free guidance.

Counterpart of `labelany3d_tpu/models/diffusion/sampler.py`: 50-step DDIM
for the amodal completion, few-step partial inversion for InvSR, and plain
CFG for Zero123, over SD's scaled-linear beta schedule. The step loop is a
Python loop where the JAX package runs `lax.scan`. The guidance wrappers
evaluate their branches as one batch: the same function as the JAX
package's separate calls, in one UNet forward a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

NUM_TRAIN_TIMESTEPS = 1000


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    steps: int = 50
    guidance_scale: float = 7.5
    image_guidance_scale: float | None = None  # InstructPix2Pix dual CFG
    eta: float = 0.0
    start_timestep: int = NUM_TRAIN_TIMESTEPS - 1  # lower for partial inversion


def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in its own float32 arithmetic:
    start * (1 - i / n) + stop * (i / n) for i < n = num - 1, then stop.
    Its points can land just under an integer (250 -> 0 in 5 steps gives
    99.99999 for 100), which the sampler's int32 truncation keeps."""
    n = num - 1
    frac = torch.arange(n, dtype=torch.float32, device=device) / float(n)
    pts = torch.tensor(start, dtype=torch.float32) * (1 - frac) \
        + torch.tensor(stop, dtype=torch.float32) * frac
    return torch.cat([pts, torch.tensor([stop], dtype=torch.float32, device=device)])


def make_alphas(device=None) -> torch.Tensor:
    """SD scaled-linear schedule: alpha_bar_t over 1000 train steps (float32)."""
    betas = linspace_f32(0.00085 ** 0.5, 0.012 ** 0.5, NUM_TRAIN_TIMESTEPS, device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def add_noise(x0: torch.Tensor, noise: torch.Tensor, timestep: int,
              alphas_bar: torch.Tensor | None = None) -> torch.Tensor:
    """Forward-diffuse a clean latent to `timestep` (partial inversion)."""
    ab = make_alphas(x0.device) if alphas_bar is None else alphas_bar
    a = ab[timestep]
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def ddim_timesteps(cfg: DDIMConfig) -> list[int]:
    """The train timesteps the sampler visits: `steps + 1` points from
    `start_timestep` down to 0, spaced as `jnp.linspace` spaces them in
    float32 and truncated to int32, as the JAX package does."""
    return linspace_f32(cfg.start_timestep, 0.0, cfg.steps + 1).to(torch.int32).tolist()


def ddim_sample(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                noise: torch.Tensor, cfg: DDIMConfig = DDIMConfig()) -> torch.Tensor:
    """Deterministic DDIM from `start_timestep` down to 0.

    `eps_fn(x, t)` predicts noise at the integer train timestep t, a (B,)
    tensor (already guidance-mixed by the caller)."""
    ab = make_alphas(noise.device)
    ts = ddim_timesteps(cfg)
    x = noise
    for i in range(cfg.steps):
        t, t_prev = ts[i], ts[i + 1]
        a_t = ab[t]
        a_prev = ab[t_prev] if t_prev > 0 else torch.ones_like(a_t)
        eps = eps_fn(x, torch.full(x.shape[:1], t, dtype=torch.int32, device=x.device))
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return x


def cfg_eps(model_fn: Callable[..., torch.Tensor], cond_ctx: torch.Tensor,
            uncond_ctx: torch.Tensor, scale: float):
    """Standard CFG, eps_u + s (eps_c - eps_u), the two branches as one
    batch of 2B."""

    def fn(x, t):
        e = model_fn(torch.cat([x, x]), torch.cat([t, t]), torch.cat([cond_ctx, uncond_ctx]))
        e_c, e_u = e.chunk(2)
        return e_u + scale * (e_c - e_u)

    return fn


def dual_cfg_eps(model_fn: Callable[..., torch.Tensor], cond_ctx: torch.Tensor,
                 uncond_ctx: torch.Tensor, image_latent: torch.Tensor,
                 zero_image_latent: torch.Tensor, text_scale: float, image_scale: float):
    """InstructPix2Pix dual guidance (guidance 8.5, image guidance 1.5 in
    the reference):

      eps = e(z, 0_img, 0_txt)
          + s_img (e(z, img, 0_txt) - e(z, 0_img, 0_txt))
          + s_txt (e(z, img, txt)  - e(z, img, 0_txt))

    `model_fn(x_with_image_latent, t, ctx)`; the image latent is
    channel-concatenated (NHWC) here. The three branches run as one batch
    of 3B."""

    def fn(x, t):
        x_img = torch.cat([x, image_latent], dim=-1)
        x_zero = torch.cat([x, zero_image_latent], dim=-1)
        e = model_fn(torch.cat([x_img, x_img, x_zero]), torch.cat([t, t, t]),
                     torch.cat([cond_ctx, uncond_ctx, uncond_ctx]))
        e_full, e_img, e_none = e.chunk(3)
        return e_none + image_scale * (e_img - e_none) + text_scale * (e_full - e_img)

    return fn
