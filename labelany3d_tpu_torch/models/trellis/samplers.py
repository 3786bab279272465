"""Flow-matching Euler sampler with classifier-free guidance.

Counterpart of `labelany3d_tpu/models/trellis/samplers.py` (TRELLIS
`FlowEulerSampler`): x_{t+dt} = x_t + v(x_t, t) dt over a linear t: 1 -> 0
schedule with optional rescaling, and CFG mixing
v = (1 + s) v_cond - s v_uncond. A Python loop over the steps replaces the
JAX package's `lax.scan`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class FlowSamplerConfig:
    steps: int = 25
    cfg_strength: float = 5.0     # TRELLIS defaults: 7.5 (ss) / 3.0 (slat)
    sigma_min: float = 1e-5
    rescale_t: float = 1.0        # TRELLIS rescale_t ~3.0 for ss sampling


def _timesteps(cfg: FlowSamplerConfig) -> torch.Tensor:
    """t: 1 -> 0 in `steps` steps, rescaled r t / (1 + (r - 1) t); float32."""
    ts = torch.linspace(1.0, 0.0, cfg.steps + 1, dtype=torch.float32)
    r = cfg.rescale_t
    return r * ts / (1.0 + (r - 1.0) * ts)


def flow_euler_sample(velocity_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      noise: torch.Tensor,
                      cfg: FlowSamplerConfig = FlowSamplerConfig()) -> torch.Tensor:
    """Integrate from t = 1 (noise) to t = 0 (sample): x <- x + (t_next - t) v,
    `velocity_fn(x, t)` with t of shape (B,)."""
    ts = _timesteps(cfg).to(noise.device)
    x = noise
    for i in range(cfg.steps):
        v = velocity_fn(x, ts[i].expand(x.shape[0]))
        x = x + (ts[i + 1] - ts[i]) * v
    return x


def cfg_velocity(model_fn: Callable[..., torch.Tensor], cond_tokens: torch.Tensor,
                 uncond_tokens: torch.Tensor, strength: float):
    """Classifier-free-guided velocity (1 + s) v_cond - s v_uncond, two
    model evaluations."""

    def fn(x, t):
        v_c = model_fn(x, t, cond_tokens)
        v_u = model_fn(x, t, uncond_tokens)
        return (1.0 + strength) * v_c - strength * v_u

    return fn
