"""InvSR noise predictor: LR image + timestep -> inversion noise.

Counterpart of `labelany3d_tpu/models/diffusion/noise_predictor.py`, the
reference's `NoisePredictor` (a time-aware VAE-style encoder, checkpoint
`noise_predictor_sd_turbo_v5.pth`) whose predicted posterior replaces the
random starting noise of InvSR's partial diffusion inversion.

Structure: conv_in -> two levels of [time-conditioned resnet -> group-norm
attention] (downsample after the first) -> mid block (resnet, attention,
resnet) -> group norm + silu + conv_out -> (mean, logvar) over the SD
latent channels. Float32 by default, as in the JAX package. Public tensors
are NHWC; the convolutions run NCHW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, Dense, GroupNorm32, dense_attention


@dataclasses.dataclass(frozen=True)
class NoisePredictorConfig:
    in_channels: int = 3
    latent_channels: int = 4
    widths: Sequence[int] = (256, 512)
    layers_per_block: Sequence[int] = (3, 3)
    temb_channels: int = 512
    attention_head_dim: int = 64
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sd_turbo(**kw) -> "NoisePredictorConfig":
        """noise_predictor_sd_turbo_v5.pth shape."""
        return NoisePredictorConfig(**kw)

    @staticmethod
    def tiny_test(**kw) -> "NoisePredictorConfig":
        return NoisePredictorConfig(widths=(8, 16), layers_per_block=(1, 1), temb_channels=16,
                                    attention_head_dim=4, norm_num_groups=4, **kw)


def _norm(cfg: NoisePredictorConfig, ch: int) -> GroupNorm32:
    return GroupNorm32(min(cfg.norm_num_groups, ch), ch, eps=1e-6)


class _TimeResnet(nn.Module):
    def __init__(self, cfg: NoisePredictorConfig, c_in: int, c_out: int):
        super().__init__()
        d = cfg.dtype
        self.norm1 = _norm(cfg, c_in)
        self.conv1 = Conv(c_in, c_out, 3, d, padding=1)
        self.temb_proj = Dense(cfg.temb_channels, c_out, d)
        self.norm2 = _norm(cfg, c_out)
        self.conv2 = Conv(c_out, c_out, 3, d, padding=1)
        if c_in != c_out:
            self.skip = Conv(c_in, c_out, 1, d)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.skip(x) if hasattr(self, "skip") else x) + h


class _GNAttention(nn.Module):
    """Group norm -> multi-head qkv (with bias) -> out proj -> residual."""

    def __init__(self, cfg: NoisePredictorConfig, c: int):
        super().__init__()
        self.heads = max(c // cfg.attention_head_dim, 1)
        self.gn = _norm(cfg, c)
        self.q, self.k, self.v, self.proj = (Dense(c, c, cfg.dtype) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t = self.gn(x).flatten(2).transpose(1, 2)  # (B, HW, C)

        def split(z):
            return z.reshape(b, hh * ww, self.heads, -1)

        o = dense_attention(split(self.q(t)), split(self.k(t)), split(self.v(t)))
        o = self.proj(o.reshape(b, hh * ww, c))
        return x + o.transpose(1, 2).reshape(b, c, hh, ww)


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, freq_shift=0): cos | sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class NoisePredictor(nn.Module):
    """(B, H, W, 3) image in [0, 1] + (B,) timestep -> dict of mean and
    logvar, each (B, H/2^(L-1), W/2^(L-1), latent_channels)."""

    def __init__(self, cfg: NoisePredictorConfig):
        super().__init__()
        self.cfg = cfg
        d, ws = cfg.dtype, list(cfg.widths)
        self.t1 = Dense(max(128, ws[0]), cfg.temb_channels, d)
        self.t2 = Dense(cfg.temb_channels, cfg.temb_channels, d)
        self.conv_in = Conv(cfg.in_channels, ws[0], 3, d, padding=1)
        c = ws[0]
        for i, w in enumerate(ws):
            for j in range(cfg.layers_per_block[i]):
                self.add_module(f"down{i}_res{j}", _TimeResnet(cfg, c, w))
                c = w
                self.add_module(f"down{i}_attn{j}", _GNAttention(cfg, c))
            if i != len(ws) - 1:
                self.add_module(f"down{i}_ds", Conv(c, w, 3, d, stride=2, padding=0))
        self.mid_res1 = _TimeResnet(cfg, c, c)
        self.mid_attn = _GNAttention(cfg, c)
        self.mid_res2 = _TimeResnet(cfg, c, c)
        self.norm_out = _norm(cfg, c)
        self.conv_out = Conv(c, 2 * cfg.latent_channels, 3, d, padding=1)

    def forward(self, image: torch.Tensor, timestep: torch.Tensor,
                center_input_sample: bool = True) -> dict:
        cfg = self.cfg
        x = image.float()
        if center_input_sample:
            x = 2.0 * x - 1.0
        temb = _timestep_embedding(timestep, max(128, cfg.widths[0]))
        temb = self.t2(F.silu(self.t1(temb)))
        h = self.conv_in(x.permute(0, 3, 1, 2))
        for i in range(len(cfg.widths)):
            for j in range(cfg.layers_per_block[i]):
                h = getattr(self, f"down{i}_res{j}")(h, temb)
                h = getattr(self, f"down{i}_attn{j}")(h)
            if i != len(cfg.widths) - 1:
                # Downsample2D with padding=0: an asymmetric (0, 1) pad.
                h = getattr(self, f"down{i}_ds")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb)), temb)
        h = self.conv_out(F.silu(self.norm_out(h))).permute(0, 2, 3, 1)
        mean, logvar = h.chunk(2, dim=-1)
        return {"mean": mean, "logvar": logvar.clamp(-30.0, 20.0)}

    def sample(self, image: torch.Tensor, timestep: torch.Tensor,
               noise: torch.Tensor | None = None, generator: torch.Generator | None = None,
               sample_posterior: bool = True) -> torch.Tensor:
        """The posterior sample mean + exp(logvar / 2) * noise. `noise` is a
        standard normal draw of the mean's shape; without it one is drawn
        from `generator`."""
        out = self(image, timestep)
        if not sample_posterior:
            return out["mean"]
        if noise is None:
            noise = torch.randn(out["mean"].shape, generator=generator,
                                device=out["mean"].device)
        return out["mean"] + torch.exp(0.5 * out["logvar"]) * noise


def convert_noise_predictor(state: dict, cfg: NoisePredictorConfig) -> dict:
    """`noise_predictor_sd_turbo_v5.pth` (diffusers TimeAwareEncoder names,
    `encoder.*` prefix) -> NoisePredictor's Flax-layout params."""
    from labelany3d_tpu_torch.models.diffusion.convert import _conv, _lin, _norm as _nrm

    if any(k.startswith("encoder.") for k in state):
        state = ({k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
                 | {k: v for k, v in state.items() if not k.startswith("encoder.")})

    def resnet(pre):
        p = {"norm1": _nrm(state, pre + "norm1."), "conv1": _conv(state, pre + "conv1."),
             "temb_proj": _lin(state, pre + "time_emb_proj."),
             "norm2": _nrm(state, pre + "norm2."), "conv2": _conv(state, pre + "conv2.")}
        if pre + "conv_shortcut.weight" in state:
            p["skip"] = _conv(state, pre + "conv_shortcut.")
        return p

    def attn(pre):
        return {"gn": _nrm(state, pre + "group_norm."), "q": _lin(state, pre + "to_q."),
                "k": _lin(state, pre + "to_k."), "v": _lin(state, pre + "to_v."),
                "proj": _lin(state, pre + "to_out.0.")}

    params: dict = {
        "conv_in": _conv(state, "conv_in."),
        "t1": _lin(state, "time_embedding.linear_1."),
        "t2": _lin(state, "time_embedding.linear_2."),
        "norm_out": _nrm(state, "conv_norm_out."),
        "conv_out": _conv(state, "conv_out."),
        "mid_res1": resnet("mid_block.resnets.0."),
        "mid_attn": attn("mid_block.attentions.0."),
        "mid_res2": resnet("mid_block.resnets.1."),
    }
    for i in range(len(cfg.widths)):
        for j in range(cfg.layers_per_block[i]):
            params[f"down{i}_res{j}"] = resnet(f"down_blocks.{i}.resnets.{j}.")
            params[f"down{i}_attn{j}"] = attn(f"down_blocks.{i}.attentions.{j}.")
        if i != len(cfg.widths) - 1:
            params[f"down{i}_ds"] = _conv(state, f"down_blocks.{i}.downsamplers.0.conv.")
    return params
