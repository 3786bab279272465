"""Layers that compute in a configured dtype, as Flax modules with `dtype` do.

A Flax `nn.Dense(dtype=bf16)` keeps its parameters in their own dtype and
casts both parameters and input to `dtype` on every call. `Dense` and `Conv`
do the same, so a model holds f32 or pre-cast bf16 weights alike. Parameter
names are PyTorch's (`weight`, `bias`); `models/weights.py` maps Flax trees
onto them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.utils.precision import full_f32


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), _cast(self.bias, d))


class Conv(nn.Conv2d):
    """NCHW convolution; `padding='same'` for odd kernels at stride 1 matches
    Flax's default SAME padding. A float32 conv (the MoGe and DepthPro
    output convs) runs with TF32 off, as the JAX package pins them to f32."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype,
                 stride: int = 1, padding: int | None = None, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        with full_f32() if d == torch.float32 else contextlib.nullcontext():
            return F.conv2d(x.to(d), self.weight.to(d), _cast(self.bias, d),
                            self.stride, self.padding)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32 with Flax's epsilon (1e-6)."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centres (`jax.image.resize`'s
    'bilinear'). Upsampling agrees with JAX exactly; for downsampling JAX
    antialiases with a widened triangle kernel, which `antialias=True` gives."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=antialias)
