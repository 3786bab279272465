"""Layers that compute in a configured dtype, as Flax modules with `dtype` do.

A Flax `nn.Dense(dtype=bf16)` keeps its parameters in their own dtype and
casts both parameters and input to `dtype` on every call. `Dense` and `Conv`
do the same, so a model holds f32 or pre-cast bf16 weights alike. Parameter
names are PyTorch's (`weight`, `bias`); `models/weights.py` maps Flax trees
onto them.
"""

from __future__ import annotations

import contextlib

import numpy as np
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

    @staticmethod
    def stacked(denses, x: torch.Tensor) -> torch.Tensor:
        """`forward` of each of `denses` over its slice of x (S, ..., in), as
        one batched product: the S weights stacked, then cast as `forward`
        casts them."""
        d = denses[0].compute_dtype
        w = torch.stack([m.weight for m in denses]).to(d).transpose(1, 2)
        b = torch.stack([m.bias for m in denses]).to(d)[:, None]
        return torch.baddbmm(b, x.to(d).flatten(1, -2), w).unflatten(1, x.shape[1:-1])


class Conv(nn.Conv2d):
    """NCHW convolution; `padding='same'` for odd kernels at stride 1 matches
    Flax's default SAME padding (with `dilation`, pad `dilation * (k // 2)`);
    `groups` is Flax's `feature_group_count`. A float32 conv (the MoGe and
    DepthPro output convs) runs with TF32 off, as the JAX package pins them
    to f32."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype,
                 stride: int = 1, padding: int | None = None, bias: bool = True,
                 dilation: int = 1, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=dilation * (kernel // 2) if padding is None else padding,
                         dilation=dilation, groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        with full_f32() if d == torch.float32 else contextlib.nullcontext():
            return F.conv2d(x.to(d), self.weight.to(d), _cast(self.bias, d),
                            self.stride, self.padding, self.dilation, self.groups)


def replicate_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """NCHW edge pad of `p` pixels on each side (torch's 'replicate' mode),
    from concatenated edge slices: their backward sums in a fixed order,
    where `F.pad`'s replicate backward adds with atomics on CUDA and so
    differs from run to run (a training step would not repeat)."""
    h, w = x.shape[-2:]
    x = torch.cat([x[..., :1, :].expand(*x.shape[:-2], p, w), x,
                   x[..., -1:, :].expand(*x.shape[:-2], p, w)], dim=-2)
    return torch.cat([x[..., :1].expand(*x.shape[:-1], p), x,
                      x[..., -1:].expand(*x.shape[:-1], p)], dim=-1)


class Conv3Replicate(Conv):
    """3x3 convolution after a one-pixel edge pad (torch
    `padding_mode='replicate'`; the JAX package's `_conv3_replicate`)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__(in_ch, out_ch, 3, dtype, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(replicate_pad(x, 1))


class ConvTranspose(nn.ConvTranspose2d):
    """Flax `nn.ConvTranspose` with kernel == stride and `padding='SAME'`
    (`transpose_kernel=False`): out[s*i + a] = x[i] * w_flax[s-1-a] per
    spatial axis. A torch transposed convolution gives out[s*i + a] =
    x[i] * w[a], so `models/weights.py` flips the Flax kernel in both spatial
    axes when it carries one across."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, stride, stride=stride, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        with full_f32() if d == torch.float32 else contextlib.nullcontext():
            return F.conv_transpose2d(x.to(d), self.weight.to(d), _cast(self.bias, d),
                                      self.stride)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32, by default with Flax's epsilon (1e-6)."""

    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__(width, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Non-affine LayerNorm over the last axis in float32 (Flax `LayerNorm`
    with `use_bias=False, use_scale=False, dtype=float32`)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


class Conv3d(nn.Conv3d):
    """NCDHW 3D convolution at stride 1 with SAME padding for odd kernels
    (Flax `nn.Conv` over NDHWC), computed in `dtype`; float32 runs with TF32
    off."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        with full_f32() if d == torch.float32 else contextlib.nullcontext():
            return F.conv3d(x.to(d), self.weight.to(d), _cast(self.bias, d), 1, self.padding)


class GroupNorm32(nn.GroupNorm):
    """NCHW GroupNorm computed in float32 (Flax `nn.GroupNorm` takes its
    statistics in float32 and returns float32 beside f32 scales)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) against k, v (B, Sk, H, D) in
    plain PyTorch: both products and the softmax in float32, scale
    1/sqrt(D), an additive `bias` (broadcast to (B, H, Sq, Sk)) added to the
    scaled scores in float32, keys after the query masked with `causal`.
    Returns q.dtype. The attention the JAX package leaves to XLA
    (`jax.nn.dot_product_attention`): no kernel of the repository stands
    for it, and K2's plain version is kept apart so that its count reads
    only K2's calls."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    with full_f32():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / float(q.shape[-1]) ** 0.5)
        if bias is not None:
            s = s + bias.float()
        if causal:
            sq, sk = s.shape[-2:]
            s = s.masked_fill(torch.ones(sq, sk, dtype=torch.bool, device=s.device)
                              .triu(1), float("-inf"))
        out = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W), a view."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C), a view."""
    return x.permute(0, 2, 3, 1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _bicubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float32 weights of one axis of `jax.image.resize(...,
    'bicubic', antialias=False)` (`scale_and_translate`'s weight matrix):
    half-pixel centres, Keys' kernel not widened, renormalised over the taps
    inside the image, zero for a sample outside it."""
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    dist = (sample[:, None] - torch.arange(n_in, dtype=torch.float32, device=device)).abs()
    w = _keys_cubic(dist)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """NCHW resize with half-pixel centres, as `jax.image.resize` (whose
    `antialias` defaults to True): downsampling widens the kernel by the
    scale and renormalises it over the taps inside the image, and 'bicubic'
    is Keys' kernel with a = -0.5. PyTorch's antialiased modes compute the
    same weights. Antialiasing changes nothing on an upsampled axis, so a
    bilinear upsample takes PyTorch's plain path (any dtype); bicubic takes
    the antialiased one, since PyTorch's plain bicubic uses a = -0.75.
    Bicubic without antialias (the SVRM encoder's position grid) applies
    JAX's weight matrices on both axes in float32 (`_bicubic_weights`)."""
    if method == "bicubic" and not antialias:
        wh = _bicubic_weights(x.shape[-2], size[0], x.device)
        ww = _bicubic_weights(x.shape[-1], size[1], x.device)
        with full_f32():
            return torch.einsum("oh,nchw,pw->ncop", wh, x.float(), ww).to(x.dtype)
    down = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(size), mode=method, align_corners=False,
                         antialias=method == "bicubic" or (antialias and down))


def _resize_8bit(x: torch.Tensor, size: tuple[int, int], method: str) -> torch.Tensor:
    """NCHW 8-bit values resized as Pillow resizes an 8-bit image: the
    horizontal pass first, each pass's result rounded half up and clipped to
    [0, 255], as Pillow stores it in 8 bits between the passes. Pillow sums
    in fixed point, so a value whose exact sum lies near .5 may land one
    level away. Returns float32 integers."""
    y = x.float()
    for hw in ((y.shape[-2], size[1]), tuple(size)):
        if tuple(y.shape[-2:]) != hw:
            y = torch.floor(resize(y, hw, method=method) + 0.5).clamp(0, 255)
    return y


def resize_bicubic_8bit(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Pillow's `Image.resize(size, BICUBIC)` on 8-bit values: Keys' kernel
    (a = -0.5, widened and renormalised as `resize` does)."""
    return _resize_8bit(x, size, "bicubic")


def resize_bilinear_8bit(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Pillow's `Image.resize(size, BILINEAR)` on 8-bit values: the triangle
    filter, widened by the scale and renormalised when downsampling (PyTorch's
    antialiased bilinear), plain bilinear when upsampling (the same weights)."""
    return _resize_8bit(x, size, "bilinear")


def white_composite(rgba: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3 or 4) -> uint8 RGB over a white background, in the
    JAX package's numpy arithmetic (float32, truncated)."""
    img = np.asarray(rgba)
    rgb = img[..., :3]
    if img.shape[-1] == 4:
        a = img[..., 3:4].astype(np.float32) / 255.0
        rgb = (rgb * a + 255.0 * (1.0 - a)).astype(np.uint8)
    return rgb
