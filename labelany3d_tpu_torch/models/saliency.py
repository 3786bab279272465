"""IS-Net salient-object segmentation (the reference's rembg role).

Counterpart of `labelany3d_tpu/models/saliency.py`:

  * `segment_completed`: after amodal completion the reference re-segments
    the completed crop with rembg's `isnet-general-use` session
    (`post_process_mask=True`) and forces the original mask's pixels
    opaque;
  * `RembgSegmenter.remove`: background removal before reconstruction when
    a crop has no alpha channel (`TrellisPipeline.preprocess`).

The model is the public IS-Net / DIS architecture (ISNetDIS, a U^2-Net of
residual U-blocks) with inference-mode BatchNorm whose running statistics
are parameters (`bn_mean`, `bn_var`, `bn_scale`, `bn_bias`, the Flax
tree's names). Float32, NCHW inside; `convert_isnet` renames the released
`isnet-general-use.pth` state dict. Max pooling takes ceil mode (odd sizes
padded with -inf), and the upsampling is bilinear with half-pixel centres,
as `jax.image.resize` and torch's `interpolate(align_corners=False)`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Conv, resize, resize_bilinear_8bit
from labelany3d_tpu_torch.utils.device import resolve_device

# (block kind, mid channels, out channels) per stage. Kind "4F" is the
# fully dilated RSU (no pooling); integers are the RSU depth L.
_Stage = tuple[Any, int, int]


@dataclasses.dataclass(frozen=True)
class ISNetConfig:
    conv_in: int = 64
    # encoder stage1..stage6 (ISNetDIS.__init__)
    enc: Sequence[_Stage] = (
        (7, 32, 64), (6, 32, 128), (5, 64, 256),
        (4, 128, 512), ("4F", 256, 512), ("4F", 256, 512),
    )
    # decoder stage5d..stage1d
    dec: Sequence[_Stage] = (
        ("4F", 256, 512), (4, 128, 256), (5, 64, 128),
        (6, 32, 64), (7, 16, 64),
    )

    @staticmethod
    def general_use(**kw) -> "ISNetConfig":
        """isnet-general-use.pth shape (input 1024^2)."""
        return ISNetConfig(**kw)

    @staticmethod
    def tiny_test(**kw) -> "ISNetConfig":
        return ISNetConfig(
            conv_in=8,
            enc=((7, 4, 8), (6, 4, 16), (5, 8, 32), (4, 16, 64), ("4F", 32, 64), ("4F", 32, 64)),
            dec=(("4F", 32, 64), (4, 16, 32), (5, 8, 16), (6, 4, 8), (7, 2, 8)),
            **kw)


class _REBNConv(nn.Module):
    """Dilated 3x3 conv + BatchNorm (affine, running statistics) + ReLU."""

    def __init__(self, c_in: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = Conv(c_in, out_ch, 3, torch.float32, padding=dirate, dilation=dirate)
        self.bn_mean = nn.Parameter(torch.zeros(out_ch))
        self.bn_var = nn.Parameter(torch.ones(out_ch))
        self.bn_scale = nn.Parameter(torch.ones(out_ch))
        self.bn_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_s1(x)

        def c(p):
            return p[:, None, None]

        x = (x - c(self.bn_mean)) * torch.rsqrt(c(self.bn_var) + 1e-5) * c(self.bn_scale) \
            + c(self.bn_bias)
        return F.relu(x)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, stride=2, ceil_mode=True)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of `src` to `tar`'s size (half-pixel centres)."""
    if src.shape[-2:] == tar.shape[-2:]:
        return src
    return resize(src, tuple(tar.shape[-2:]), method="bilinear")


class _RSU(nn.Module):
    """Residual U-block RSU-L: an L-level mini U-Net with a residual from
    the stage-input projection."""

    def __init__(self, c_in: int, depth: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.depth = depth
        self.rebnconvin = _REBNConv(c_in, out_ch)
        c = out_ch
        for i in range(1, depth):
            self.add_module(f"rebnconv{i}", _REBNConv(c, mid_ch))
            c = mid_ch
        self.add_module(f"rebnconv{depth}", _REBNConv(mid_ch, mid_ch, dirate=2))
        for i in range(depth - 1, 0, -1):
            self.add_module(f"rebnconv{i}d", _REBNConv(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.depth
        hxin = self.rebnconvin(x)
        feats, h = [], hxin
        for i in range(1, L):
            h = getattr(self, f"rebnconv{i}")(h)
            feats.append(h)
            if i <= L - 2:
                h = _pool2(h)
        h = getattr(self, f"rebnconv{L}")(h)
        for i in range(L - 1, 0, -1):
            f = feats[i - 1]
            h = getattr(self, f"rebnconv{i}d")(torch.cat([_up_like(h, f), f], dim=1))
        return h + hxin


class _RSU4F(nn.Module):
    """Fully dilated RSU: dilations 1, 2, 4, 8 instead of pooling."""

    def __init__(self, c_in: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = _REBNConv(c_in, out_ch)
        self.rebnconv1 = _REBNConv(out_ch, mid_ch, 1)
        self.rebnconv2 = _REBNConv(mid_ch, mid_ch, 2)
        self.rebnconv3 = _REBNConv(mid_ch, mid_ch, 4)
        self.rebnconv4 = _REBNConv(mid_ch, mid_ch, 8)
        self.rebnconv3d = _REBNConv(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = _REBNConv(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = _REBNConv(2 * mid_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], dim=1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], dim=1))
        return self.rebnconv1d(torch.cat([h2d, h1], dim=1)) + hxin


def _make_stage(c_in: int, spec: _Stage) -> nn.Module:
    kind, mid, out = spec
    return _RSU4F(c_in, mid, out) if kind == "4F" else _RSU(c_in, int(kind), mid, out)


class ISNet(nn.Module):
    """(B, H, W, 3), x/255 - 0.5 -> the side logits d1..d6, each upsampled
    to (B, H, W, 1); sigmoid(d1) is the saliency matte."""

    def __init__(self, cfg: ISNetConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv(3, cfg.conv_in, 3, torch.float32, stride=2, padding=1)
        c, enc_out = cfg.conv_in, []
        for i, spec in enumerate(cfg.enc):
            self.add_module(f"stage{i + 1}", _make_stage(c, spec))
            c = spec[2]
            enc_out.append(c)
        n = len(cfg.dec)
        for j, spec in enumerate(cfg.dec):
            skip = enc_out[len(cfg.enc) - 2 - j]
            self.add_module(f"stage{n - j}d", _make_stage(c + skip, spec))
            c = spec[2]
        # side1..side5 on the decoder's outputs (stage1d first), side6 on
        # the last encoder stage.
        heads = [spec[2] for spec in cfg.dec][::-1] + [enc_out[-1]]
        for i, ch in enumerate(heads):
            self.add_module(f"side{i + 1}", Conv(ch, 1, 3, torch.float32, padding=1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.cfg
        inp = x.permute(0, 3, 1, 2).float()
        hx = self.conv_in(inp)
        enc = []
        for i in range(len(cfg.enc)):
            hx = getattr(self, f"stage{i + 1}")(hx)
            enc.append(hx)
            if i < len(cfg.enc) - 1:
                hx = _pool2(hx)
        h, dec, n = enc[-1], [], len(cfg.dec)
        for j in range(n):
            skip = enc[len(cfg.enc) - 2 - j]
            h = getattr(self, f"stage{n - j}d")(torch.cat([_up_like(h, skip), skip], dim=1))
            dec.append(h)
        sides = []
        for i, f in enumerate(dec[::-1] + [enc[-1]]):
            d = getattr(self, f"side{i + 1}")(f)
            sides.append(_up_like(d, inp).permute(0, 2, 3, 1))
        return sides


def convert_isnet(state: dict, cfg: ISNetConfig) -> dict:
    """isnet-general-use.pth (DIS ISNetDIS state dict) -> ISNet's
    Flax-layout params."""

    def conv(pre):
        p = {"kernel": np.transpose(np.asarray(state[pre + "weight"]), (2, 3, 1, 0))}
        if pre + "bias" in state:
            p["bias"] = np.asarray(state[pre + "bias"])
        return p

    def rebn(pre):
        return {"conv_s1": conv(pre + "conv_s1."),
                "bn_scale": np.asarray(state[pre + "bn_s1.weight"]),
                "bn_bias": np.asarray(state[pre + "bn_s1.bias"]),
                "bn_mean": np.asarray(state[pre + "bn_s1.running_mean"]),
                "bn_var": np.asarray(state[pre + "bn_s1.running_var"])}

    def rsu(pre, spec):
        n = 4 if spec[0] == "4F" else int(spec[0])
        p = {"rebnconvin": rebn(pre + "rebnconvin.")}
        for i in range(1, n + 1):
            p[f"rebnconv{i}"] = rebn(pre + f"rebnconv{i}.")
        for i in range(1, n):
            p[f"rebnconv{i}d"] = rebn(pre + f"rebnconv{i}d.")
        return p

    params: dict = {"conv_in": conv("conv_in.")}
    for i, spec in enumerate(cfg.enc):
        params[f"stage{i + 1}"] = rsu(f"stage{i + 1}.", spec)
    for j, spec in enumerate(cfg.dec):
        name = f"stage{len(cfg.dec) - j}d"
        params[name] = rsu(name + ".", spec)
    for i in range(6):
        params[f"side{i + 1}"] = conv(f"side{i + 1}.")
    return params


def post_process_mask(mask_u8: np.ndarray) -> np.ndarray:
    """rembg's `post_process(mask)`: 3x3-ellipse morphological open, 5x5
    Gaussian blur (sigma 2), re-binarised at 127. OpenCV, imported here."""
    import cv2

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    m = cv2.morphologyEx(mask_u8, cv2.MORPH_OPEN, kernel)
    m = cv2.GaussianBlur(m, (5, 5), sigmaX=2, sigmaY=2, borderType=cv2.BORDER_DEFAULT)
    return np.where(m < 127, 0, 255).astype(np.uint8)


class RembgSegmenter:
    """`rembg.remove(...)` role: ISNet saliency matte -> RGBA cutout, on
    `device`.

    Session preprocessing as rembg's IsnetSession: Pillow's BILINEAR resize
    to `input_size`^2 (`layers.resize_bilinear_8bit`), x/255 - 0.5, the
    forward, min-max normalised sigmoid(d1), 8 bits (truncated), resized
    back with BILINEAR. `params` is a Flax-layout tree (from
    `convert_isnet`); without it the weights are random from a
    `torch.Generator` seeded with `seed`."""

    def __init__(self, cfg: ISNetConfig | None = None, params=None, input_size: int = 1024,
                 post_process: bool = True, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or ISNetConfig.general_use()
        self.params = params
        self.input_size = input_size
        self.post_process = post_process
        self.seed = seed
        self.model: ISNet | None = None

    def _ensure(self) -> None:
        if self.model is not None:
            return
        from labelany3d_tpu_torch.models.weights import flax_to_state_dict, init_params_

        with torch.device(self.device):
            model = ISNet(self.cfg)
        if self.params is None:
            from labelany3d_tpu_torch.utils.logging import warn_once

            warn_once("isnet_random",
                      "ISNet saliency segmenter runs random-initialized (no converted "
                      "isnet-general-use checkpoint): masks are meaningless until weights "
                      "are installed")
            init_params_(model, torch.Generator(device=self.device).manual_seed(self.seed))
        else:
            model.load_state_dict(flax_to_state_dict(self.params, model))
            self.params = None  # the model holds them now
        self.model = model.eval().requires_grad_(False)

    @torch.inference_mode()
    def mask(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) -> float32 saliency matte (H, W) in [0, 1]."""
        self._ensure()
        h, w = rgb.shape[:2]
        s = self.input_size
        x = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device).permute(2, 0, 1)[None]
        proc = resize_bilinear_8bit(x, (s, s))[0].permute(1, 2, 0)
        pred = torch.sigmoid(self.model((proc / 255.0 - 0.5)[None])[0][0, ..., 0])
        lo, hi = pred.min(), pred.max()
        pred = (pred - lo) / torch.clamp(hi - lo, min=1e-8)
        m8 = (pred * 255).to(torch.uint8)
        m = resize_bilinear_8bit(m8[None, None], (h, w))[0, 0].to(torch.uint8).cpu().numpy()
        if self.post_process:
            m = post_process_mask(m)
        return m.astype(np.float32) / 255.0

    def remove(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) -> RGBA uint8 cutout (alpha = matte)."""
        rgb = np.asarray(rgb)
        if rgb.shape[-1] == 4:
            rgb = rgb[..., :3]
        a = (self.mask(rgb) * 255).astype(np.uint8)
        return np.concatenate([rgb, a[..., None]], axis=-1)


def segment_completed(completed_rgb: np.ndarray, original_rgba: np.ndarray,
                      segmenter) -> np.ndarray:
    """Re-segment the completed crop for the amodal mask, forcing the
    original mask's pixels opaque with the completed RGB."""
    completed_rgb = np.asarray(completed_rgb)
    if completed_rgb.shape[-1] == 4:
        completed_rgb = completed_rgb[..., :3]
    orig_mask = np.asarray(original_rgba)[..., -1].astype(np.float32) / 255.0 > 0.5
    out = segmenter.remove(completed_rgb)
    out[..., :3][orig_mask] = completed_rgb[orig_mask]
    out[..., 3][orig_mask] = 255
    return out
