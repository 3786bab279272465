# Frozen copy of labelany3d_tpu_torch/models/depth_pro.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""DepthPro-equivalent metric monocular depth.

Counterpart of `labelany3d_tpu/models/depth_pro.py`:

  * `DepthProModel` / `depth_pro_infer`: the global view (downsampled,
    antialiased) and the 2x2 half-size tiling run as one batched ViT call,
    then a small conv fusion decoder predicts canonical inverse depth, made
    metric by the focal length;
  * `DepthPro35` / `depth_pro35_infer`: the released DepthPro graph (35
    overlapping 384-px patches of a three-level pyramid through one batched
    patch-encoder call, an image encoder, a multi-resolution conv decoder and
    the FoV network), whose parameter names take a converted checkpoint
    (`models/convert.py::convert_depth_pro`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, ConvTranspose, Dense, resize
from .vit import ViT, ViTConfig


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    backbone: ViTConfig = dataclasses.field(default_factory=ViTConfig.large)
    fusion_width: int = 256
    input_size: int = 768
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "DepthProConfig":
        return DepthProConfig(backbone=ViTConfig.tiny_test(), fusion_width=32, input_size=64)


class FusionBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype, skip: bool = False):
        super().__init__()
        if skip:
            self.skip_proj = Conv(features, features, 1, dtype)
        self.c1 = Conv(features, features, 3, dtype)
        self.c2 = Conv(features, features, 3, dtype)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.skip_proj(skip)
        x = x + self.c2(F.gelu(self.c1(x)))
        return resize(x, (x.shape[2] * 2, x.shape[3] * 2))


class DepthProModel(nn.Module):
    """Image (B, H, W, 3) -> canonical inverse depth (B, H, W), float32."""

    def __init__(self, cfg: DepthProConfig, image_hw: tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        p = cfg.backbone.patch_size
        c, fw = cfg.backbone.width, cfg.fusion_width
        self.encoder = ViT(cfg.backbone, (image_hw[0] // 2 // p, image_hw[1] // 2 // p))
        self.global_proj = Conv(c, fw, 1, cfg.dtype)
        self.local_proj = Conv(c, fw, 1, cfg.dtype)
        self.fuse_global = FusionBlock(fw, cfg.dtype)
        self.fuse_local = FusionBlock(fw, cfg.dtype, skip=True)
        self.head1 = Conv(fw, fw // 2, 3, cfg.dtype)
        self.head2 = Conv(fw // 2, 1, 3, torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images.shape
        th, tw = h // 2, w // 2
        half = resize(images.permute(0, 3, 1, 2), (th, tw))
        tiles = torch.cat([
            images[:, :th, :tw], images[:, :th, tw:],
            images[:, th:, :tw], images[:, th:, tw:],
            half.permute(0, 2, 3, 1).to(images.dtype),
        ], dim=0)  # (5B, th, tw, 3)
        enc = self.encoder(tiles)
        gh, gw = enc["grid"]
        tok = enc["tokens"].transpose(1, 2).reshape(5 * b, -1, gh, gw)  # NCHW
        t00, t01, t10, t11, g = tok.split(b, dim=0)
        local = torch.cat([torch.cat([t00, t01], dim=3), torch.cat([t10, t11], dim=3)], dim=2)

        x = self.fuse_global(self.global_proj(g))              # -> 2gh
        x = self.fuse_local(x, skip=self.local_proj(local))    # -> 4gh
        x = resize(x, (h, w))
        x = self.head2(F.gelu(self.head1(x)))
        return F.softplus(x[:, 0].float())


def depth_pro_infer(
    model: DepthProModel,
    images: torch.Tensor,
    f_px: torch.Tensor,
    max_depth: float = 1e4,
) -> dict:
    """Metric depth = 1 / clip(canonical * (W / f_px), 1/max_depth, 1e4),
    with W the width of `images`."""
    canonical = model(images)
    b, h, w = canonical.shape
    f_px = torch.as_tensor(f_px, dtype=torch.float32, device=canonical.device).expand(b)
    inverse_depth = canonical * (w / f_px)[:, None, None]
    depth = 1.0 / inverse_depth.clamp(1.0 / max_depth, 1e4)
    return {"depth": depth, "canonical_inverse_depth": canonical}


# --------------------------------------------------------------------------
# Checkpoint-faithful variant: the released DepthPro graph. The 35-patch
# pyramid is one batched ViT call; split and merge are static slices.
# Activations run NCHW inside the decoder; public tensors are NHWC.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DepthPro35Config:
    """The released DepthPro's default configuration (dinov2l16_384
    encoders)."""

    patch_encoder: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig.large(patch_size=16, out_indices=(5, 11)))
    image_encoder: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig.large(patch_size=16))
    fov_encoder: ViTConfig | None = dataclasses.field(
        default_factory=lambda: ViTConfig.large(patch_size=16))
    dims_encoder: tuple = (256, 512, 1024, 1024)
    decoder_features: int = 256
    patch_res: int = 384            # backbone resolution
    img_size: int = 1536            # = 4 * patch_res
    last_dims: tuple = (32, 1)
    fov_final_kernel: int = 6       # the FoV head's closing conv (6 -> 1x1 at 384)
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test() -> "DepthPro35Config":
        # A 16-px patch, as the real config: the decoder's resolution algebra
        # closes back to img_size only at that token stride.
        vit = dataclasses.replace(ViTConfig.tiny_test(), patch_size=16)
        return DepthPro35Config(
            patch_encoder=dataclasses.replace(vit, out_indices=(0, 1)),
            image_encoder=vit, fov_encoder=vit, dims_encoder=(8, 16, 16, 16),
            decoder_features=8, patch_res=128, img_size=512, last_dims=(8, 1),
            fov_final_kernel=2, dtype=torch.float32)


def split_overlap(x: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """Sliding-window split of NHWC `x` into (steps^2 * B, patch, patch, C);
    output batch index = (row * steps + col) * B + b."""
    size = x.shape[1]
    steps = -(-(size - patch) // stride) + 1
    return torch.cat([x[:, j * stride:j * stride + patch, i * stride:i * stride + patch]
                      for j in range(steps) for i in range(steps)], dim=0)


def merge_overlap(x: torch.Tensor, batch_size: int, padding: int) -> torch.Tensor:
    """Inverse of `split_overlap` for NHWC patches: crop `padding` from every
    interior edge and tile."""
    steps = int(round((x.shape[0] // batch_size) ** 0.5))
    rows = []
    for j in range(steps):
        cols = []
        for i in range(steps):
            idx = j * steps + i
            t = x[batch_size * idx:batch_size * (idx + 1)]
            t = t[:, (padding if j else 0):t.shape[1] - (padding if j != steps - 1 else 0)]
            t = t[:, :, (padding if i else 0):t.shape[2] - (padding if i != steps - 1 else 0)]
            cols.append(t)
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


class _ProjUpsample(nn.Module):
    """1x1 projection + `n_up` stride-2 transposed convolutions, bias-free."""

    def __init__(self, in_ch: int, dim_int: int, dim_out: int, n_up: int, dtype: torch.dtype):
        super().__init__()
        self.n_up = n_up
        self.proj = Conv(in_ch, dim_int, 1, dtype, bias=False)
        for i in range(n_up):
            self.add_module(f"deconv{i}", ConvTranspose(dim_int if i == 0 else dim_out,
                                                        dim_out, 2, dtype, bias=False))

    def forward(self, x):
        x = self.proj(x)
        for i in range(self.n_up):
            x = getattr(self, f"deconv{i}")(x)
        return x


class _ResidualUnit(nn.Module):
    """[ReLU, conv3, ReLU, conv3] + identity."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(features, features, 3, dtype)
        self.conv2 = Conv(features, features, 3, dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FusionBlock(nn.Module):
    """DPT feature fusion: optional skip through `res1`, `res2`, an optional
    bias-free 2x transposed convolution, a 1x1 output conv. The top
    (lowest-resolution) block takes no skip and has no `res1`."""

    def __init__(self, features: int, deconv: bool, skip: bool, dtype: torch.dtype):
        super().__init__()
        if skip:
            self.res1 = _ResidualUnit(features, dtype)
        self.res2 = _ResidualUnit(features, dtype)
        if deconv:
            self.deconv = ConvTranspose(features, features, 2, dtype, bias=False)
        self.out_conv = Conv(features, features, 1, dtype)

    def forward(self, x0, x1=None):
        x = x0 if x1 is None else x0 + self.res1(x1)
        x = self.res2(x)
        if hasattr(self, "deconv"):
            x = self.deconv(x)
        return self.out_conv(x)


class DepthPro35(nn.Module):
    """Checkpoint-faithful DepthPro: (B, S, S, 3) images at `img_size` ->
    canonical inverse depth (B, S, S) and the field of view in degrees."""

    def __init__(self, cfg: DepthPro35Config):
        super().__init__()
        self.cfg = cfg
        gh = cfg.patch_res // cfg.patch_encoder.patch_size
        grid = (gh, gh)
        c, ci = cfg.patch_encoder.width, cfg.image_encoder.width
        de, df, dt = cfg.dims_encoder, cfg.decoder_features, cfg.dtype
        self.patch_encoder = ViT(cfg.patch_encoder, grid)
        self.image_encoder = ViT(cfg.image_encoder, grid)
        self.upsample_latent0 = _ProjUpsample(c, de[0], df, 3, dt)
        self.upsample_latent1 = _ProjUpsample(c, de[0], de[0], 2, dt)
        self.upsample0 = _ProjUpsample(c, de[1], de[1], 1, dt)
        self.upsample1 = _ProjUpsample(c, de[2], de[2], 1, dt)
        self.upsample2 = _ProjUpsample(c, de[3], de[3], 1, dt)
        self.upsample_lowres = ConvTranspose(ci, de[3], 2, dt)
        self.fuse_lowres = Conv(2 * de[3], de[3], 1, dt)
        # MultiresConvDecoder over [latent0, latent1, f0, f1, lowres]: dims
        # [df] + dims_encoder; conv0 is the identity (dims[0] == df).
        dims = [df, *de]
        for i in (1, 2, 3, 4):
            self.add_module(f"dec_conv{i}", Conv(dims[i], df, 3, dt, bias=False))
        for i in range(5):
            self.add_module(f"dec_fusion{i}", _FusionBlock(df, deconv=i != 0, skip=i != 4,
                                                           dtype=dt))
        self.head_c1 = Conv(df, df // 2, 3, dt)
        self.head_deconv = ConvTranspose(df // 2, df // 2, 2, dt)
        self.head_c2 = Conv(df // 2, cfg.last_dims[0], 3, dt)
        self.head_c3 = Conv(cfg.last_dims[0], cfg.last_dims[1], 1, torch.float32)
        if cfg.fov_encoder is not None:
            self.fov_encoder = ViT(cfg.fov_encoder, grid)
            self.fov_enc_linear = Dense(cfg.fov_encoder.width, df // 2, dt)
            self.fov_down = Conv(df, df // 2, 3, dt, stride=2, padding=1)
            self.fov_h0 = Conv(df // 2, df // 4, 3, dt, stride=2, padding=1)
            self.fov_h1 = Conv(df // 4, max(df // 8, 1), 3, dt, stride=2, padding=1)
            self.fov_h2 = Conv(max(df // 8, 1), 1, cfg.fov_final_kernel, torch.float32,
                               padding=0)

    def forward(self, images: torch.Tensor) -> dict:
        cfg = self.cfg
        b, s = images.shape[0], cfg.img_size
        if images.shape[1:3] != (s, s):
            raise ValueError(f"DepthPro35 takes {s}x{s} images, got {tuple(images.shape[1:3])}")
        p = cfg.patch_res
        nchw = images.permute(0, 3, 1, 2)
        x1 = resize(nchw, (s // 2, s // 2)).permute(0, 2, 3, 1)
        x2 = resize(nchw, (p, p)).permute(0, 2, 3, 1)
        x0_p = split_overlap(images, p, int(p * 0.75))   # 5x5, overlap 0.25
        x1_p = split_overlap(x1, p, int(p * 0.5))        # 3x3, overlap 0.5
        n0, n1 = x0_p.shape[0], x1_p.shape[0]
        enc = self.patch_encoder(torch.cat([x0_p, x1_p, x2], dim=0))  # (35B, p, p, 3)
        gh, gw = enc["grid"]

        def grid(t):
            return t.reshape(t.shape[0], gh, gw, t.shape[-1])

        def nchw_of(t):
            return t.permute(0, 3, 1, 2)

        hook0, hook1 = (grid(h) for h in enc["hiddens"])
        tokens = grid(enc["tokens"])
        # Seam crops scale with the token grid: gh/8 per side at overlap
        # 0.25, gh/4 at 0.5 (3 and 6 at the released gh = 24).
        pad0, pad1 = gh // 8, gh // 4
        latent0 = nchw_of(merge_overlap(hook0[:n0], b, pad0))
        latent1 = nchw_of(merge_overlap(hook1[:n0], b, pad0))
        f0 = nchw_of(merge_overlap(tokens[:n0], b, pad0))
        f1 = nchw_of(merge_overlap(tokens[n0:n0 + n1], b, pad1))
        f2 = nchw_of(tokens[n0 + n1:])
        g = nchw_of(grid(self.image_encoder(x2)["tokens"]))

        latent0 = self.upsample_latent0(latent0)
        latent1 = self.upsample_latent1(latent1)
        f0 = self.upsample0(f0)
        f1 = self.upsample1(f1)
        f2 = self.upsample2(f2)
        g = self.fuse_lowres(torch.cat([f2, self.upsample_lowres(g)], dim=1))

        encodings = [latent0, latent1, f0, f1, g]
        feats = self.dec_conv4(encodings[4])
        lowres_features = feats
        feats = self.dec_fusion4(feats)
        for i in (3, 2, 1, 0):
            proj = encodings[0] if i == 0 else getattr(self, f"dec_conv{i}")(encodings[i])
            feats = getattr(self, f"dec_fusion{i}")(feats, proj)

        h = self.head_deconv(self.head_c1(feats))
        h = self.head_c3(F.relu(self.head_c2(h)))
        out = {"canonical_inverse_depth": F.relu(h[:, 0].float())}

        if cfg.fov_encoder is not None:
            xf = resize(nchw, (s // 4, s // 4)).permute(0, 2, 3, 1)
            fenc = self.fov_encoder(xf)
            fgh, fgw = fenc["grid"]
            ftok = self.fov_enc_linear(fenc["tokens"])
            ftok = ftok.transpose(1, 2).reshape(b, -1, fgh, fgw)
            z = ftok + F.relu(self.fov_down(lowres_features))  # no activation after the add
            z = F.relu(self.fov_h0(z))
            z = F.relu(self.fov_h1(z))
            out["fov_deg"] = self.fov_h2(z.float()).reshape(b)
        return out


def depth_pro35_infer(model: DepthPro35, images: torch.Tensor, f_px=None,
                      max_depth: float = 1e4) -> dict:
    """Metric depth = 1 / clip(canonical * (W / f_px), 1/max_depth, 1e4);
    without `f_px`, the focal comes from the predicted FoV:
    f_px = 0.5 * W / tan(0.5 * fov)."""
    out = model(images)
    canonical = out["canonical_inverse_depth"]
    b, h, w = canonical.shape
    if f_px is None:
        f_px = 0.5 * w / torch.tan(0.5 * torch.deg2rad(out["fov_deg"]))
    f_px = torch.as_tensor(f_px, dtype=torch.float32, device=canonical.device).expand(b)
    inverse_depth = canonical * (w / f_px)[:, None, None]
    depth = 1.0 / inverse_depth.clamp(1.0 / max_depth, 1e4)
    res = {"depth": depth, "canonical_inverse_depth": canonical, "f_px": f_px}
    if "fov_deg" in out:
        res["fov_deg"] = out["fov_deg"]
    return res
