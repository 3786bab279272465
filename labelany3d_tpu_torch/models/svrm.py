"""SVRM neural multi-view reconstructor: views -> triplanes -> mesh.

Counterpart of `labelany3d_tpu/models/svrm.py`, the reference's alternate
(Hunyuan3D-1) reconstructor, stage 6's `run.obj_rec=hunyuan3d`:

  * `CamModViT` — DINOv2 ViT-B/14 whose every norm is an `AdaNorm` (a
    non-affine LayerNorm shifted and scaled from a shared camera
    embedding); its 37^2 position grid resized to the 36^2 patch grid with
    JAX's bicubic without antialias (`layers.resize`); attention through K2;
  * the triplane decoder — learned (3 * 64^2, 1024) plane tokens through 16
    `_LRMBlock`s (cross-attention to the view tokens first, then
    self-attention, both K2, then an exact-erf GEGLU), a final LayerNorm,
    a linear 4x pixel-shuffle to (3, 256, 256, 120) triplanes;
  * `TriplaneField` — per-plane bilinear sampling at projections (x, y),
    (x, z), (z, y), a small MLP to (sdf, rgb); positive sdf is inside.

Module names are the Flax tree's, so `models/weights.py` carries the JAX
package's parameters (or a released `svrm.safetensors` through
`convert_svrm`) across. Activations bf16, norms and the field float32, as
the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.data.meshio import Mesh
from labelany3d_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm32,
    layer_norm,
    resize,
    resize_bicubic_8bit,
    white_composite,
)
from labelany3d_tpu_torch.models.weights import build_module, init_params_
from labelany3d_tpu_torch.ops.attention import flash_sdpa
from labelany3d_tpu_torch.ops.sampling import grid_sample

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SVRMConfig:
    num_views: int = 7            # 6 orbit views + the input view
    image_size: int = 504
    cam_dim: int = 20             # 4x4 c2w (16) + 4 intrinsics
    enc_width: int = 768          # dinov2_vitb14
    enc_depth: int = 12
    enc_heads: int = 12
    enc_patch: int = 14
    enc_pos_grid: int = 37        # native 518/14 grid; resized to fit
    layerscale_init: float = 1.0
    plane_size: int = 64
    token_dim: int = 1024
    depth: int = 16
    num_heads: int = 16
    context_dim: int = 768
    triplane_dim: int = 120
    upsample_ratio: int = 4
    field_hidden: int = 64
    field_layers: int = 2
    box_warp: float = 1.2
    aabb: float = 0.6
    grid_size: int = 96
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test(**kw) -> "SVRMConfig":
        return SVRMConfig(
            num_views=2, image_size=32, enc_width=32, enc_depth=2,
            enc_heads=2, enc_patch=8, enc_pos_grid=4,
            plane_size=4, token_dim=32, depth=2, num_heads=2,
            context_dim=32, triplane_dim=8, upsample_ratio=2,
            field_hidden=16, grid_size=24, **kw,
        )


class AdaNorm(nn.Module):
    """Non-affine LayerNorm (eps 1e-6) modulated by a conditioning vector:
    SiLU -> Dense(2 * dim) -> shift, scale; x * (1 + scale) + shift, in
    float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.mod = Dense(dim, 2 * dim, torch.float32)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.mod(F.silu(c.float())).chunk(2, dim=-1)
        return layer_norm(x, 1e-6) * (1 + scale[..., None, :]) + shift[..., None, :]


class _EncBlock(nn.Module):
    """DINOv2 BlockMod: AdaNorm -> attention -> LayerScale; AdaNorm -> MLP
    (exact GELU) -> LayerScale. q, k and v are column views of one fused
    projection, which K2 reads in place."""

    def __init__(self, cfg: SVRMConfig):
        super().__init__()
        w, d = cfg.enc_width, cfg.dtype
        self.heads, self.dtype = cfg.enc_heads, d
        self.adaln1 = AdaNorm(w)
        self.qkv = Dense(w, 3 * w, d)
        self.proj = Dense(w, w, d)
        self.ls1 = nn.Parameter(torch.full((w,), cfg.layerscale_init))
        self.adaln2 = AdaNorm(w)
        self.fc1 = Dense(w, 4 * w, d)
        self.fc2 = Dense(4 * w, w, d)
        self.ls2 = nn.Parameter(torch.full((w,), cfg.layerscale_init))

    def forward(self, x: torch.Tensor, cam_emb: torch.Tensor) -> torch.Tensor:
        w = x.shape[-1]
        qkv = self.qkv(self.adaln1(x, cam_emb))
        q, k, v = (qkv[..., i * w:(i + 1) * w].unflatten(-1, (self.heads, -1))
                   for i in range(3))
        o = self.proj(flash_sdpa(q, k, v).flatten(-2))
        x = x + o * self.ls1.to(o.dtype)
        h = self.fc2(F.gelu(self.fc1(self.adaln2(x, cam_emb))))
        return x + h * self.ls2.to(h.dtype)


class CamModViT(nn.Module):
    """Images (B, H, W, 3) + cams (B, cam_dim) -> (B, 1 + N, width) tokens
    ([cls | patch], camera-modulated final AdaNorm), in the config's dtype."""

    def __init__(self, cfg: SVRMConfig):
        super().__init__()
        self.cfg = cfg
        w, pg = cfg.enc_width, cfg.enc_pos_grid
        self.cam_fc1 = Dense(cfg.cam_dim, w, torch.float32)
        self.cam_fc2 = Dense(w, w, torch.float32)
        self.patch_embed = Conv(3, w, cfg.enc_patch, cfg.dtype, stride=cfg.enc_patch, padding=0)
        self.pos_embed = nn.Parameter(torch.zeros(1, pg, pg, w))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, w))
        for i in range(cfg.enc_depth):
            self.add_module(f"block{i}", _EncBlock(cfg))
        self.adaln_out = AdaNorm(w)

    def forward(self, images: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        d, w = cfg.dtype, cfg.enc_width
        b = images.shape[0]
        cam_emb = self.cam_fc2(F.silu(self.cam_fc1(cams.float())))
        x = self.patch_embed(images.permute(0, 3, 1, 2))          # (B, w, gh, gw)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed.permute(0, 3, 1, 2).float()
        if tuple(pos.shape[-2:]) != (gh, gw):
            # dinov2 interpolates without antialias.
            pos = resize(pos, (gh, gw), method="bicubic", antialias=False)
        x = x + pos.flatten(2).transpose(1, 2).to(d)
        x = torch.cat([self.cls_token.to(d).expand(b, 1, w), x], dim=1)
        for i in range(cfg.enc_depth):
            x = getattr(self, f"block{i}")(x, cam_emb)
        return self.adaln_out(x, cam_emb).to(d)


class _LRMBlock(nn.Module):
    """Cross-attention to the view tokens first, then self-attention, then
    the exact-erf GEGLU feed-forward; affine pre-LayerNorms (eps 1e-5)."""

    def __init__(self, cfg: SVRMConfig):
        super().__init__()
        dim, d = cfg.token_dim, cfg.dtype
        self.heads, self.dtype = cfg.num_heads, d
        for name, kv_dim in (("cross", cfg.context_dim), ("self", dim)):
            self.add_module(f"{name}_q", Dense(dim, dim, d, bias=False))
            self.add_module(f"{name}_k", Dense(kv_dim, dim, d, bias=False))
            self.add_module(f"{name}_v", Dense(kv_dim, dim, d, bias=False))
            self.add_module(f"{name}_out", Dense(dim, dim, d))
        self.norm1, self.norm2, self.norm3 = (LayerNorm32(dim, eps=1e-5) for _ in range(3))
        self.ff_proj = Dense(dim, 8 * dim, d)
        self.ff_out = Dense(4 * dim, dim, d)

    def _attn(self, q_in: torch.Tensor, kv_in: torch.Tensor, name: str) -> torch.Tensor:
        m = lambda part: getattr(self, f"{name}_{part}")  # noqa: E731
        q, k, v = (t.unflatten(-1, (self.heads, -1))
                   for t in (m("q")(q_in), m("k")(kv_in), m("v")(kv_in)))
        return m("out")(flash_sdpa(q, k, v).flatten(-2))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self._attn(self.norm1(x).to(self.dtype), context, "cross")
        h = self.norm2(x).to(self.dtype)
        x = x + self._attn(h, h, "self")
        a, gate = self.ff_proj(self.norm3(x).to(self.dtype)).chunk(2, dim=-1)
        return x + self.ff_out(a * F.gelu(gate))


class TriplaneField(nn.Module):
    """(3, R, R, C) planes + (..., 3) points -> dict(sdf, rgb), float32.
    Positive sdf = inside; rgb sigmoid-clamped to [-0.001, 1.001]."""

    def __init__(self, cfg: SVRMConfig):
        super().__init__()
        self.cfg = cfg
        n_in = 3 * cfg.triplane_dim
        for i in range(cfg.field_layers - 1):
            self.add_module(f"fc{i}", Dense(n_in, cfg.field_hidden, torch.float32))
            n_in = cfg.field_hidden
        self.out = Dense(n_in, 4, torch.float32)

    def forward(self, planes: torch.Tensor, points: torch.Tensor) -> dict:
        cfg = self.cfg
        p = points.float() * (2.0 / cfg.box_warp)
        proj = (p[..., [0, 1]], p[..., [0, 2]], p[..., [2, 1]])
        x = torch.cat([grid_sample(planes[i], proj[i]) for i in range(3)], dim=-1)
        for i in range(cfg.field_layers - 1):
            x = F.relu(getattr(self, f"fc{i}")(x))
        x = self.out(x)
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
        return {"sdf": x[..., 0], "rgb": rgb}


class SVRM(nn.Module):
    """views (B, M, H, W, 3) ImageNet-normalized + cams (B, M, cam_dim) ->
    (B, 3, R, R, C) float32 triplanes; `query` and `grid` evaluate the field."""

    def __init__(self, cfg: SVRMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = CamModViT(cfg)
        self.pos_emb = nn.Parameter(torch.zeros(1, 3 * cfg.plane_size ** 2, cfg.token_dim))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", _LRMBlock(cfg))
        self.final_norm = LayerNorm32(cfg.token_dim, eps=1e-6)
        self.upsampler = Dense(cfg.token_dim, cfg.triplane_dim * cfg.upsample_ratio ** 2,
                               torch.float32)
        self.field = TriplaneField(cfg)

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """View tokens (B * M, 1 + N, D) of B objects -> (B, 3, R, R, C)
        triplanes: the LRM blocks over the view-major context, the final
        norm and the pixel-shuffle upsampler."""
        cfg = self.cfg
        b = tokens.shape[0] // cfg.num_views
        ctx = tokens.reshape(b, -1, tokens.shape[-1]).to(cfg.dtype)
        h = self.pos_emb.to(cfg.dtype).expand(b, -1, -1)
        for i in range(cfg.depth):
            h = getattr(self, f"block{i}")(h, ctx)
        s, r, c = cfg.plane_size, cfg.upsample_ratio, cfg.triplane_dim
        h = self.upsampler(self.final_norm(h))
        h = h.reshape(b, 3, s, s, c, r, r).permute(0, 1, 2, 5, 3, 6, 4)  # (b, 3, s, r, s, r, c)
        return h.reshape(b, 3, s * r, s * r, c)

    def forward(self, views: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
        b, m = views.shape[:2]
        tokens = self.encoder(views.reshape(b * m, *views.shape[2:]),
                              cams.reshape(b * m, -1))
        return self.decode(tokens)

    def query(self, planes: torch.Tensor, points: torch.Tensor) -> dict:
        """(3, R, R, C) planes + (..., 3) points -> field outputs."""
        return self.field(planes, points)

    def grid(self, planes: torch.Tensor):
        """(G, G, G) sdf and (G, G, G, 3) rgb on linspace(-aabb, aabb, G)
        in (x, y, z) index order."""
        cfg = self.cfg
        ar = torch.linspace(-cfg.aabb, cfg.aabb, cfg.grid_size, device=planes.device)
        pts = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
        out = self.field(planes, pts)
        return out["sdf"], out["rgb"]


@torch.no_grad()
def init_svrm_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's initialisers (`init_params_`: lecun-normal kernels, N(0, 0.02)
    `pos_embed`, zero `cls_token`), zero plane `pos_emb`, LayerScale at its
    init value."""
    init_params_(model, gen)
    for name, p in model.named_parameters():
        if name == "pos_emb":
            p.zero_()
        elif name.endswith((".ls1", ".ls2")):
            p.fill_(model.cfg.layerscale_init)
    return model


# ---------------------------------------------------------------------------
# Checkpoint conversion (svrm.safetensors), a copy of the JAX package's
# ---------------------------------------------------------------------------


def convert_svrm(state: dict, cfg: SVRMConfig | None = None) -> dict:
    """Released `svrm.safetensors` state dict -> the Flax-layout tree of
    `SVRM` (`models/weights.py::flax_to_state_dict` loads it). Torch names
    from `SVRMModel`: `img_encoder.model.*` (dinov2 + AdaNorm),
    `img_to_triplane_decoder.*`, `render.decoder.net.*`. Values: numpy
    arrays (or anything `np.asarray` takes)."""
    cfg = cfg or SVRMConfig()

    def t(w):
        return np.ascontiguousarray(np.asarray(w).T)

    def lin(pre, bias=True):
        p = {"kernel": t(state[pre + "weight"])}
        if bias:
            p["bias"] = np.asarray(state[pre + "bias"])
        return p

    def ada(pre):
        return {"mod": lin(pre + "adaLN_modulation.1.")}

    def ln(pre):
        return {"scale": np.asarray(state[pre + "weight"]),
                "bias": np.asarray(state[pre + "bias"])}

    e = "img_encoder.model."
    pe = np.asarray(state[e + "patch_embed.proj.weight"])  # (C, 3, p, p)
    pos = np.asarray(state[e + "pos_embed"])               # (1, 1+N, C)
    pg = cfg.enc_pos_grid
    enc: dict = {
        "cam_fc1": lin(e + "cam_embed.0."),
        "cam_fc2": lin(e + "cam_embed.2."),
        "patch_embed": {"kernel": np.transpose(pe, (2, 3, 1, 0)),
                        "bias": np.asarray(state[e + "patch_embed.proj.bias"])},
        "pos_embed": pos[:, 1:].reshape(1, pg, pg, cfg.enc_width),
        "cls_token": np.asarray(state[e + "cls_token"]) + pos[:, :1],
        "adaln_out": ada(e + "norm."),
    }
    for i in range(cfg.enc_depth):
        pre = f"{e}blocks.{i}."
        enc[f"block{i}"] = {
            "adaln1": ada(pre + "norm1."),
            "qkv": lin(pre + "attn.qkv."),
            "proj": lin(pre + "attn.proj."),
            "ls1": np.asarray(state[pre + "ls1.gamma"]),
            "adaln2": ada(pre + "norm2."),
            "fc1": lin(pre + "mlp.fc1."),
            "fc2": lin(pre + "mlp.fc2."),
            "ls2": np.asarray(state[pre + "ls2.gamma"]),
        }
    d = "img_to_triplane_decoder."
    p: dict = {
        "encoder": enc,
        "pos_emb": np.asarray(state[d + "pos_emb"]),
        "final_norm": ln(d + "img_to_triplane_decoder.norm."),
        "upsampler": lin(d + "upsampler."),
        "field": {
            "fc0": lin("render.decoder.net.0."),
            "out": lin(f"render.decoder.net.{2 * (cfg.field_layers - 1)}."),
        },
    }
    for i in range(cfg.field_layers - 2):
        p["field"][f"fc{i + 1}"] = lin(f"render.decoder.net.{2 * (i + 1)}.")
    for i in range(cfg.depth):
        pre = f"{d}img_to_triplane_decoder.transformer_blocks.{i}."
        p[f"block{i}"] = {
            "norm1": ln(pre + "norm1."),
            "norm2": ln(pre + "norm2."),
            "norm3": ln(pre + "norm3."),
            "cross_q": lin(pre + "attn1.to_q.", bias=False),
            "cross_k": lin(pre + "attn1.to_k.", bias=False),
            "cross_v": lin(pre + "attn1.to_v.", bias=False),
            "cross_out": lin(pre + "attn1.to_out.0."),
            "self_q": lin(pre + "attn2.to_q.", bias=False),
            "self_k": lin(pre + "attn2.to_k.", bias=False),
            "self_v": lin(pre + "attn2.to_v.", bias=False),
            "self_out": lin(pre + "attn2.to_out.0."),
            "ff_proj": lin(pre + "ff.net.0.proj."),
            "ff_out": lin(pre + "ff.net.2."),
        }
    return p


# ---------------------------------------------------------------------------
# Reconstruction backend
# ---------------------------------------------------------------------------


def create_camera_to_world(elev_deg: float, azim_deg: float,
                           cam_dis: float = 1.5) -> np.ndarray:
    """z-up OpenGL orbit camera-to-world matrix (the reference predictor's
    `create_camera_to_world_matrix`)."""
    el, az = np.radians(elev_deg), np.radians(azim_deg)
    pos = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                    np.sin(el)]) * cam_dis
    forward = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    new_up = np.cross(right, forward)
    new_up /= np.linalg.norm(new_up)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, new_up, -forward], axis=0).T
    c2w[:3, 3] = pos
    return c2w


class SVRMReconstruction:
    """Stage-6 backend: novel views -> SVRM -> Mesh, on `device`.

    Six orbit views at elevation 0, azimuths 0..300, then the input view
    with a zero camera. A view source with `provides_zero_view`
    (`MVDStdViews`) generates all six; a per-view source (Zero123) keeps the
    input as the azimuth-0 view. Views are resized to `image_size` as
    Pillow's BICUBIC does (`layers.resize_bicubic_8bit`, within one level)
    and ImageNet-normalized. `params`: a Flax-layout tree (the JAX
    package's, or `convert_svrm` of a release); without one the weights are
    random from a `torch.Generator` seeded with `seed`, with a warning."""

    ELEVATIONS = (0.0,) * 6
    AZIMUTHS = (0.0, 60.0, 120.0, 180.0, 240.0, 300.0)

    def __init__(self, novel_views=None, cfg: SVRMConfig | None = None, params=None,
                 seed: int = 0, device=None):
        from labelany3d_tpu_torch.utils.device import resolve_device

        self.cfg = cfg or SVRMConfig()
        self.novel_views = novel_views
        self.params = params
        self.device = resolve_device(device)
        self._seed = seed
        self.model: SVRM | None = None

    def _ensure(self) -> SVRM:
        if self.model is None:
            from labelany3d_tpu_torch.utils.logging import warn_once

            if self.params is None:
                warn_once("svrm_random",
                          "SVRM reconstructor runs with random-initialized weights (no "
                          "converted checkpoint): meshes are not meaningful")
            self.model = build_module(lambda: SVRM(self.cfg), self.device, self.params,
                                      self._seed, init_svrm_)
            self.params = None  # the model holds them now
        return self.model

    @staticmethod
    def camera_vector(elev_deg: float, azim_deg: float, dim: int = 20) -> np.ndarray:
        """Flattened 4x4 c2w + [35/32, 35/32, 0.5, 0.5]."""
        c2w = create_camera_to_world(elev_deg, azim_deg)
        vec = np.concatenate([c2w.reshape(-1), [35.0 / 32, 35.0 / 32, 0.5, 0.5]])
        return vec[:dim].astype(np.float32)

    def views(self, crop_rgba: np.ndarray) -> tuple[list, np.ndarray]:
        """The num_views uint8 views (orbit views, then the input) and their
        (num_views, cam_dim) cameras."""
        cfg = self.cfg
        rgb_in = white_composite(crop_rgba)
        gen_zero = getattr(self.novel_views, "provides_zero_view", False)
        views, cams = [], []
        for i in range(cfg.num_views - 1):
            el = self.ELEVATIONS[i % len(self.ELEVATIONS)]
            az = self.AZIMUTHS[i % len(self.AZIMUTHS)]
            if self.novel_views is not None and (gen_zero or (el, az) != (0.0, 0.0)):
                views.append(self.novel_views.generate(crop_rgba, el, az))
            else:
                views.append(rgb_in)
            cams.append(self.camera_vector(el, az, dim=cfg.cam_dim))
        views.append(rgb_in)
        cams.append(np.zeros(cfg.cam_dim, np.float32))
        return views, np.stack(cams)

    def preprocess(self, views: list) -> torch.Tensor:
        """uint8 views -> (1, M, S, S, 3) ImageNet-normalized float32 on the
        device."""
        s = self.cfg.image_size
        mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        std = torch.tensor(_IMAGENET_STD, device=self.device)
        out = []
        for img in views:
            x = torch.from_numpy(np.ascontiguousarray(img, np.uint8)).to(self.device)
            x = resize_bicubic_8bit(x.permute(2, 0, 1)[None], (s, s))[0].permute(1, 2, 0)
            out.append((x / 255.0 - mean) / std)
        return torch.stack(out)[None]

    @torch.inference_mode()
    def lattice(self, views: torch.Tensor, cams) -> tuple[torch.Tensor, torch.Tensor]:
        """(1, M, S, S, 3) views + (M, cam_dim) cameras -> the (G, G, G) sdf
        and (G, G, G, 3) rgb lattice."""
        model = self._ensure()
        planes = model(views, torch.as_tensor(cams, device=self.device)[None])
        return model.grid(planes[0])

    def reconstruct(self, crop_rgba: np.ndarray, label: str = "") -> Mesh:
        views, cams = self.views(crop_rgba)
        sdf, rgb = self.lattice(self.preprocess(views), cams)
        return self.mesh_from_lattice(sdf, rgb)

    def mesh_from_lattice(self, sdf, rgb) -> Mesh:
        """The surface of a (G, G, G) sdf/rgb lattice (tensors on any device,
        or arrays): the zero level of -sdf (positive inside), lattice index
        order (x, y, z) over [-aabb, aabb], vertex colours from the nearest
        lattice sample, vertices permuted to (y, z, x) as the reference
        exports them."""
        from labelany3d_tpu_torch.ops.marching_cubes import marching_cubes_mesh

        cfg = self.cfg
        verts, faces = marching_cubes_mesh(-torch.as_tensor(sdf), iso=0.0)
        if len(verts) == 0:
            return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
        g = cfg.grid_size
        verts_obj = (verts / (g - 1) * (2 * cfg.aabb) - cfg.aabb).astype(np.float32)
        vi = np.clip(np.round(verts).astype(np.int64), 0, g - 1)
        rgb = torch.as_tensor(rgb)
        colors = rgb[tuple(torch.from_numpy(vi[:, j]).to(rgb.device) for j in range(3))]
        return Mesh(np.ascontiguousarray(verts_obj[:, [1, 2, 0]]), faces,
                    colors=colors.float().cpu().numpy())
