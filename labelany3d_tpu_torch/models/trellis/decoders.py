"""SLat decoders: per-voxel 3D Gaussians and FlexiCubes-style mesh features.

Counterpart of `labelany3d_tpu/models/trellis/decoders.py` (TRELLIS
`SLatGaussianDecoder` and `SLatMeshDecoder`): a sparse swin transformer
(`_SparseTorso`, shifted 3D window attention) then either per-voxel K
Gaussians with the release's activations, or two `SparseSubdivideBlock3d`
upsamplings (64 -> 256) to a FlexiCubes feature field. `flexicubes_to_mesh`
extracts the surface on the host (numpy), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Dense, layer_norm
from labelany3d_tpu_torch.models.trellis.dit import DiTConfig, TransformerBlock, ape_3d
from labelany3d_tpu_torch.models.trellis.slat import SparseConv3d


class GaussianSet(NamedTuple):
    means: torch.Tensor       # (N*K, 3) in [0, 1]^3 object space
    scales: torch.Tensor      # (N*K, 3)
    rotations: torch.Tensor   # (N*K, 4) wxyz
    opacities: torch.Tensor   # (N*K,)
    colors: torch.Tensor      # (N*K, 3)
    valid: torch.Tensor       # (N*K,)


def _radical_inverse(base: int, n: int) -> float:
    val, inv = 0.0, 1.0 / base
    inv_n = inv
    while n > 0:
        val += (n % base) * inv_n
        n //= base
        inv_n *= inv
    return val


def hammersley_3d(num: int) -> np.ndarray:
    """(num, 3) Hammersley points (TRELLIS `utils/random_utils.py`)."""
    return np.asarray([[i / num, _radical_inverse(2, i), _radical_inverse(3, i)]
                       for i in range(num)], np.float32)


@dataclasses.dataclass(frozen=True)
class GaussianRepConfig:
    """`representation_config` of the released Gaussian decoder."""

    num_gaussians: int = 32
    voxel_size: float = 1.5
    perturb_offset: bool = True
    lr_xyz: float = 1.0
    lr_features_dc: float = 1.0
    lr_scaling: float = 1.0
    lr_rotation: float = 0.1
    lr_opacity: float = 1.0
    scaling_bias: float = 4e-3
    opacity_bias: float = 0.1
    min_kernel_size: float = 2e-3
    scaling_activation: str = "softplus"   # 'softplus' | 'exp'


@dataclasses.dataclass(frozen=True)
class SLatDecoderConfig:
    """Shared torso shapes (slat_dec_*_swin8_B_64l8* defaults)."""

    resolution: int = 64
    latent_channels: int = 8
    model_channels: int = 768
    num_blocks: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 8
    qk_rms_norm: bool = False
    dtype: torch.dtype = torch.bfloat16

    def dit(self) -> DiTConfig:
        return DiTConfig(width=self.model_channels, depth=self.num_blocks,
                         num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
                         qk_rms_norm=self.qk_rms_norm, dtype=self.dtype)

    @staticmethod
    def tiny_test(**kw) -> "SLatDecoderConfig":
        kw.setdefault("resolution", 16)
        kw.setdefault("latent_channels", 4)
        kw.setdefault("model_channels", 16)
        kw.setdefault("num_blocks", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("window_size", 4)
        return SLatDecoderConfig(**kw)


class _SparseTorso(nn.Module):
    """`SparseTransformerBase`: input linear + APE + swin blocks whose window
    shifts by half a window on odd blocks."""

    def __init__(self, cfg: SLatDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.input_layer = Dense(cfg.latent_channels, cfg.model_channels, torch.float32)
        for i in range(cfg.num_blocks):
            self.add_module(f"block{i}", TransformerBlock(cfg.dit()))

    def forward(self, feats, coords, valid):
        cfg = self.cfg
        x = self.input_layer(feats) + ape_3d(coords, cfg.model_channels)
        x = x.to(cfg.dtype)[None]
        cb, vb = coords[None], valid[None]
        for i in range(cfg.num_blocks):
            spec = ("windowed", cb, vb, cfg.window_size // 2 * (i % 2), cfg.resolution,
                    cfg.window_size)
            x = getattr(self, f"block{i}")(x, attn_spec=spec)
        return x[0]


class SLatGaussianDecoder(nn.Module):
    """(N, C) latents on (N, 3) voxels -> `GaussianSet` of N K Gaussians."""

    def __init__(self, cfg: SLatDecoderConfig, rep: GaussianRepConfig | None = None):
        super().__init__()
        self.cfg, self.rep = cfg, rep or GaussianRepConfig()
        self.torso = _SparseTorso(cfg)
        self.out_layer = Dense(cfg.model_channels, self.rep.num_gaussians * 14, torch.float32)
        self.out_layer.zero_init = True

    def forward(self, feats, coords, valid) -> GaussianSet:
        cfg, rep = self.cfg, self.rep
        k = rep.num_gaussians
        f = self.out_layer(layer_norm(self.torso(feats, coords, valid), 1e-5))
        n = feats.shape[0]
        # Contiguous blocks [_xyz | _features_dc | _scaling | _rotation | _opacity].
        f_xyz, f_dc, f_scale, f_rot, f_op = torch.split(f, [3 * k, 3 * k, 3 * k, 4 * k, k], -1)
        f_xyz, f_dc, f_scale = (t.reshape(n, k, 3) for t in (f_xyz, f_dc, f_scale))
        f_rot = f_rot.reshape(n, k, 4)

        res = float(cfg.resolution)
        offset = f_xyz * rep.lr_xyz
        if rep.perturb_offset:
            pert = np.arctanh(np.clip((hammersley_3d(k) * 2.0 - 1.0) / rep.voxel_size,
                                      -0.999, 0.999))
            offset = offset + torch.as_tensor(pert, device=f.device)[None]
        offset = torch.tanh(offset) / res * 0.5 * rep.voxel_size
        centers = (coords.float() + 0.5) / res
        means = centers[:, None, :] + offset

        if rep.scaling_activation == "softplus":
            s = F.softplus(f_scale * rep.lr_scaling + float(np.log(np.expm1(rep.scaling_bias))))
        else:
            s = torch.exp(f_scale * rep.lr_scaling + float(np.log(rep.scaling_bias)))
        scales = torch.sqrt(s * s + rep.min_kernel_size ** 2)
        rot = f_rot * rep.lr_rotation + torch.tensor([1.0, 0.0, 0.0, 0.0], device=f.device)
        rotations = rot / torch.linalg.norm(rot, dim=-1, keepdim=True).clamp_min(1e-8)
        op_bias = float(np.log(rep.opacity_bias / (1 - rep.opacity_bias)))
        opacities = torch.sigmoid(f_op * rep.lr_opacity + op_bias)
        colors = (0.5 + 0.28209479177387814 * f_dc * rep.lr_features_dc).clamp(0, 1)  # SH 0

        vmask = valid.repeat_interleave(k)
        return GaussianSet(means=means.reshape(-1, 3), scales=scales.reshape(-1, 3),
                           rotations=rotations.reshape(-1, 4),
                           opacities=torch.where(vmask, opacities.reshape(-1),
                                                 torch.zeros_like(vmask, dtype=torch.float32)),
                           colors=colors.reshape(-1, 3), valid=vmask)


class SparseGroupNorm(nn.Module):
    """GroupNorm over all valid voxels (statistics per group of channels
    across the whole instance), float32; invalid rows 0."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, valid):
        n, c = x.shape
        g = self.groups
        xf = x.float().reshape(n, g, c // g)
        m = valid.float()[:, None, None]
        cnt = (m.sum() * (c // g)).clamp_min(1.0)
        mean = (xf * m).sum((0, 2)) / cnt
        var = (((xf - mean[None, :, None]) ** 2) * m).sum((0, 2)) / cnt
        y = (xf - mean[None, :, None]) * torch.rsqrt(var[None, :, None] + 1e-5)
        y = y.reshape(n, c) * self.weight.float() + self.bias.float()
        return torch.where(valid[:, None], y, torch.zeros_like(y)).to(x.dtype)


_SUBDIVIDE_CORNERS = [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                      [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]


def sparse_subdivide(feats, coords, valid):
    """Each voxel spawns its 8 children (row-major corner order), features
    copied (TRELLIS `SparseSubdivide`)."""
    corners = torch.tensor(_SUBDIVIDE_CORNERS, dtype=torch.int32, device=coords.device)
    n = feats.shape[0]
    new_coords = (coords.int()[:, None, :] * 2 + corners[None]).reshape(n * 8, 3)
    return (feats.repeat_interleave(8, dim=0), new_coords, valid.repeat_interleave(8))


class SparseSubdivideBlock3d(nn.Module):
    """GN + SiLU -> subdivide -> conv3 -> GN + SiLU -> zero-init conv3, plus a
    subdivided linear skip."""

    def __init__(self, channels: int, out_channels: int, out_resolution: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_resolution, self.dtype = out_resolution, dtype
        self.norm_in = SparseGroupNorm(channels, 32 if channels % 32 == 0 else channels)
        self.conv1 = SparseConv3d(channels, out_channels)
        self.norm_mid = SparseGroupNorm(out_channels,
                                        32 if out_channels % 32 == 0 else out_channels)
        self.conv2 = SparseConv3d(out_channels, out_channels, zero_init=True)
        if out_channels != channels:
            self.skip = Dense(channels, out_channels, dtype)

    def forward(self, feats, coords, valid):
        r = self.out_resolution
        h = F.silu(self.norm_in(feats, valid).float()).to(self.dtype)
        h, new_coords, new_valid = sparse_subdivide(h, coords, valid)
        x = feats.repeat_interleave(8, dim=0)
        h = self.conv1(h[None], new_coords[None], new_valid[None], r)[0]
        h = F.silu(self.norm_mid(h, new_valid).float()).to(self.dtype)
        h = self.conv2(h[None], new_coords[None], new_valid[None], r)[0]
        if hasattr(self, "skip"):
            x = self.skip(x)
        return h + x, new_coords, new_valid


def flexicubes_channels(use_color: bool) -> int:
    """FlexiCubes per-voxel feature layout: 8 sdf + 8x3 deform + 21 weights
    (+ 8x6 colour)."""
    return 8 * 1 + 8 * 3 + 21 + (8 * 6 if use_color else 0)


class SLatMeshDecoder(nn.Module):
    """(N, C) latents -> (features (64N, C_fc) float32, coords (64N, 3),
    valid (64N,)) at 4x the torso resolution."""

    def __init__(self, cfg: SLatDecoderConfig, use_color: bool = True):
        super().__init__()
        self.cfg = cfg
        c = cfg.model_channels
        self.torso = _SparseTorso(cfg)
        self.up0 = SparseSubdivideBlock3d(c, c // 4, cfg.resolution * 2, cfg.dtype)
        self.up1 = SparseSubdivideBlock3d(c // 4, c // 8, cfg.resolution * 4, cfg.dtype)
        self.out_layer = Dense(c // 8, flexicubes_channels(use_color), torch.float32)
        self.out_layer.zero_init = True

    def forward(self, feats, coords, valid):
        h = self.torso(feats, coords, valid)
        h, coords, valid = self.up0(h, coords, valid)
        h, coords, valid = self.up1(h, coords, valid)
        return self.out_layer(h.float()), coords, valid


def flexicubes_to_mesh(features: np.ndarray, coords: np.ndarray, valid: np.ndarray,
                       res: int, use_color: bool = True):
    """Per-voxel FlexiCubes features -> (vertices, faces, vertex_colors), on
    the host, as the JAX package does: corner sdf (with the -1/res bias),
    deformations and colours averaged onto shared grid vertices, vertices
    moved by tanh(deform) / (2 res), marching tetrahedra over the active
    cells only. Vertices land in [-0.5, 0.5]^3."""
    from labelany3d_tpu_torch.ops.marching_cubes import (
        _CORNERS,
        _TET_EDGES,
        _TET_TRI_TABLE,
        _TETS,
    )

    features = np.asarray(features)[np.asarray(valid)]
    coords = np.asarray(coords)[np.asarray(valid)]
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
             np.zeros((0, 3), np.float32))
    if len(coords) == 0:
        return empty
    # The release's corner order is row-major; reorder to _CORNERS'.
    rowmajor = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                         [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)
    reorder = np.array([int(np.nonzero((rowmajor == c).all(1))[0][0]) for c in _CORNERS])
    sdf = (features[:, 0:8] - 1.0 / res)[:, reorder]
    deform = features[:, 8:32].reshape(-1, 8, 3)[:, reorder]
    color = (features[:, 53:101].reshape(-1, 8, 6)[:, reorder, :3]
             if use_color and features.shape[1] >= 101 else None)

    m = len(coords)
    vcoords = (coords[:, None, :] + _CORNERS[None]).reshape(-1, 3).astype(np.int64)
    key = (vcoords[:, 0] * (res + 1) + vcoords[:, 1]) * (res + 1) + vcoords[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    nv = len(uniq)
    attrs = np.concatenate([sdf[..., None], deform] + ([color] if color is not None else []),
                           axis=-1)
    acc = np.zeros((nv, attrs.shape[-1]), np.float64)
    np.add.at(acc, inv, attrs.reshape(m * 8, -1))
    acc /= np.bincount(inv, minlength=nv).astype(np.float64)[:, None]
    v_sdf = acc[:, 0]
    v_col = acc[:, 4:7] if color is not None else None
    vpos = np.stack([uniq // ((res + 1) * (res + 1)), (uniq // (res + 1)) % (res + 1),
                     uniq % (res + 1)], -1).astype(np.float64)
    vpos = vpos / res - 0.5 + (1 - 1e-8) / (2 * res) * np.tanh(acc[:, 1:4])

    tet_vids = inv.reshape(m, 8)[:, _TETS]               # (m, 6, 4)
    case = ((v_sdf[tet_vids] < 0).astype(np.int32) * (2 ** np.arange(4))).sum(-1)
    e0 = tet_vids[:, :, _TET_EDGES[:, 0]]                # (m, 6, 6)
    e1 = tet_vids[:, :, _TET_EDGES[:, 1]]
    va, vb = v_sdf[e0], v_sdf[e1]
    t = np.clip(-va / np.where(np.abs(vb - va) > 1e-12, vb - va, 1e-12), 0.0, 1.0)[..., None]
    everts = vpos[e0] * (1 - t) + vpos[e1] * t           # (m, 6, 6, 3)
    rows = _TET_TRI_TABLE[case].reshape(m, 6, 2, 3)
    sel = (rows[..., 0] >= 0).reshape(-1)
    safe = np.maximum(rows, 0)
    ii, jj = np.arange(m)[:, None, None, None], np.arange(6)[None, :, None, None]
    vertices = everts[ii, jj, safe].reshape(-1, 3, 3)[sel].reshape(-1, 3).astype(np.float32)
    if v_col is not None:
        ecols = v_col[e0] * (1 - t) + v_col[e1] * t
        colors = np.clip(ecols[ii, jj, safe].reshape(-1, 3, 3)[sel].reshape(-1, 3), 0, 1
                         ).astype(np.float32)
    else:
        colors = np.zeros_like(vertices)
    if len(vertices) == 0:
        return empty
    return vertices, np.arange(len(vertices), dtype=np.int32).reshape(-1, 3), colors
