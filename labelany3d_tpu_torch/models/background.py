"""Background SDF model: a positional-encoded MLP fit to scene points, meshed.

Counterpart of `labelany3d_tpu/models/background.py`, for the reference's
`src/background_model.py:11-125` (a NeRF-style embedder and a small MLP
fit to background points, used by the in-the-wild mode to close the scene
behind the objects; extracted with marching cubes). The fit is
`torch.autograd` with Adam (eps 1e-8, as optax's `adam`), on `device`, in
float32 with TF32 off; the mesh comes from `ops/marching_cubes.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Dense
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.precision import full_f32


def positional_encoding(x: torch.Tensor, num_freqs: int = 6) -> torch.Tensor:
    """The NeRF embedder (`background_model.py:11-41`): [x, sin/cos(2^k x)]."""
    outs = [x]
    for k in range(num_freqs):
        outs.append(torch.sin((2.0 ** k) * x))
        outs.append(torch.cos((2.0 ** k) * x))
    return torch.cat(outs, dim=-1)


@dataclasses.dataclass(frozen=True)
class BackgroundConfig:
    num_freqs: int = 6
    width: int = 128
    depth: int = 4
    learning_rate: float = 1e-3
    fit_steps: int = 500
    truncation: float = 0.05   # SDF supervision band


class SDFMLP(nn.Module):
    def __init__(self, cfg: BackgroundConfig):
        super().__init__()
        self.cfg = cfg
        d_in = 3 * (1 + 2 * cfg.num_freqs)
        for i in range(cfg.depth):
            self.add_module(f"fc{i}", Dense(d_in if i == 0 else cfg.width, cfg.width,
                                            torch.float32))
        self.out = Dense(cfg.width, 1, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, 3) -> (N,)
        h = positional_encoding(x, self.cfg.num_freqs)
        for i in range(self.cfg.depth):
            h = F.relu(getattr(self, f"fc{i}")(h))
        return self.out(h)[..., 0]


class BackgroundModel:
    """Fit an SDF to background surface points on `device`; extract a mesh."""

    def __init__(self, cfg: BackgroundConfig | None = None, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or BackgroundConfig()
        self.seed = seed
        self.model: SDFMLP | None = None
        self.losses: np.ndarray | None = None
        self.bounds = (np.zeros(3), np.ones(3))

    def fit(self, points: np.ndarray, off_points: torch.Tensor | None = None,
            params=None) -> float:
        """Fit the zero level set to `points` (surface samples) with
        off-surface regularisation; returns the last step's loss and keeps
        every step's in `losses`.

        The reference's shape (`background_model.py:82-102`): surface points
        at sdf = 0 plus uniform off-surface points in the unit cube, pushed
        to the distance to the nearest of the first 256 surface points,
        clamped at `4 * truncation`. `off_points` (fit_steps, N, 3) are the
        off-surface draws (parity tests pass the JAX package's); otherwise
        they come from a generator seeded with `seed`. `params` is a
        Flax-layout tree to start from; otherwise Flax's initialisers."""
        from labelany3d_tpu_torch.models.weights import flax_to_state_dict, init_params_

        cfg, dev = self.cfg, self.device
        pts = np.asarray(points, np.float32)
        lo = pts.min(axis=0) - 0.1
        hi = pts.max(axis=0) + 0.1
        self.bounds = (lo, hi)
        data = torch.as_tensor((pts - lo) / (hi - lo), device=dev)  # fit in [0, 1]^3

        with torch.device(dev):
            model = SDFMLP(cfg)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        if params is None:
            init_params_(model, gen)
        else:
            model.load_state_dict(flax_to_state_dict(params, model))
        opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, eps=1e-8,
                               foreach=False)
        anchors = data[None, :256]
        clamp = cfg.truncation * 4
        losses = torch.empty(cfg.fit_steps, device=dev)
        with full_f32():
            for t in range(cfg.fit_steps):
                off = (torch.rand(data.shape, generator=gen, device=dev) if off_points is None
                       else torch.as_tensor(off_points[t], device=dev))
                # Nearest-surface distance proxy for the off-surface target.
                target = torch.linalg.vector_norm(off[:, None] - anchors, dim=-1).amin(-1)
                loss = (model(data) ** 2).mean() \
                    + ((model(off) - torch.clamp(target, max=clamp)) ** 2).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses[t] = loss.detach()
        self.model = model.eval().requires_grad_(False)
        self.losses = losses.cpu().numpy()
        return float(self.losses[-1])

    @torch.inference_mode()
    def extract_mesh(self, resolution: int = 64):
        """Marching cubes over the fitted SDF on a `resolution`^3 lattice;
        (vertices, faces) in the original coordinate frame
        (`background_model.py:104-125`)."""
        from labelany3d_tpu_torch.ops.marching_cubes import marching_cubes_mesh

        if self.model is None:
            raise RuntimeError("fit() first")
        ts = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
        gx, gy, gz = np.meshgrid(ts, ts, ts, indexing="ij")
        grid = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3),
                               device=self.device)
        with full_f32():
            sdf = self.model(grid).reshape(resolution, resolution, resolution)
        verts, faces = marching_cubes_mesh(sdf, iso=0.0)
        lo, hi = self.bounds
        return verts / (resolution - 1) * (hi - lo) + lo, faces
