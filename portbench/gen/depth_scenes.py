"""Synthetic depth-supervision scenes, made on the device from a seed.

Each scene is an image in [0, 1] with a target depth and a valid mask: a
floor receding from `near_depth` at the bottom row to the scene's far
depth at the top, and rectangles in front of it, each flat at a depth
drawn between the two, in a colour of its own over a noisy grey
background; a share `invalid_share` of the pixels is invalid. Scenes span
indoor to outdoor ranges: the far depth of the scenes of each batch runs
through `far_depths`, and their number of rectangles through
`rects_per_scene`, each batch in its own order, so every seed and every
batch gets the same set of scenes' sizes and ranges.

Parameters (the traffic file): pool (scenes held on the device),
rects_per_scene, near_depth, far_depths, invalid_share.
"""

from __future__ import annotations

import torch


def _cycled(values: list, batch: int, n: int, g, device) -> torch.Tensor:
    """`values` repeated to fill each batch of `batch` rows, each batch
    permuted: (n,)."""
    base = torch.tensor([values[i % len(values)] for i in range(batch)], device=device)
    return torch.cat([base[torch.randperm(batch, generator=g, device=device)]
                      for _ in range(n // batch)])


def make(params: dict, size: int, batch: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """(images (P, S, S, 3), depth (P, S, S), valid (P, S, S) bool)."""
    n = int(params["pool"]) // batch * batch
    g = torch.Generator(device=device).manual_seed(seed)
    per_scene = _cycled(params["rects_per_scene"], batch, n, g, device)
    far = _cycled([float(f) for f in params["far_depths"]], batch, n, g, device)
    near = float(params["near_depth"])
    r = max(params["rects_per_scene"])
    ys = torch.arange(size, device=device).view(1, 1, size, 1)
    xs = torch.arange(size, device=device).view(1, 1, 1, size)
    # Rectangle corners: a side between a sixth and a half of the image.
    lo, hi = size // 6, size // 2
    hw = torch.randint(lo, hi, (n, r, 2), generator=g, device=device)
    y0 = (torch.rand(n, r, generator=g, device=device) * (size - hw[..., 0])).long()
    x0 = (torch.rand(n, r, generator=g, device=device) * (size - hw[..., 1])).long()
    inside = ((ys >= y0[..., None, None]) & (ys < (y0 + hw[..., 0])[..., None, None])
              & (xs >= x0[..., None, None]) & (xs < (x0 + hw[..., 1])[..., None, None]))
    inside &= (torch.arange(r, device=device) < per_scene[:, None]).view(n, r, 1, 1)
    # The last rectangle drawn over a pixel sets its colour and depth.
    idx = torch.arange(1, r + 1, device=device).view(1, r, 1, 1)
    top = (inside * idx).amax(1)                                   # (P, S, S), 0 = floor
    t = torch.linspace(1.0, 0.0, size, device=device).view(1, size, 1)
    floor = (near + (far.view(n, 1, 1) - near) * t).expand(n, size, size)
    rect_d = near + (far.view(n, 1) - near) * torch.rand(n, r + 1, generator=g, device=device)
    rect_c = torch.rand(n, r + 1, 3, generator=g, device=device)
    depth = torch.where(top > 0, rect_d.gather(1, top.view(n, -1)).view(n, size, size), floor)
    grey = 0.5 + 0.08 * torch.rand(n, size, size, 3, generator=g, device=device)
    colour = rect_c.gather(1, top.view(n, -1, 1).expand(-1, -1, 3)).view(n, size, size, 3)
    images = torch.where((top > 0)[..., None], colour, grey)
    valid = torch.rand(n, size, size, generator=g, device=device) >= params["invalid_share"]
    return images.contiguous(), depth.contiguous(), valid
