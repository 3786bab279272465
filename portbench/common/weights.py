"""Seeded random weights, drawn on the device in one call.

The benchmark makes the weights and hands the same values to the program
and to the plain reference. `recipe(model)` lists each parameter with its
distribution; `draw(recipe, seed, device)` fills one flat float32 buffer
with unit normals from a `torch.Generator` on the device, in one call, and
scales it into a state dict of views:

  * Linear and convolution weights: N(0, 1/fan_in) (LeCun normal, as the
    port's Flax initialisers), fan-in the input channels times the window;
  * biases and norm offsets: 0; norm scales: 1;
  * LayerScale gammas: `gamma` (assumed; the configuration states it);
  * position embeddings, class and register tokens: N(0, 0.02^2).

`served` rounds the tensors a configuration serves in bf16 to bf16 values
(still float32), so both sides start from the served numbers.
"""

from __future__ import annotations

import torch
from torch import nn


def recipe(model: nn.Module, gamma: float) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) for every parameter of `model`, in
    `named_parameters` order."""
    kinds: dict[str, tuple[str, float]] = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight
            kinds[pre + "weight"] = ("normal", (w.shape[0] * w[0, 0].numel()) ** -0.5)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            kinds[pre + "weight"] = ("normal", mod.weight[0].numel() ** -0.5)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            kinds[pre + "weight"] = ("const", 1.0)
    out = []
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in kinds:
            kind, scale = kinds[name]
        elif leaf == "gamma":
            kind, scale = "const", gamma
        elif leaf in ("pos_embed", "cls_token", "register_tokens"):
            kind, scale = "normal", 0.02
        elif leaf == "bias":
            kind, scale = "const", 0.0
        else:
            raise KeyError(f"no distribution for parameter {name}")
        out.append((name, tuple(p.shape), kind, scale))
    return out


@torch.no_grad()
def draw(rec, seed: int, device) -> dict[str, torch.Tensor]:
    """The recipe's parameters from `seed`: float32 views of one buffer."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in rec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind, scale), t in zip(rec, flat.split(sizes)):
        if kind == "normal":
            t.mul_(scale)
        else:
            t.fill_(scale)
        out[name] = t.view(shape)
    return out


def served(state: dict, model: nn.Module, dtype: torch.dtype) -> dict:
    """`state` with the weights and biases of every Linear, convolution and
    transposed convolution, and the norms' offsets, rounded to `dtype`: the
    tensors the depth backend serves in bf16."""
    rounded = set()
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            rounded.add(pre + "weight")
            rounded.add(pre + "bias")
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            rounded.add(pre + "bias")
    return {k: (v.to(dtype).float() if k in rounded else v) for k, v in state.items()}
