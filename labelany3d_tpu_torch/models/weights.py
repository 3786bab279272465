"""Parameters for the port's models: random init, and Flax trees -> state_dict.

`init_params_` gives a model the distributions Flax's `init` gives the JAX
package's modules (lecun-normal kernels, zero biases, unit LayerNorm scales,
N(0, 0.02) position embeddings), drawn from an explicit `torch.Generator`.
The streams differ from `jax.random`, so parity tests carry the JAX
package's own parameters across with `flax_to_state_dict` instead.

The port's modules carry the Flax module names (`block{i}.attn.qkv` in the
ViT; `dec0_block{i}.self_q`, `dec1_block{i}.mlp.fc1`, `head0.proj` in the
matcher; `up{i}_deconv`, `out{j}_conv_in` in the MoGe checkpoint head), so
one set of rules serves every model. A released torch checkpoint reaches a
port model through the JAX package's name mapping, copied in
`models/convert.py`: `flax_to_state_dict(convert_X(state, cfg), model)`.

Mapping rules (Flax leaf -> PyTorch parameter), module paths joined by '.':
  Dense `kernel` (in, out)     -> `weight` (out, in)
  Conv  `kernel` (kh, kw, I, O) -> `weight` (O, I, kh, kw)
  Conv  `kernel` (kd, kh, kw, I, O) -> `weight` (O, I, kd, kh, kw) (Conv3d)
  a module with `keeps_flax_kernel` (the sparse conv, whose gathers read
  the Flax layout) -> `weight` as it is
  ConvTranspose `kernel` (kh, kw, I, O) -> `weight` (I, O, kh, kw), flipped in
                                  both spatial axes (`layers.ConvTranspose`)
  LayerNorm / GroupNorm / SparseGroupNorm `scale` -> `weight`
  any other leaf (`bias`, `gamma` of LayerScale and of the per-head RMS
  norm, `pos_embed`, `cls_token`,
  `register_tokens`, ...) keeps its name.
Any key missing from either side, or any shape mismatch, raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from labelany3d_tpu_torch.models.layers import GroupNorm32, LayerNorm32

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun_normal_(t: torch.Tensor, gen: torch.Generator, fan_in: int) -> None:
    """Flax `lecun_normal`: truncated normal on [-2, 2], variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, device=t.device).uniform_(lo, 1.0 - lo, generator=gen)
    t.copy_(torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std))


@torch.no_grad()
def init_params_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random-initialise every parameter of `model` in place."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            w = mod.weight
            # Flax's fan-in is the input channels times the window; a
            # transposed convolution keeps its input channels in dim 0.
            fan_in = (w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                      else w[0].numel())
            _lecun_normal_(w, gen, fan_in)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            p.normal_(0.0, 0.02, generator=gen)
        elif leaf in ("cls_token", "register_tokens"):
            p.zero_()
    return model


@torch.no_grad()
def cast_inference_params_(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast the parameters the JAX backend casts (Flax leaves named `kernel`
    or `bias`: Dense, Conv and ConvTranspose weights and biases, LayerNorm
    and GroupNorm biases) to `dtype` once; norm scales, LayerScale gammas
    and embeddings stay f32. Layers cast to their compute dtype per call, so
    the weights' cast only saves work. This rounds the weights of layers
    that compute in f32 too, as the JAX depth backend's
    `_cast_inference_params` does, so it serves the depth backend alone;
    `hold_in_compute_dtype_` is the cast that changes no result."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            mod.weight.data = mod.weight.data.to(dtype)
            if mod.bias is not None:
                mod.bias.data = mod.bias.data.to(dtype)
        elif isinstance(mod, (LayerNorm32, GroupNorm32)):
            mod.bias.data = mod.bias.data.to(dtype)
    return model


@torch.no_grad()
def hold_in_compute_dtype_(model: nn.Module) -> nn.Module:
    """Hold each layer's weights in the dtype it computes in (a Dense, Conv
    or ConvTranspose casts its weights to `compute_dtype` on every call), so
    the cast happens once; the layers' results are unchanged. Norm and
    embedding parameters keep their dtype. The JAX diffusion pipelines,
    CLIP and ISNet cast no parameter, so their ports use this and not
    `cast_inference_params_`, which rounds f32 layers' weights to bf16."""
    for mod in model.modules():
        d = getattr(mod, "compute_dtype", None)
        if d is not None:
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(d)
    return model


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(params, model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert a Flax parameter tree (nested dict of arrays) into `model`'s
    state_dict; raises on any missing or unused key or shape mismatch."""
    target = model.state_dict()
    transposed = {name for name, m in model.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    kept = {name for name, m in model.named_modules() if getattr(m, "keeps_flax_kernel", False)}
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *mods, leaf = path
        t = torch.from_numpy(np.array(np.asarray(arr, np.float32)))
        if leaf == "kernel":
            if ".".join(mods) in kept:
                pass
            elif t.ndim == 2:
                t = t.t()
            elif ".".join(mods) in transposed:
                t = t.flip(0, 1).permute(2, 3, 0, 1)
            elif t.ndim == 5:
                t = t.permute(4, 3, 0, 1, 2)
            else:
                t = t.permute(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join([*mods, leaf])
        if key not in target:
            raise KeyError(f"unused Flax parameter {'/'.join(path)} (no {key} in model)")
        if tuple(t.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: Flax shape {tuple(t.shape)} != model shape "
                             f"{tuple(target[key].shape)}")
        out[key] = t.contiguous().to(target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model parameters missing from the Flax tree: {missing}")
    return out


def build_module(make, device: torch.device, tree, seed: int, init=init_params_) -> nn.Module:
    """`make()` on `device`, loaded from the Flax-layout `tree` or random
    from a generator seeded with `seed` through `init`; weights held in the
    dtype each layer computes in; frozen."""
    with torch.device(device):
        model = make()
    if tree is not None:
        model.load_state_dict(flax_to_state_dict(tree, model))
    else:
        init(model, torch.Generator(device=device).manual_seed(seed))
    return hold_in_compute_dtype_(model).eval().requires_grad_(False)
