"""Tensor-parallel (Megatron) layout of the ViT family over a mesh's model axis.

Counterpart of `labelany3d_tpu/parallel/sharding.py`, with the same rule by
module name:

  * `qkv`, `fc1`, `w12` are column-parallel: the output dim is sharded,
    which is dim 0 of a torch (out, in) weight (Flax's (in, out) kernel
    takes P(None, "model")); their biases are sharded with it;
  * `proj`, `fc2`, `w3` are row-parallel: the input dim is sharded (dim 1
    here); their biases are replicated;
  * everything else is replicated.

A spec is a tuple naming the mesh axis of each dim (None for a whole dim);
`()` is replicated.

Two things differ from JAX, whose partitioner reshards global arrays behind
the scenes; here each rank holds only local tensors:

  * Shards follow heads. A contiguous half of the fused (3W, W) `qkv`
    weight would hold all of q and half of k. Rank r holds the q, k and v
    rows of its own heads, packed [q | k | v] as K1 reads them, so K1 runs
    unchanged on H / tp heads. SwiGLU's `w12` keeps its x1 and x2 halves
    paired the same way.
  * Collectives sit where Megatron puts them. A column-parallel layer's
    input is an identity forward and an all-reduce backward; a
    row-parallel layer's output is an all-reduce forward (in fp32) and an
    identity backward, and its bias is added once, after the all-reduce.

At a model axis of 1 every layer stays as it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from labelany3d_tpu_torch.models.layers import Dense
from labelany3d_tpu_torch.parallel.mesh import axis_rank, axis_size

_COL_PARALLEL = ("qkv", "fc1", "w12")   # shard the output dim
_ROW_PARALLEL = ("proj", "fc2", "w3")   # shard the input dim
# Column-parallel weights whose output dim is several blocks side by side,
# each split by heads (or hidden units) alike.
_FUSED_BLOCKS = {"qkv": 3, "w12": 2}


def vit_param_spec(name: str, value) -> tuple:
    """Spec of one parameter, by its state-dict name."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if leaf == "weight" and getattr(value, "ndim", 0) == 2:
        if parent in _COL_PARALLEL:
            return ("model", None)
        if parent in _ROW_PARALLEL:
            return (None, "model")
    if leaf == "bias" and parent in _COL_PARALLEL:
        return ("model",)
    return ()


def param_pspecs(params) -> dict:
    """{name: spec} of a module's parameters or of a state dict."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {k: vit_param_spec(k, v) for k, v in items}


def _split(name: str, spec: tuple) -> tuple[int, int]:
    """(sharded dim, number of fused blocks along it) of a sharded spec."""
    dim = spec.index("model")
    parent = name.split(".")[-2]
    return dim, (_FUSED_BLOCKS.get(parent, 1) if dim == 0 else 1)


def shard_shape(name: str, shape, tp: int) -> tuple:
    """A rank's shape of the parameter `name` of full `shape`."""
    shape = tuple(shape)
    spec = vit_param_spec(name, torch.empty(shape, device="meta"))
    if "model" not in spec:
        return shape
    dim, _ = _split(name, spec)
    if shape[dim] % tp:
        raise ValueError(f"{name}: dim {dim} of {shape} does not split over {tp} ranks")
    return shape[:dim] + (shape[dim] // tp,) + shape[dim + 1:]


def shard_tensor(name: str, full: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s shard of the parameter `name`: each fused block's
    slice of the sharded dim, so a rank holds whole heads of q, k and v (or
    paired hidden units of x1 and x2)."""
    spec = vit_param_spec(name, full)
    if "model" not in spec or tp == 1:
        return full
    dim, blocks = _split(name, spec)
    n = full.shape[dim]
    if n % (blocks * tp):
        raise ValueError(f"{name}: {n} units in {blocks} blocks do not split over {tp} ranks")
    per = n // blocks // tp
    parts = full.unflatten(dim, (blocks, tp, per)).select(dim + 1, rank)
    return parts.flatten(dim, dim + 1).contiguous()


def unshard_tensor(name: str, shards: list[torch.Tensor]) -> torch.Tensor:
    """The full parameter from every rank's shard (rank order):
    `shard_tensor`'s inverse."""
    spec = vit_param_spec(name, shards[0])
    if "model" not in spec or len(shards) == 1:
        return shards[0]
    dim, blocks = _split(name, spec)
    parts = [s.unflatten(dim, (blocks, -1)) for s in shards]
    return torch.stack(parts, dim=dim + 1).flatten(dim, dim + 2)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        acc = g.float().contiguous()
        dist.all_reduce(acc, group=ctx.group)
        return acc.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (in fp32) forward over the model group; identity
    backward. Returns fp32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        acc = x.float().contiguous()
        dist.all_reduce(acc, group=group)
        return acc

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class ColumnParallelDense(nn.Module):
    """This rank's output units of a `Dense` (weight and bias sharded)."""

    def __init__(self, dense: Dense, prefix: str, rank: int, tp: int, group):
        super().__init__()
        self.compute_dtype, self.group = dense.compute_dtype, group
        self.weight = nn.Parameter(shard_tensor(f"{prefix}.weight", dense.weight.data, rank, tp))
        self.bias = None if dense.bias is None else nn.Parameter(
            shard_tensor(f"{prefix}.bias", dense.bias.data, rank, tp))

    def forward(self, x):
        d = self.compute_dtype
        x = _CopyToModel.apply(x, self.group)
        return F.linear(x.to(d), self.weight.to(d), None if self.bias is None
                        else self.bias.to(d))


class RowParallelDense(nn.Module):
    """This rank's input units of a `Dense`: a bias-free local product,
    the all-reduce, then the (replicated) bias once."""

    def __init__(self, dense: Dense, prefix: str, rank: int, tp: int, group):
        super().__init__()
        self.compute_dtype, self.group = dense.compute_dtype, group
        self.weight = nn.Parameter(shard_tensor(f"{prefix}.weight", dense.weight.data, rank, tp))
        self.bias = dense.bias

    def forward(self, x):
        d = self.compute_dtype
        y = _ReduceFromModel.apply(F.linear(x.to(d), self.weight.to(d)), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(d)


def shard_params(mesh, model: nn.Module) -> nn.Module:
    """Swap, in place, each `Dense` the rule names for this rank's
    column- or row-parallel shard over the mesh's model axis, and give each
    module whose `qkv` is sharded its local head count. Returns `model`.
    At a model axis of 1 nothing changes."""
    tp = axis_size(mesh, "model")
    if tp == 1:
        return model
    rank, group = axis_rank(mesh, "model"), mesh.get_group("model")
    for prefix, mod in list(model.named_modules()):
        for child, sub in list(mod.named_children()):
            if not isinstance(sub, Dense):
                continue
            path = f"{prefix}.{child}" if prefix else child
            if child in _COL_PARALLEL:
                setattr(mod, child, ColumnParallelDense(sub, path, rank, tp, group))
            elif child in _ROW_PARALLEL:
                setattr(mod, child, RowParallelDense(sub, path, rank, tp, group))
        if isinstance(getattr(mod, "qkv", None), ColumnParallelDense):
            if mod.num_heads % tp:
                raise ValueError(f"{prefix}: {mod.num_heads} heads do not split over {tp} "
                                 "ranks")
            mod.num_heads //= tp
    return model


def gather_params(mesh, model: nn.Module) -> dict[str, torch.Tensor]:
    """The full parameters of a sharded `model` (every rank of the model
    group gets them): each shard all-gathered and put back together."""
    tp = axis_size(mesh, "model")
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if tp > 1 and "model" in vit_param_spec(name, t):
            parts = [torch.empty_like(t) for _ in range(tp)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group("model"))
            t = unshard_tensor(name, parts)
        out[name] = t
    return out
