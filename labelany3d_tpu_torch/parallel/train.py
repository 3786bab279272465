"""Fine-tuning step for the depth model, dp x tp over a mesh.

Counterpart of `labelany3d_tpu/parallel/train.py`: the scale-invariant
log-depth loss on MoGe's z channel, AdamW with f32 master weights (the
layers compute in their config's dtype, bf16 for MoGe, and cast the f32
parameters per call, as Flax's `param_dtype` f32 with `dtype` bf16 does),
one step = forward, backward, update. K1 runs forward in every block; its
backward is the plain `ops.attention.packed_sdpa_backward`.

Over a mesh (`init_train_state(..., mesh=)`, `prepare_batch`):

  * the batch is split over the data axis, and the loss is global: the
    three sums it is made of (sum w*d, sum w*d^2, sum w over the valid
    pixels) are all-reduced over the data group before the loss is formed,
    each rank differentiating through its own part only; the ranks'
    gradients are then summed (not averaged) over the data group. The loss
    is not linear in per-rank sums, so averaging per-rank losses (DDP's
    default) gives another gradient once the ranks hold different valid
    counts;
  * the ViT is tensor-parallel over the model axis (`sharding.shard_params`);
    every model rank of a data group sees the same rows and computes the
    same loss.

AdamW takes optax's defaults, not torch's: `optax.adamw(1e-4)` has
weight_decay 1e-4 (torch: 0.01), b1 0.9, b2 0.999, eps 1e-8, and decays
every parameter. Without a mesh the step is the plain one-device step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from labelany3d_tpu_torch.parallel.mesh import axis_size, shard_batch
from labelany3d_tpu_torch.parallel.sharding import shard_params

# optax.adamw's defaults.
ADAMW_DEFAULTS = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: object = None


def depth_sums(pred_depth: torch.Tensor, target_depth: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(sum w*d, sum w*d^2, sum w) in fp32, d = log(pred) - log(target)
    (both clamped at 1e-6), w the valid mask."""
    d = (torch.log(torch.clamp(pred_depth.float(), min=1e-6))
         - torch.log(torch.clamp(target_depth.float(), min=1e-6)))
    w = valid.float()
    return torch.stack([(d * w).sum(), (d * d * w).sum(), w.sum()])


def loss_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """mean(d^2) - 0.5 * mean(d)^2 over the valid pixels."""
    n = torch.clamp(sums[2], min=1.0)
    m1, m2 = sums[0] / n, sums[1] / n
    return m2 - 0.5 * m1 * m1


def depth_loss(pred_depth: torch.Tensor, target_depth: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Scale-invariant log-depth loss (Eigen et al.), masked:
    L = mean(d^2) - 0.5 * mean(d)^2, d = log(pred) - log(target), over
    the valid pixels."""
    return loss_from_sums(depth_sums(pred_depth, target_depth, valid))


def init_train_state(model: nn.Module, generator: torch.Generator | None = None,
                     learning_rate: float = 1e-4, mesh=None,
                     params=None) -> tuple[TrainState, torch.optim.Optimizer]:
    """Parameters (a Flax-layout tree `params`, else Flax's initialisers
    from `generator`, else the model's as they are) kept in f32, sharded
    over `mesh`'s model axis when given, and AdamW over them with optax's
    defaults. Returns (state, optimizer), as the JAX package returns
    (state, tx)."""
    from labelany3d_tpu_torch.models.weights import flax_to_state_dict, init_params_

    if params is not None:
        model.load_state_dict(flax_to_state_dict(params, model))
    elif generator is not None:
        init_params_(model, generator)
    model.float().requires_grad_(True)
    if mesh is not None:
        shard_params(mesh, model)
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, **ADAMW_DEFAULTS)
    return TrainState(model, opt, 0, mesh), opt


def _sum_over_data(mesh, tensors: list[torch.Tensor]) -> None:
    """Sum `tensors` in place over the mesh's data group, as one flat
    buffer a dtype."""
    group = mesh.get_group("data")
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """step(state, images, target_depth, valid) -> (state, loss): one
    AdamW step on the scale-invariant loss of `points[..., 2]`. Over a
    mesh, give it this rank's rows (`prepare_batch`); the loss it returns
    is the global one. It runs `model.forward` with grad enabled (never
    `moge_infer` or an inference-mode backend). The step's gradients stay
    on the parameters until the next step."""

    def step(state: TrainState, images, target_depth, valid):
        mesh = state.mesh
        dp = 1 if mesh is None else axis_size(mesh, "data")
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            pred = model(images)["points"][..., 2]
            sums = depth_sums(pred, target_depth, valid)
            if mesh is not None:
                # The other ranks' sums as constants: each rank
                # differentiates the global loss through its own rows.
                total = sums.detach().clone()
                dist.all_reduce(total, group=mesh.get_group("data"))
                sums = sums + (total - sums.detach())
            loss = loss_from_sums(sums)
            loss.backward()
        for p in model.parameters():
            if p.grad is None:  # unused by the loss: a zero gradient, decayed as optax does
                p.grad = torch.zeros_like(p)
        if dp > 1:
            _sum_over_data(mesh, [p.grad for p in model.parameters()])
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def prepare_batch(mesh, images, target_depth, valid):
    """This rank's rows of a host batch (`mesh.shard_batch`)."""
    return shard_batch(mesh, (images, target_depth, valid))
