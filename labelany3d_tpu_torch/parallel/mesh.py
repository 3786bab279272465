"""Device meshes over `torch.distributed` ranks, and the data split.

Counterpart of `labelany3d_tpu/parallel/mesh.py`. A JAX mesh is a grid of
the devices one program sees; here it is a grid of processes, one device
each, as `torch.distributed` runs them. `make_mesh` builds a ("data",
"model") `DeviceMesh` over the ranks of the default process group (which
the caller, or `parallel.launch`, has initialised): NCCL serves CUDA, gloo
the CPU. `shard_batch` gives this rank its rows of a host batch.

JAX's `data_sharding` and `replicated` name layouts of global arrays that
XLA's partitioner keeps; torch ranks hold only their local tensors, so they
have no counterpart: `shard_batch` slices the batch, and every other tensor
is simply the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXES = ("data", "model")


def mesh_shape(n: int, data: int = -1, model: int = 1) -> tuple[int, int]:
    """(data, model) of a mesh over `n` ranks, by the JAX package's rules:
    `data=-1` takes every rank the model axis leaves; raises `ValueError`
    for a model axis below 1, an `n` it does not divide (with `data=-1`),
    or a mesh larger than `n`."""
    if model < 1:
        raise ValueError("model axis must be >= 1")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return data, model


def make_mesh(data: int = -1, model: int = 1, device=None):
    """A ("data", "model") `DeviceMesh` over the first `data * model` ranks
    of the initialised default process group, laid out as JAX's: the model
    axis varies fastest, so a model group is neighbouring ranks. `device`
    None means CUDA; "cpu" means a gloo group on the CPU. Ranks past the
    mesh get a mesh they are not in (`get_coordinate()` is None)."""
    from torch.distributed.device_mesh import DeviceMesh

    from labelany3d_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.run_ranks or process_group)")
    data, model = mesh_shape(dist.get_world_size(), data, model)
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its CUDA device (by local rank
    among the visible ones), or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def shard_batch(mesh, tree):
    """This rank's axis-0 slice, in the data group, of each array of `tree`
    (a tuple, list or dict of numpy arrays or tensors; None stays None), as
    tensors on the mesh's device. Raises unless the data axis divides every
    leading dim."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    dev = mesh_device(mesh)

    def take(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # a NamedTuple
            return type(x)(*map(take, x))
        if isinstance(x, (tuple, list)):
            return type(x)(map(take, x))
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split over {n} data ranks")
        m = t.shape[0] // n
        t = t[r * m:(r + 1) * m]
        return t if t.is_meta else t.to(dev)

    return take(tree)
