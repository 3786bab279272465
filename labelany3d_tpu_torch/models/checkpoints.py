"""The converted-weight store: `<checkpoint_dir>/<name>/params.safetensors`.

Counterpart of `labelany3d_tpu/models/checkpoints.py`. `<name>` is the
registry key the convert CLI writes and the backends read ('trellis_cond',
'svrm', 'mvd', ...). The file holds the converted Flax-layout tree (the
converters' output, which `models/weights.py::flax_to_state_dict` loads
into the port's models), each leaf under its tree path joined by '/', in
the dtype the converter gave it. The JAX package stores the same trees with
orbax, which the port cannot read: such a directory raises `ValueError`
asking for the checkpoint to be converted again with the port's CLI
(`python -m labelany3d_tpu_torch.models.convert_cli`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from labelany3d_tpu_torch.models.weights import _flatten
from labelany3d_tpu_torch.utils import safetensors_io

PARAMS_FILE = "params.safetensors"
# Files orbax writes into a checkpoint directory.
_ORBAX_MARKERS = ("_METADATA", "manifest.ocdbt", "_CHECKPOINT_METADATA", "_sharding")


def flatten_tree(tree) -> dict:
    """{'a': {'b': x}} -> {'a/b': x}, in the tree's order."""
    flat = {}
    for path, v in _flatten(tree):
        if any("/" in k for k in path):
            raise ValueError(f"tree path {path} holds '/', the store's path separator")
        flat["/".join(path)] = v
    return flat


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def _leaf(t: torch.Tensor):
    """numpy where numpy has the dtype; a bfloat16 leaf stays a torch tensor."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def save_params(checkpoint_dir: str, name: str, params: dict) -> str:
    """Write the tree `params` (leaves numpy arrays or torch tensors) as
    `<checkpoint_dir>/<name>/params.safetensors`, replacing what was there;
    returns the directory."""
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    safetensors_io.save_file(flatten_tree(params), tmp, metadata={"format": "flax-tree"})
    os.replace(tmp, os.path.join(path, PARAMS_FILE))
    return path


def _shape_dtype(x) -> tuple[tuple, torch.dtype]:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    x = np.asarray(x)
    return x.shape, torch.from_numpy(np.empty((0,), x.dtype)).dtype


def _check_like(flat: dict, like: dict, where: str) -> None:
    want = flatten_tree(like)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{where}: keys missing {missing[:8]} / not in `like` {extra[:8]}")
    for k, ref in want.items():
        got, exp = _shape_dtype(flat[k]), _shape_dtype(ref)
        if got != exp:
            raise ValueError(f"{where}: {k} is {got[1]} {got[0]}, `like` has {exp[1]} {exp[0]}")


def load_params(checkpoint_dir: str, name: str, like=None):
    """The tree stored under `name`, or None when `<checkpoint_dir>/<name>/`
    does not exist. A directory without the port's file (an orbax store of
    the JAX package) raises `ValueError`. With `like` (an example tree), a
    missing or extra key, or a shape or dtype other than `like`'s, raises."""
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    if not os.path.isdir(path):
        return None
    file = os.path.join(path, PARAMS_FILE)
    if not os.path.isfile(file):
        what = ("an orbax checkpoint written by the JAX package"
                if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS)
                else f"no {PARAMS_FILE}")
        raise ValueError(
            f"{path} holds {what}, which the PyTorch port cannot load; convert the released "
            f"checkpoint again with `python -m labelany3d_tpu_torch.models.convert_cli "
            f"{name} <checkpoint> --out {os.path.abspath(checkpoint_dir)}`")
    flat = safetensors_io.load_file(file)
    if like is not None:
        _check_like(flat, like, path)
    return unflatten_tree({k: _leaf(v) for k, v in flat.items()})


def convert_and_save_dinov2(torch_checkpoint: str, checkpoint_dir: str, name: str, cfg,
                            grid_hw) -> str:
    """torch DINOv2-style checkpoint -> converted tree in the store."""
    from labelany3d_tpu_torch.models.convert import convert_dinov2_vit, load_torch_checkpoint

    state = load_torch_checkpoint(torch_checkpoint)
    return save_params(checkpoint_dir, name, convert_dinov2_vit(state, cfg, grid_hw))
