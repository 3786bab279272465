"""Multi-device parallelism over `torch.distributed`: meshes, the Megatron
layout, sequence-parallel attention, the fine-tuning step.

Counterpart of `labelany3d_tpu/parallel/`. A mesh is a ("data", "model")
`DeviceMesh` over processes, one device each (`launch.run_ranks` spawns
them; NCCL on CUDA, gloo on the CPU):

  * labeling and inference: the image batch split over "data"
    (`mesh.shard_batch`; the depth backend's `devices=` splits by rows in
    one process);
  * model parameters tensor-parallel over "model" (`sharding.shard_params`:
    attention heads and MLP hidden units, collectives where Megatron puts
    them);
  * fine-tuning (`train`): the dp x tp step, the loss global over "data"
    and the gradients summed over it.

JAX's `data_sharding` and `replicated` name layouts of global arrays; torch
ranks hold local tensors, so they have no counterpart here.
"""

from labelany3d_tpu_torch.parallel.mesh import make_mesh, mesh_shape, shard_batch
from labelany3d_tpu_torch.parallel.sharding import param_pspecs, shard_params, vit_param_spec
from labelany3d_tpu_torch.parallel.train import (
    TrainState,
    depth_loss,
    init_train_state,
    make_train_step,
    prepare_batch,
)

__all__ = [
    "make_mesh", "mesh_shape", "shard_batch", "vit_param_spec", "shard_params",
    "param_pspecs", "TrainState", "make_train_step", "init_train_state", "depth_loss",
    "prepare_batch",
]
