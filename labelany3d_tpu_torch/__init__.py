"""PyTorch/CUDA port of LabelAny3D-TPU for one NVIDIA Hopper GPU.

The package mirrors the layout of `labelany3d_tpu` (the JAX reference):
`models/vit.py` here is the counterpart of `labelany3d_tpu/models/vit.py`,
and so on. It imports `torch` and never JAX, Flax or the JAX package.

Entry points run on CUDA unless the caller passes `device="cpu"`; the TPU
kernels of the JAX package are hand-written Hopper kernels under `csrc/`,
each with a plain PyTorch version beside its wrapper (`ops/`).
"""

from labelany3d_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
