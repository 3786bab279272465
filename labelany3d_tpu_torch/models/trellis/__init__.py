"""TRELLIS image -> 3D generative stack (PyTorch), the counterpart of
`labelany3d_tpu/models/trellis/`:

  image -> DINOv2 conditioning -> SparseStructureFlowModel (flow DiT over a
  16^3 latent) -> 64^3 occupancy voxels -> SLatFlowModel (sparse UNet + DiT
  over the voxels) -> decoders (3D Gaussians / FlexiCubes features) -> mesh
  with a baked texture.

Sparse voxels ride fixed slots with valid masks; the dense and masked DiT
attention runs K2 (`ops/attention.py::flash_sdpa`) and the conditioner K1 on
the card. Released weights convert through `models/convert_trellis.py`.
"""

from labelany3d_tpu_torch.models.trellis.decoders import (
    GaussianRepConfig,
    SLatDecoderConfig,
    SLatGaussianDecoder,
    SLatMeshDecoder,
    flexicubes_to_mesh,
)
from labelany3d_tpu_torch.models.trellis.dit import (
    DiTBlock,
    DiTConfig,
    TimestepEmbedder,
    TransformerBlock,
    ape_3d,
)
from labelany3d_tpu_torch.models.trellis.pipeline import TrellisPipeline, TrellisPipelineConfig
from labelany3d_tpu_torch.models.trellis.samplers import FlowSamplerConfig, flow_euler_sample
from labelany3d_tpu_torch.models.trellis.slat import SLatConfig, SLatFlowModel
from labelany3d_tpu_torch.models.trellis.sparse_structure import (
    SparseStructureConfig,
    SparseStructureFlowModel,
    SSDecoderConfig,
    StructureDecoder,
    decode_occupancy,
)

__all__ = [
    "DiTBlock", "DiTConfig", "TimestepEmbedder", "TransformerBlock", "ape_3d",
    "flow_euler_sample", "FlowSamplerConfig",
    "SparseStructureConfig", "SparseStructureFlowModel", "SSDecoderConfig",
    "StructureDecoder", "decode_occupancy",
    "SLatConfig", "SLatFlowModel",
    "GaussianRepConfig", "SLatDecoderConfig", "SLatGaussianDecoder",
    "SLatMeshDecoder", "flexicubes_to_mesh",
    "TrellisPipeline", "TrellisPipelineConfig",
]
