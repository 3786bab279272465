"""Stages of the `fast` route: FusedFastStage (depth + boxes), CropStage,
ExportStage. The separate depth/boxes chain and the generative stages wait."""

from labelany3d_tpu_torch.pipeline.stages.crops import CropStage
from labelany3d_tpu_torch.pipeline.stages.export import ExportStage
from labelany3d_tpu_torch.pipeline.stages.fused import FusedFastStage

__all__ = ["CropStage", "ExportStage", "FusedFastStage"]
