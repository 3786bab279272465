"""Stages of the port: the `fast` route (FusedFastStage, CropStage,
ExportStage) and the registration chain depth -> crops -> reconstruction ->
layout -> export (DepthStage, ReconstructionStage, LayoutStage). The
enhance, completion and elevation stages and the separate boxes stage wait."""

from labelany3d_tpu_torch.pipeline.stages.crops import CropStage
from labelany3d_tpu_torch.pipeline.stages.depth import DepthStage
from labelany3d_tpu_torch.pipeline.stages.export import ExportStage
from labelany3d_tpu_torch.pipeline.stages.fused import FusedFastStage
from labelany3d_tpu_torch.pipeline.stages.generative import ReconstructionStage, SilhouetteExtrude
from labelany3d_tpu_torch.pipeline.stages.layout import LayoutStage

__all__ = ["CropStage", "DepthStage", "ExportStage", "FusedFastStage", "LayoutStage",
           "ReconstructionStage", "SilhouetteExtrude"]
