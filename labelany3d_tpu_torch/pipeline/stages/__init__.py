"""Stages of the port: depth, enhance, crops, completion, elevation,
reconstruction, layout, the depth-only boxes stage and export, and the
fused `fast` stage."""

from labelany3d_tpu_torch.pipeline.stages.boxes import BoxStage
from labelany3d_tpu_torch.pipeline.stages.crops import CropStage
from labelany3d_tpu_torch.pipeline.stages.depth import DepthStage
from labelany3d_tpu_torch.pipeline.stages.export import ExportStage
from labelany3d_tpu_torch.pipeline.stages.fused import FusedFastStage
from labelany3d_tpu_torch.pipeline.stages.generative import (
    BicubicEnhance,
    CompletionStage,
    ElevationStage,
    EnhanceStage,
    PassthroughCompletion,
    ReconstructionStage,
    SilhouetteExtrude,
    ZeroElevation,
)
from labelany3d_tpu_torch.pipeline.stages.layout import LayoutStage

__all__ = ["BicubicEnhance", "BoxStage", "CompletionStage", "CropStage", "DepthStage",
           "ElevationStage", "EnhanceStage", "ExportStage", "FusedFastStage", "LayoutStage",
           "PassthroughCompletion", "ReconstructionStage", "SilhouetteExtrude",
           "ZeroElevation"]
