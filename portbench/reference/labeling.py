# Frozen copy of labelany3d_tpu_torch/pipeline/labeling.py, the benchmark's yardstick: plain
# PyTorch that imports nothing of the port (attention: reference/attention.py).
"""Fused batched labeling program (the pipeline's device-side core).

Counterpart of `labelany3d_tpu/pipeline/labeling.py`:

  depth_fusion:     relative + metric depth -> aligned metric depth
                    (hypothesis-batch RANSAC per image)
  label_instances:  depth + K + instance masks -> oriented 3D boxes
                    (back-project once, per-instance point sampling, box fit)

PyTorch runs eagerly, so the "program" is a plain function on the device of
its inputs, run with TF32 off. Random draws are explicit: `LabelingDraws`
injects them (parity tests pass the JAX package's), else they come from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .align import RansacDraws, align_depth_affine
from .backproject import depth_to_points, gather_instance_points
from .boxfit import BoxEstimate, fit_boxes_batch
from .precision import full_f32


class LabelingOutput(NamedTuple):
    boxes: BoxEstimate         # fields batched (B, I, ...)
    points: torch.Tensor       # (B, H, W, 3)
    num_valid: torch.Tensor    # (B,)


class LabelingDraws(NamedTuple):
    ransac: RansacDraws | None = None
    samples: torch.Tensor | None = None   # (B, I, S) ranks among mask pixels


def depth_fusion(relative_depth, metric_depth, mask, draws: RansacDraws | None = None, *,
                 generator: torch.Generator | None = None, intercept: bool = False,
                 max_valid_depth: float | None = 400.0) -> torch.Tensor:
    """Batched RANSAC depth alignment; (B, H, W) -> (B, H, W)."""
    return align_depth_affine(relative_depth, metric_depth, mask, draws, intercept=intercept,
                              max_valid_depth=max_valid_depth, generator=generator)


def unpack_instance_masks(packed: torch.Tensor, num_instances: int) -> torch.Tensor:
    """(..., H, W) bitfield -> (..., I, H, W) bool. Widened to int64 first:
    shifts of unsigned 16/32-bit tensors are not supported everywhere."""
    wide = packed.to(torch.int64)
    bits = torch.arange(num_instances, dtype=torch.int64, device=packed.device)
    return ((wide[..., None, :, :] >> bits[:, None, None]) & 1).bool()


def label_instances(depth, K, masks, draws: torch.Tensor | None = None, *,
                    generator: torch.Generator | None = None, num_points: int = 500,
                    method: str = "pca", max_depth_valid: float = 9000.0) -> LabelingOutput:
    """Depth-only 3D boxes for a batch: depth (B, H, W), K (B, 3, 3) or
    (3, 3), masks (B, I, H, W) bool; `draws` (B, I, S) sample ranks."""
    with full_f32():
        depth = depth.float()
        points = depth_to_points(depth, K)
        depth_ok = (depth > 0) & (depth < max_depth_valid) & torch.isfinite(depth)
        eff = masks & depth_ok[:, None]
        pts, valid_inst = gather_instance_points(points, eff, num_points, draws, generator)
        point_valid = valid_inst[..., None].expand(pts.shape[:-1])
        boxes = fit_boxes_batch(pts, point_valid, None, method=method)
    return LabelingOutput(boxes=boxes, points=points, num_valid=valid_inst.sum(-1))


def label_program(depth, K, packed, *, max_instances: int, num_points: int, method: str,
                  draws: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> LabelingOutput:
    """Box labeling of a batch from bit-packed masks (the boxes stage):
    depth (B, H, W), K (B, 3, 3), packed (B, H, W) bitfield; `draws`
    (B, I, S) sample ranks, else drawn from `generator`."""
    return label_instances(depth, K, unpack_instance_masks(packed, max_instances), draws,
                           generator=generator, num_points=num_points, method=method)


def fused_label_program(rel, met, dmask, K, packed, *, max_instances: int, num_points: int,
                        method: str, draws: LabelingDraws | None = None,
                        generator: torch.Generator | None = None):
    """Depth fusion + box labeling; returns (aligned depth, boxes)."""
    draws = draws or LabelingDraws()
    with full_f32():
        aligned = depth_fusion(rel, met, dmask, draws.ransac, generator=generator)
        out = label_instances(aligned, K, unpack_instance_masks(packed, max_instances),
                              draws.samples, generator=generator, num_points=num_points,
                              method=method)
    return aligned, out.boxes


def labeling_step(relative_depth, metric_depth, depth_mask, K, masks,
                  draws: LabelingDraws | None = None, generator: torch.Generator | None = None,
                  **label_kwargs):
    """Align depths, then label instances (boolean masks)."""
    draws = draws or LabelingDraws()
    aligned = depth_fusion(relative_depth, metric_depth, depth_mask, draws.ransac,
                           generator=generator)
    return aligned, label_instances(aligned, K, masks, draws.samples, generator=generator,
                                    **label_kwargs)
