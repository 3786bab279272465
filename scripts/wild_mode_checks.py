#!/usr/bin/env python3
"""Wild mode on one GPU: what `--wild` costs the `fast` route, and why
`chip_smoke.py` phase 14 draws its weights at two scales.

    python3 scripts/wild_mode_checks.py

  * The `fast` route at the `large` preset over `chip_smoke.py`'s 16
    synthetic 512x512 images, without and with the wild provider (SAM ViT-B
    relaxed as phase 14(b) relaxes it, the SegFormer-B0 filter, the
    constant tagger), one cold pass of each, then warm passes in the order
    fast, wild, wild, fast: seconds, images/s and stage seconds of each.
  * SAM ViT-B's grid decode on one image with released-layout weights drawn
    at std 0.02 and at phase 14's `WILD_STD`: the largest mask logit and
    IoU prediction, and the masks kept at the relaxed and at the shipping
    thresholds.
  * Phase 14(d)'s card-against-CPU readings with its weights drawn at
    0.02 (`WILD_CHECK_STD`) and at `WILD_STD`.

Builds the kernels into `build/kernels/`; needs nvcc and one GPU. Prints
the card's name and power limit, then one JSON line per measurement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def route_passes(trees: dict) -> None:
    import torch

    import chip_smoke as cs
    from labelany3d_tpu_torch.data.sources import WildInstanceProvider
    from labelany3d_tpu_torch.data.wild import ConstantTagger, WildInstanceSource
    from labelany3d_tpu_torch.models.segformer import SegFormerConfig, SegformerForeground
    from labelany3d_tpu_torch.pipeline.backends import default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils.profiling import StageTimer

    cfg = PipelineConfig()
    loader = cs.SyntheticLoader(cs.N_IMAGES, cs.IMAGE_HW, seed=0)
    source = ArrayImageSource(loader.pixels)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    provider = WildInstanceProvider(WildInstanceSource(
        cs.CountingSegmentation(trees["sam"]),
        SegformerForeground(SegFormerConfig.b0(), params=trees["segformer"], device="cuda"),
        ConstantTagger(), overlap_threshold=-1.0))
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(["fast", "wild", "fast", "wild", "wild", "fast"]):
            timer = StageTimer()
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_stages("fast", cfg, loader, source, os.path.join(tmp, f"{name}{i}"), "val", 0,
                       cs.N_IMAGES, backend=backend, device="cuda", timer=timer,
                       instance_provider=provider if name == "wild" else None)
            torch.cuda.synchronize()
            s = time.perf_counter() - t
            print(json.dumps({"route_pass": i, "route": name, "cold": i < 2, "s": s,
                              "images_per_s": cs.N_IMAGES / s,
                              "stage_s": {k: timer.stats[k].total_seconds
                                          for k in ("fused", "crops", "export")}}), flush=True)


def logit_scale() -> None:
    import numpy as np

    import chip_smoke as cs
    from labelany3d_tpu_torch.models.sam import SamAutoSegmentation, SamConfig, convert_sam

    cfg = SamConfig.vit_base()
    img = cs.synthetic_scene(np.random.default_rng(14), cs.IMAGE_HW, 8)[0]
    for std in (0.02, cs.WILD_STD):
        tree = convert_sam(cs.released_sam_state(cfg, std=std, device="cuda"), cfg)
        relaxed = SamAutoSegmentation(cfg, params=tree, points_per_side=cs.WILD_POINTS,
                                      device="cuda", **cs.WILD_RELAXED)
        logits, iou = relaxed.decode_grid(img)
        shipping = SamAutoSegmentation(cfg, points_per_side=cs.WILD_POINTS, device="cuda")
        print(json.dumps({"sam_std": std, "max_abs_logit": float(np.abs(logits).max()),
                          "max_iou_pred": float(iou.max()),
                          "kept_relaxed": len(relaxed.select(logits, iou, img.shape[:2])),
                          "kept_shipping": len(shipping.select(logits, iou, img.shape[:2]))}),
              flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from labelany3d_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("wild_mode_checks: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.build_all()
    trees, _ = cs.wild_weights()
    route_passes(trees)
    del trees
    torch.cuda.empty_cache()
    logit_scale()
    for std in (cs.WILD_CHECK_STD, cs.WILD_STD):
        cs.WILD_CHECK_STD = std
        print(json.dumps({"check_std": std, **cs.wild_card_vs_cpu()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
