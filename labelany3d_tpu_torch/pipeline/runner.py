"""CLI entry point: `python -m labelany3d_tpu_torch.pipeline.runner <stage> ...`.

Counterpart of `labelany3d_tpu/pipeline/runner.py`: the same flags
(--config, --start_index, --end_index, --split, --save_dir, --dataset_root)
plus dotted `key=value` config overrides. Stages:

  depth           stage 1  (MoGe + DepthPro -> aligned depth)
  enhance         stage 2  (4x upscale; run.enhance)
  crops           stage 3  (instance crops)
  completion      stage 4  (amodal completion; run.amodal_completion)
  elevation       stage 5  (per-object elevation; run.elevation)
  reconstruction  stage 6  (image -> 3D; run.obj_rec)
  layout          stage 7  (register meshes + ground-aligned boxes)
  boxes           stage 7's depth-only path (no generative stack)
  export          stage 8  (COCO3D Omni3D JSON)
  fast            fused depth + boxes -> crops -> export
  all             the eight stages in turn over the index range

The port has the shipping-default backend of each of stages 2, 4, 5 and 6,
the SD-class backends of stages 2, 4 and 5 (`run.enhance=invsr`,
`run.amodal_completion=our`, `run.elevation=zero123`), and TRELLIS and
Hunyuan3D for stage 6 (`run.obj_rec=trellis`, `hunyuan3d`,
`hunyuan3d_carve`). Unlike the JAX runner,
`all` keeps every stage's models loaded. Runs on CUDA; `--device cpu` runs
the plain PyTorch path on the CPU. The JAX runner's `--wild` mode is not
ported.
"""

from __future__ import annotations

import argparse

from labelany3d_tpu_torch.pipeline.config import PipelineConfig, load_config
from labelany3d_tpu_torch.utils.profiling import StageTimer

_STAGES = [
    "depth", "enhance", "crops", "completion", "elevation",
    "reconstruction", "layout", "boxes", "export", "fast", "all",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LabelAny3D PyTorch/CUDA pipeline runner")
    p.add_argument("stage", choices=_STAGES)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--end_index", type=int, default=1)
    p.add_argument("--split", default="val")
    p.add_argument("--save_dir", default="../experimental_results/COCO/")
    p.add_argument("--dataset_root", default="../dataset/coco")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p


def run_stages(stage: str, cfg: PipelineConfig, loader, source, save_dir: str, split: str,
               start_index: int, end_index: int, *, backend=None, matcher=None,
               enhance=None, completion=None, elevation=None,
               run_options: dict | None = None, preset: str = "large", tiny: bool = False,
               device=None, timer: StageTimer | None = None, stages: dict | None = None) -> dict:
    """Run one route over an index range; returns {stage: count}.

    `backend` defaults to `make_depth(preset)` pinned to the first bucket,
    and `matcher` to the registry's `TorchMatcherBackend` (the tiny matcher,
    as in the JAX package), both with random weights seeded from
    `cfg.seed`. The `enhance`, `completion` and `elevation` backends, and
    the reconstruction backend, default to the registry's choice from
    `run_options` (the config's `run` section: `enhance`,
    `amodal_completion`, `elevation`, `obj_rec`), whose defaults are the
    shipping ones. Each generative backend is built on `device`, at its
    tiny test config with `tiny` (the CLI's `models.tiny`), its random
    weights seeded from `cfg.seed`, as the JAX runner's `_backend` passes
    `tiny` to every factory.
    `stages`, when given, receives each stage object by name (a caller can
    read `stages["layout"].failures`)."""
    from labelany3d_tpu_torch.pipeline.backends import default_registry
    from labelany3d_tpu_torch.pipeline.stages import (
        BoxStage,
        CompletionStage,
        CropStage,
        DepthStage,
        ElevationStage,
        EnhanceStage,
        ExportStage,
        FusedFastStage,
        LayoutStage,
        ReconstructionStage,
    )

    timer = timer or StageTimer()
    counts = {}
    stages = {} if stages is None else stages
    run_options = run_options or {}
    registry = default_registry()
    gen_kw = {"tiny": tiny, "device": device, "seed": cfg.seed}

    def depth_backend():
        nonlocal backend
        if backend is None:
            backend = registry.get("depth", preset=preset, pin_hw=cfg.bucket_sizes()[0],
                                   device=device, seed=cfg.seed)
        return backend

    def run_fused():
        stages["fused"] = FusedFastStage(cfg, depth_backend(), loader, source, save_dir, split)
        return stages["fused"].run(start_index, end_index)

    def run_depth():
        stages["depth"] = DepthStage(cfg, depth_backend(), loader, source, save_dir, split)
        return stages["depth"].run(start_index, end_index)

    def run_enhance():
        nonlocal enhance
        if enhance is None:
            enhance = registry.get("enhance", backend=str(run_options.get("enhance", "bicubic")),
                                   **gen_kw)
        stages["enhance"] = EnhanceStage(cfg, loader, source, save_dir, split, backend=enhance)
        return stages["enhance"].run(start_index, end_index)

    def run_crops():
        # At CropStage's 512 px, as in the JAX package; the matcher resizes
        # reference crops to its views' size.
        return CropStage(cfg, loader, source, save_dir, split,
                         device=device).run(start_index, end_index)

    def run_completion():
        nonlocal completion
        if completion is None:
            mode = run_options.get("amodal_completion")
            completion = registry.get("completion", backend="our" if mode == "our" else "none",
                                      **gen_kw)
        stages["completion"] = CompletionStage(cfg, loader, save_dir, split, backend=completion)
        return stages["completion"].run(start_index, end_index)

    def run_elevation():
        nonlocal elevation
        if elevation is None:
            elevation = registry.get("elevation",
                                     backend=str(run_options.get("elevation", "zero")), **gen_kw)
        stages["elevation"] = ElevationStage(cfg, loader, save_dir, split, backend=elevation)
        return stages["elevation"].run(start_index, end_index)

    def run_reconstruction():
        backend_3d = registry.get("reconstruction",
                                  backend=str(run_options.get("obj_rec", "silhouette")), **gen_kw)
        stages["reconstruction"] = ReconstructionStage(cfg, loader, save_dir, split,
                                                       backend=backend_3d)
        return stages["reconstruction"].run(start_index, end_index)

    def run_layout():
        nonlocal matcher
        if matcher is None:
            matcher = registry.get("matcher", seed=cfg.seed, device=device)
        stages["layout"] = LayoutStage(cfg, loader, save_dir, split, matcher=matcher,
                                       device=device)
        return stages["layout"].run(start_index, end_index)

    def run_boxes():
        stages["boxes"] = BoxStage(cfg, loader, save_dir, split, device=device)
        return stages["boxes"].run(start_index, end_index)

    def run_export():
        return len(ExportStage(save_dir, split).run()["images"])

    routes = {"depth": [run_depth], "enhance": [run_enhance], "crops": [run_crops],
              "completion": [run_completion], "elevation": [run_elevation],
              "reconstruction": [run_reconstruction], "layout": [run_layout],
              "boxes": [run_boxes], "export": [run_export],
              "fast": [run_fused, run_crops, run_export],
              "all": [run_depth, run_enhance, run_crops, run_completion, run_elevation,
                      run_reconstruction, run_layout, run_export]}
    for fn in routes[stage]:
        name = fn.__name__.replace("run_", "")
        with timer.measure(name):
            n = fn()
        timer.add_items(name, n)
        counts[name] = n
        print(f"[{name}] {n} images")
    return counts


def main(argv=None, device=None) -> int:
    from labelany3d_tpu_torch.data.coconut import CoconutLoader, get_dataset_paths
    from labelany3d_tpu_torch.pipeline.stages.common import FileImageSource

    args, extras = build_parser().parse_known_args(argv)
    cfg_node = load_config(args.config, extras)
    cfg = PipelineConfig.from_node(cfg_node)
    images_root, annotations_dir = get_dataset_paths(args.split, args.dataset_root)
    loader = CoconutLoader(split=args.split, annotations_dir=annotations_dir)
    end = min(args.end_index, len(loader))
    start = min(args.start_index, end)
    tiny = bool(cfg_node.models.tiny)
    preset = "tiny_test" if tiny else str(cfg_node.models.moge.preset)
    timer = StageTimer()
    run_stages(args.stage, cfg, loader, FileImageSource(images_root), args.save_dir,
               args.split, start, end, run_options=cfg_node.run, preset=preset, tiny=tiny,
               device=device or args.device, timer=timer)
    print(timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
