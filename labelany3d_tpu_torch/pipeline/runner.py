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
`hunyuan3d_carve`), whose `trellis` and `hunyuan3d` backends read released
weights from the store under `models.ckpt_dir` (written by
`python -m labelany3d_tpu_torch.models.convert_cli`). As in the JAX runner,
a multi-stage route (`fast`, `all`) frees the models it built after each
stage. Runs on CUDA; `--device cpu` runs the plain PyTorch path on the CPU.

`--wild` is the in-the-wild mode: `--dataset_root` is a plain image folder
(`DirectoryLoader`), and the fused, crop and box stages take their
instances from the wild segmentation stack (`data/wild.py`:
`run.wild_segmentation` color | sam, `run.wild_foreground` border |
semantic | clipseg, `run.wild_tagger` constant | clip, weights from
`models.{sam,segformer,clipseg,clip}_path`) instead of COCONUT annotations.
"""

from __future__ import annotations

import argparse
import gc

import torch

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
    p.add_argument(
        "--wild", action="store_true",
        help="in-the-wild mode: --dataset_root is a plain image folder; instances come "
             "from the wild segmentation stack instead of COCONUT annotations")
    return p


def run_stages(stage: str, cfg: PipelineConfig, loader, source, save_dir: str, split: str,
               start_index: int, end_index: int, *, backend=None, matcher=None,
               enhance=None, completion=None, elevation=None,
               run_options: dict | None = None, preset: str = "large", tiny: bool = False,
               device=None, timer: StageTimer | None = None, stages: dict | None = None,
               instance_provider=None, ckpt_dir: str | None = None) -> dict:
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
    `ckpt_dir` (the CLI's `models.ckpt_dir`) goes to the reconstruction
    factory only, as in the JAX runner: its `trellis` and `hunyuan3d`
    backends read the store's converted weights.
    `stages`, when given, receives each stage object by name (a caller can
    read `stages["layout"].failures`); it is the caller's, so the models its
    stages hold stay loaded. `instance_provider` (wild mode's
    `WildInstanceProvider`) goes to the fused, crop and box stages, as the
    JAX runner passes it; by default they read COCONUT annotations.

    A multi-stage route (`fast`, `all`) frees, after each stage that built
    a model (the registry's, and the backends it chose), every model this
    call built, then runs `gc.collect()` and `torch.cuda.empty_cache()`, as
    the JAX runner unloads between stages. Backends the caller passed stay
    the caller's, and a stage that built nothing leaves the allocator's
    cache as it is."""
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
    own_stages = stages is None
    stages = {} if stages is None else stages
    # The models this call builds (and may free): those the caller left None.
    built = {name for name, v in (("backend", backend), ("matcher", matcher),
                                  ("enhance", enhance), ("completion", completion),
                                  ("elevation", elevation)) if v is None}
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
        stages["fused"] = FusedFastStage(cfg, depth_backend(), loader, source, save_dir, split,
                                         instance_provider=instance_provider)
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
        return CropStage(cfg, loader, source, save_dir, split, instance_provider=instance_provider,
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
                                  backend=str(run_options.get("obj_rec", "silhouette")),
                                  ckpt_dir=ckpt_dir, **gen_kw)
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
        stages["boxes"] = BoxStage(cfg, loader, save_dir, split,
                                   instance_provider=instance_provider, device=device)
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

    def unload():
        nonlocal backend, matcher, enhance, completion, elevation
        registry.unload_all()
        backend = None if "backend" in built else backend
        matcher = None if "matcher" in built else matcher
        enhance = None if "enhance" in built else enhance
        completion = None if "completion" in built else completion
        elevation = None if "elevation" in built else elevation
        if own_stages:
            stages.clear()
        gc.collect()
        torch.cuda.empty_cache()

    multi = len(routes[stage]) > 1
    for fn in routes[stage]:
        name = fn.__name__.replace("run_", "")
        with timer.measure(name):
            n = fn()
        timer.add_items(name, n)
        counts[name] = n
        print(f"[{name}] {n} images")
        if multi and registry.loaded():  # every model this call builds is the registry's
            unload()
    return counts


def main(argv=None, device=None) -> int:
    from labelany3d_tpu_torch.data.coconut import CoconutLoader, get_dataset_paths
    from labelany3d_tpu_torch.pipeline.stages.common import FileImageSource

    args, extras = build_parser().parse_known_args(argv)
    cfg_node = load_config(args.config, extras)
    cfg = PipelineConfig.from_node(cfg_node)
    device = device or args.device
    provider = None
    if args.wild:
        from labelany3d_tpu_torch.data.sources import DirectoryLoader, WildInstanceProvider
        from labelany3d_tpu_torch.data.wild import make_wild_source

        images_root = args.dataset_root
        loader = DirectoryLoader(images_root)
        provider = WildInstanceProvider(make_wild_source(
            foreground=str(cfg_node.run.wild_foreground),
            tagger=str(cfg_node.run.wild_tagger),
            segmentation=str(cfg_node.run.wild_segmentation),
            clipseg_path=cfg_node.models.clipseg_path,
            clip_path=cfg_node.models.clip_path,
            sam_path=cfg_node.models.sam_path,
            segformer_path=cfg_node.models.segformer_path,
            device=device,
        ))
    else:
        images_root, annotations_dir = get_dataset_paths(args.split, args.dataset_root)
        loader = CoconutLoader(split=args.split, annotations_dir=annotations_dir)
    end = min(args.end_index, len(loader))
    start = min(args.start_index, end)
    tiny = bool(cfg_node.models.tiny)
    preset = "tiny_test" if tiny else str(cfg_node.models.moge.preset)
    timer = StageTimer()
    run_stages(args.stage, cfg, loader, FileImageSource(images_root), args.save_dir,
               args.split, start, end, run_options=cfg_node.run, preset=preset, tiny=tiny,
               device=device, timer=timer, instance_provider=provider,
               ckpt_dir=cfg_node.models.ckpt_dir)
    print(timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
