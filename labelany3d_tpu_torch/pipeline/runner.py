"""CLI entry point: `python -m labelany3d_tpu_torch.pipeline.runner <stage> ...`.

Counterpart of `labelany3d_tpu/pipeline/runner.py` for the routes the port
has: the same flags (--config, --start_index, --end_index, --split,
--save_dir, --dataset_root) plus dotted `key=value` config overrides.

  crops   stage 3  (instance crops)
  export  stage 8  (COCO3D Omni3D JSON)
  fast    fused depth + boxes -> crops -> export

Runs on CUDA; `--device cpu` runs the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse

from labelany3d_tpu_torch.pipeline.config import PipelineConfig, load_config
from labelany3d_tpu_torch.utils.profiling import StageTimer

_STAGES = ["crops", "export", "fast"]


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
               start_index: int, end_index: int, *, backend=None, preset: str = "large",
               device=None, timer: StageTimer | None = None) -> dict:
    """Run one route over an index range; returns {stage: count}.

    `backend` defaults to `make_depth(preset)` pinned to the first bucket,
    with random weights seeded from `cfg.seed`."""
    from labelany3d_tpu_torch.pipeline.stages import CropStage, ExportStage, FusedFastStage

    timer = timer or StageTimer()
    counts = {}

    def run_fused():
        nonlocal backend
        if backend is None:
            from labelany3d_tpu_torch.pipeline.backends import default_registry

            backend = default_registry().get("depth", preset=preset,
                                             pin_hw=cfg.bucket_sizes()[0], device=device,
                                             seed=cfg.seed)
        return FusedFastStage(cfg, backend, loader, source, save_dir, split).run(
            start_index, end_index)

    def run_crops():
        return CropStage(cfg, loader, source, save_dir, split, device=device).run(
            start_index, end_index)

    def run_export():
        return len(ExportStage(save_dir, split).run()["images"])

    routes = {"crops": [run_crops], "export": [run_export],
              "fast": [run_fused, run_crops, run_export]}
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
    preset = "tiny_test" if bool(cfg_node.models.tiny) else str(cfg_node.models.moge.preset)
    timer = StageTimer()
    run_stages(args.stage, cfg, loader, FileImageSource(images_root), args.save_dir,
               args.split, start, end, preset=preset, device=device or args.device,
               timer=timer)
    print(timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
