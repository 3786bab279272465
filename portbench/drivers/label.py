"""Driver of the labelling cells: the port's fused fast pass over a split.

Set-up writes the traffic's COCONUT-format split under the scratch
directory, draws the depth models' weights on the device from the seed
(rounded to the bf16 the backend serves), builds the port's
`TorchDepthBackend` around them, and warms the pass on one batch. The
window runs `FusedFastStage.run` over consecutive shards of the split, as
a CLI `--start_index/--end_index` slice would, each into a fresh scene
root that is deleted after the shard, until `--seconds` have passed.

The harness hands the stage a wrapper of the backend: it records the
`depth.infer` span, brackets the backend's launches with marker kernels in
traced runs, and keeps, for one batch of the window drawn from the seed,
the backend's outputs and the labelling generator's state; that batch's
scene directories are kept.

`correct`, once the window has closed and the program is freed, stage by
stage (the focal and shift that MoGe's recovery solves for are
ill-conditioned on the point maps of random weights, so a comparison of
the whole chain swings by two orders of magnitude from seed to seed):
  * the networks against the plain reference (float32, TF32 off), on rows
    of that batch drawn from the seed, each from its JPEG: MoGe's point map
    (`points_rel`, relative L2) and mask probability (`mask_rel`), and
    DepthPro's canonical inverse depth (`canonical_rel`);
  * the backend's assembly (MoGe's focal and shift recovery, the pixel
    intrinsics, DepthPro's metric depth at the focal, the resizes) by the
    reference from the networks' outputs the program produced, against the
    backend's outputs, over the whole batch (`assembly_rel`: the worst of
    relative depth, metric depth and K, each relative);
  * the scene files of the whole batch against the reference labelling
    program run on the backend's outputs of that batch with the
    generator's state: aligned depth (`aligned_rel`, depth_map.npy), K
    (`k_rel`, cam_params.json), and the boxes (`box_gap`, 3dbbox.json:
    centres, dimensions, rotations and vertices over the scene's scale; a
    box on one side only reads inf).
The second and third follow the program from its own state, step by step;
the first checks the start they take.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from common import checks, env, weights
from common.trace import Window
from drivers.train import as_f32
from gen import coconut_split

FAULTS = ("rows_dropped", "box_altered")


def model_configs(cfg: dict, port: bool):
    """(MoGe config, DepthPro35 config): the port's, or the reference's in
    float32."""
    if port:
        from labelany3d_tpu_torch.models.depth_pro import DepthPro35Config
        from labelany3d_tpu_torch.models.moge import MoGeConfig
    else:
        from reference.depth_pro import DepthPro35Config
        from reference.moge import MoGeConfig
    moge = getattr(MoGeConfig, cfg["moge"])()
    dp = DepthPro35Config() if cfg["depth_pro"] == "default" else \
        getattr(DepthPro35Config, cfg["depth_pro"])()
    return (moge, dp) if port else (as_f32(moge), as_f32(dp))


def reference_models(cfg: dict, device):
    from reference.depth_pro import DepthPro35
    from reference.moge import MoGeModel

    moge_cfg, dp_cfg = model_configs(cfg, port=False)
    with torch.device("meta"):
        moge = MoGeModel(moge_cfg, tuple(cfg["bucket"]))
        dp = DepthPro35(dp_cfg)
    if device == "meta":
        return moge, dp, dp_cfg
    return moge.to_empty(device=device), dp.to_empty(device=device), dp_cfg


def draw_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """The two models' weights from the seed, rounded to bf16 where the
    backend serves bf16, as float32."""
    moge, dp, _ = reference_models(cfg, "meta")
    g = cfg["layerscale_gamma"]
    return (weights.served(weights.draw(weights.recipe(moge, g), seed, device), moge,
                           torch.bfloat16),
            weights.served(weights.draw(weights.recipe(dp, g), seed + 1, device), dp,
                           torch.bfloat16))


class Tap:
    """A model the backend calls, whose outputs are kept while `on`."""

    def __init__(self, model):
        self.model = model
        self.on = False
        self.out = None

    def __call__(self, x):
        out = self.model(x)
        if self.on:
            self.out = {k: v.clone() for k, v in out.items()}
        return out


class Backend:
    """The harness's wrapper of the depth backend the stage is handed."""

    def __init__(self, inner, win_ref: list, fault: str | None):
        self.inner = inner
        self.device = inner.device
        self.win_ref = win_ref          # [Window] while the window runs
        self.fault = fault
        self.calls = 0
        self.capture_at = None
        self.stage = None
        self.captured = None
        self.taps = (Tap(inner.moge), Tap(inner.depth_pro))
        inner.moge, inner.depth_pro = self.taps

    def infer(self, images):
        win = self.win_ref[0] if self.win_ref else None
        if win is None:
            return self.inner.infer(images)
        capture = self.calls == self.capture_at
        for tap in self.taps:
            tap.on = capture
        with win.span("depth.infer"):
            win.mark()
            if self.fault == "rows_dropped":
                half = images[:images.shape[0] // 2]
                out = self.inner.infer(np.concatenate([half, half])[:images.shape[0]])
            else:
                out = self.inner.infer(images)
            win.mark()
        if capture:
            self.captured = {"out": {k: v.clone() for k, v in out.items()},
                             "moge": self.taps[0].out, "depth_pro": self.taps[1].out,
                             "generator": self.stage.generator.get_state()}
            for tap in self.taps:
                tap.on, tap.out = False, None
        self.calls += 1
        return out


def build_backend(cfg: dict, seed: int, device, cache: dict | None = None):
    """The port's depth backend holding the benchmark's weights (the
    models in `cache` reloaded, where a caller keeps them)."""
    from labelany3d_tpu_torch.models.depth_pro import DepthPro35
    from labelany3d_tpu_torch.models.moge import MoGeModel
    from labelany3d_tpu_torch.models.weights import cast_inference_params_
    from labelany3d_tpu_torch.pipeline.backends import TorchDepthBackend

    moge_cfg, dp_cfg = model_configs(cfg, port=True)
    backend = TorchDepthBackend(moge_cfg, dp_cfg, seed=seed, pin_hw=tuple(cfg["bucket"]),
                                device=device, use_mesh=False)
    w_moge, w_dp = draw_weights(cfg, seed, device)
    if cache and "label_models" in cache:
        models = cache["label_models"]
        for model, state in zip(models, (w_moge, w_dp)):
            model.load_state_dict(state)
    else:
        with torch.device("meta"):
            moge = MoGeModel(moge_cfg, tuple(cfg["bucket"]))
            dp = DepthPro35(dp_cfg)
        models = []
        for model, state in ((moge, w_moge), (dp, w_dp)):
            model = model.to_empty(device=device)
            model.load_state_dict(state)
            models.append(cast_inference_params_(model).eval().requires_grad_(False))
        if cache is not None:
            cache["label_models"] = models
    del w_moge, w_dp
    # The backend builds its models on first use unless it holds them.
    backend.moge, backend.depth_pro = models
    return backend


def pipeline_config(cfg: dict, seed: int):
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig

    h, w = cfg["bucket"]
    return PipelineConfig(batch_size=cfg["batch_size"], max_instances=cfg["max_instances"],
                          num_points=cfg["num_points"], image_height=h, image_width=w,
                          bbox_method=cfg["bbox_method"], seed=seed)


def run(cell: dict, cfg: dict, traffic: dict, opts) -> checks.Result:
    from labelany3d_tpu_torch.data.coconut import CoconutLoader
    from labelany3d_tpu_torch.pipeline.stages.common import FileImageSource
    from labelany3d_tpu_torch.pipeline.stages.fused import FusedFastStage

    dev = opts.device
    scratch = env.scratch_dir(cell["name"])
    split = coconut_split.write(traffic, opts.seed, scratch / "dataset")
    loader = CoconutLoader("val", str(split["annotation_dir"]))
    source = FileImageSource(str(split["image_dir"]))
    pcfg = pipeline_config(cfg, opts.seed)
    win_ref: list = []
    backend = Backend(build_backend(cfg, opts.seed, dev, opts.cache), win_ref, opts.fault)
    shard = int(traffic["shard"])
    n_shards = len(loader) // shard
    rng = np.random.default_rng(opts.seed)
    backend.capture_at = int(rng.integers(0, shard // cfg["batch_size"]))
    check_rows = sorted(rng.choice(cfg["batch_size"], cfg["check_rows"], replace=False).tolist())

    def make_stage(root):
        stage = FusedFastStage(pcfg, backend, loader, source, str(root), "val")
        backend.stage = stage
        return stage

    # Warm-up: one batch through the pass, its scene root deleted.
    warm = scratch / "warm"
    make_stage(warm).run(0, cfg["batch_size"])
    shutil.rmtree(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - opts.t_start

    kept = scratch / "kept"
    kept.mkdir()
    written: list = []
    images = attempted = 0
    k = 0
    shard_s: list = []
    with Window(opts.trace, dev) as win:
        win_ref.append(win)
        while True:
            start = (k % n_shards) * shard
            root = scratch / f"scenes{k}"
            stage = make_stage(root)
            _capture_writes(stage, backend.capture_at if k == 0 else None, written,
                            opts.fault == "box_altered")
            t0 = time.perf_counter()
            with win.span("stage.fused"):
                done = stage.run(start, start + shard)
            shard_s.append(time.perf_counter() - t0)
            images += done
            attempted += shard
            for scene in written if k == 0 else ():
                os.rename(scene.root, kept / scene.root.name)
            shutil.rmtree(root)
            k += 1
            if win.elapsed() >= opts.seconds:
                break
        win.close()
        win_ref.clear()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    notes = [f"window: {k} shards, {images} images in {win.seconds:.6f} s; shards "
             f"{', '.join(f'{s:.3f}' for s in shard_s)} s",
             f"scene bytes written: {images * _scene_bytes(kept)} (about "
             f"{_scene_bytes(kept)} a scene)"]
    captured = backend.captured
    backend.inner.moge = backend.inner.depth_pro = backend.taps = None
    backend.captured = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = {}
    if captured is not None and len(written) == cfg["batch_size"]:
        readings = judge(cfg, opts.seed, dev, split, loader, captured, written, kept,
                         check_rows, opts.control)
    shutil.rmtree(scratch, ignore_errors=True)
    metrics = {"setup_s": setup_s, "label_images_per_s": images / win.seconds}
    return checks.Result(metrics=metrics, checks=checks.held(readings, cfg["limits"]),
                         attempted=attempted, failed=attempted - images, memory_peak_bytes=peak,
                         window=win, counts={"images": images, "shards": k,
                                             "batches": backend.calls},
                         notes=notes)


def _capture_writes(stage, at, written: list, alter: bool) -> None:
    """Keep the scene directories of the `at`-th batch the stage writes;
    with `alter` (a planted fault), move each batch's first box by 1%
    before it is written."""
    inner = stage._write
    calls = [0]

    def write(bucket, group, aligned, K_bucket, boxes):
        if calls[0] == at:
            written.extend(g[1] for g in group)
        calls[0] += 1
        if alter:
            boxes = dict(boxes, center_cam=boxes["center_cam"].copy())
            ok = np.argwhere(boxes["ok"])
            if len(ok):
                boxes["center_cam"][tuple(ok[0])] *= 1.01
        return inner(bucket, group, aligned, K_bucket, boxes)

    stage._write = write


def _scene_bytes(kept: Path) -> int:
    files = [p for p in kept.rglob("*") if p.is_file()]
    n = len([p for p in kept.iterdir() if p.is_dir()])
    return sum(p.stat().st_size for p in files) // max(n, 1)


def judge(cfg, seed, dev, split, loader, captured, written, kept, rows,
          precision: str | None = None) -> dict:
    """The compared numbers (see the module's docstring). With `precision`
    ("fp8"), the reference in the lower precisions stands in the program's
    place (the control): its networks in fp8 on the same rows; its
    assembly and labelling with TF32 on; each against the float32
    reference's."""
    from PIL import Image

    from reference import precision as prec
    from reference.depth_backend import infer, resize_image
    from reference.layers import resize

    names = [Path(s.root).name for s in written]
    by_name = {Path(im["file_name"]).stem: im for im in loader.images}
    imgs = [by_name[n] for n in names]
    bh, bw = cfg["bucket"]
    out = captured["out"]

    # The networks on the sampled rows, each from its JPEG.
    batch = np.stack([resize_image(np.asarray(Image.open(split["image_dir"] / im["file_name"])
                                              .convert("RGB")), bh, bw) for im in imgs])
    moge, dp, dp_cfg = reference_models(cfg, dev)
    w_moge, w_dp = draw_weights(cfg, seed, dev)
    moge.load_state_dict(w_moge)
    dp.load_state_dict(w_dp)
    del w_moge, w_dp
    moge.eval().requires_grad_(False)
    dp.eval().requires_grad_(False)
    s = dp_cfg.img_size
    x = torch.as_tensor(batch[rows], device=dev).float() / 255.0
    x_dp = resize(x.permute(0, 3, 1, 2), (s, s)).permute(0, 2, 3, 1)

    def networks():
        with torch.no_grad(), prec.full_f32():
            return moge(x), dp(x_dp)

    ref_m, ref_d = networks()
    if precision:
        with prec.lower(precision):
            got_m, got_d = networks()
    else:
        got_m = {k: v[rows] for k, v in captured["moge"].items()}
        got_d = {k: v[rows] for k, v in captured["depth_pro"].items()}
    del moge, dp
    gc.collect()
    res = {"points_rel": max(checks.rel_l2(a, b) for a, b in zip(got_m["points"], ref_m["points"])),
           "mask_rel": max(checks.rel_l2(a, b) for a, b in zip(got_m["mask"], ref_m["mask"])),
           "canonical_rel": max(checks.rel_l2(a, b) for a, b in
                                zip(got_d["canonical_inverse_depth"],
                                    ref_d["canonical_inverse_depth"]))}
    del ref_m, ref_d, got_m, got_d, x, x_dp

    # The assembly, from the networks' outputs the program produced.
    def assemble(lower):
        fixed_m, fixed_d = (lambda _x: captured["moge"]), (lambda _x: captured["depth_pro"])
        blank = torch.zeros(out["relative_depth"].shape + (3,), dtype=torch.uint8, device=dev)
        with prec.lower(lower) if lower else contextlib.nullcontext():
            return infer(fixed_m, fixed_d, s, blank)

    want = assemble(None)
    have = assemble("tf32") if precision else out
    gaps = [float((have["K_pixels"] - want["K_pixels"]).abs().max()
                  / want["K_pixels"].abs().max()),
            checks.rel_l2(have["metric_depth"], want["metric_depth"])]
    for a, b in zip(have["relative_depth"], want["relative_depth"]):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        gaps.append(math.inf if bool((fa != fb).any()) else checks.rel_l2(a[fa], b[fb]))
    res["assembly_rel"] = max(gaps)
    del want, have

    # The labelling program on the backend's outputs of the whole batch.
    from reference.instances import kept_instances, packed_masks

    anns = [kept_instances(loader.get_annotations(im["id"]), im["width"], im["height"])
            for im in imgs]
    packed = torch.as_tensor(np.stack([packed_masks([m for m, _, _ in a], bh, bw,
                                                    cfg["max_instances"]) for a in anns]),
                             device=dev)
    want = _label(cfg, out, packed, captured["generator"], imgs, None)
    if precision:
        have = _label(cfg, out, packed, captured["generator"], imgs, "tf32")
    else:
        have = [_read_scene(kept / n) for n in names]
    res.update(_scene_gaps(have, want, anns, cfg["max_instances"]))
    return res


def _label(cfg, out, packed, gen_state, imgs, precision) -> list[dict]:
    """The reference labelling program's scene files, as dicts."""
    from reference import precision as prec
    from reference.instances import resize_nearest
    from reference.labeling import fused_label_program

    gen = torch.Generator(device=packed.device)
    gen.set_state(gen_state)
    with prec.lower(precision) if precision else contextlib.nullcontext():
        aligned, boxes = fused_label_program(
            out["relative_depth"], out["metric_depth"], out["depth_mask"], out["K_pixels"],
            packed, max_instances=cfg["max_instances"], num_points=cfg["num_points"],
            method=cfg["bbox_method"], generator=gen)
    aligned = aligned.cpu().numpy()
    boxes = {k: v.cpu().numpy() for k, v in boxes._asdict().items()}
    k_bucket = out["K_pixels"].cpu().numpy().astype(np.float32)
    bh, bw = cfg["bucket"]
    scenes = []
    for row, im in enumerate(imgs):
        oh, ow = im["height"], im["width"]
        K = k_bucket[row].copy()
        K[0] *= ow / bw
        K[1] *= oh / bh
        scenes.append({
            "depth": resize_nearest(aligned[row], oh, ow), "K": K,
            "boxes": {str(i): {"center_cam": boxes["center_cam"][row, i],
                               "dimensions": boxes["dimensions"][row, i],
                               "R_cam": boxes["R_cam"][row, i],
                               "bbox3D_cam": boxes["vertices"][row, i]}
                      for i in range(cfg["max_instances"]) if boxes["ok"][row, i]}})
    return scenes


def _read_scene(path: Path) -> dict:
    boxes = json.loads((path / "3dbbox.json").read_text())
    return {"depth": np.load(path / "depth_map.npy"),
            "K": np.asarray(json.loads((path / "cam_params.json").read_text())["K"]),
            "boxes": {b["obj_id"]: {k: np.asarray(b[k]) for k in
                                    ("center_cam", "dimensions", "R_cam", "bbox3D_cam")}
                      for b in boxes}}


def _scene_gaps(have: list, want: list, anns: list, max_instances: int) -> dict:
    al, kr, bx = [], [], []
    for h, w, a in zip(have, want, anns):
        fin_h, fin_w = np.isfinite(h["depth"]), np.isfinite(w["depth"])
        if (fin_h != fin_w).any():
            al.append(math.inf)
        else:
            d = h["depth"][fin_h].astype(np.float64) - w["depth"][fin_w]
            al.append(float(np.linalg.norm(d) / max(np.linalg.norm(w["depth"][fin_w]), 1e-30)))
        kr.append(float(np.abs(h["K"] - w["K"]).max() / np.abs(w["K"]).max()))
        wanted = {k for k in w["boxes"] if int(k) < min(len(a), max_instances)}
        if set(h["boxes"]) != wanted:
            bx.append(math.inf)
            continue
        for oid in wanted:
            ref = w["boxes"][oid]
            scale = max(1.0, float(np.abs(ref["center_cam"]).max()))
            bx.append(max(float(np.abs(np.asarray(h["boxes"][oid][k]) - ref[k]).max())
                          for k in ref) / scale)
    return {"aligned_rel": max(al), "k_rel": max(kr), "box_gap": max(bx) if bx else 0.0}
