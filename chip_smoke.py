#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

builds the port's CUDA kernels from `labelany3d_tpu_torch/csrc/` with nvcc,
holds each against its plain PyTorch version on the card, checks the fused
labeling program on the card against the CPU, and drives the `fast` route
(MoGe + DepthPro with ViT-L backbones at the `large` preset, random weights
from a seed) over 16 synthetic 512x512 images in two batches of 8. Each
phase prints one line; any failure exits non-zero. Without CUDA, or without
the rest of the repository beside it, it exits non-zero and prints no result.

The line before the last is the kernel table (JSON); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# K1 against its fp32 plain version on the same bf16 inputs. The output is
# rounded to bf16 (relative 2^-9) and so is P before the PV product, which
# puts the relative L2 error near 2e-3 and the largest error near 3e-3 at
# the DepthPro shape. A wrong key tile moves the output by a few percent of
# its scale: dropping the last partial tile, or leaving its pad keys
# unmasked, gives a relative L2 error above 2e-2 at both path shapes.
K1_MAX_ABS_TOL = 5e-3
K1_REL_TOL = 5e-3          # ||out - ref||_2 / ||ref||_2 over the real rows
BOX_TOL = 1e-3             # geometry in f32 with TF32 off, sums reordered
IMAGE_HW = (512, 512)
N_IMAGES = 16


def _say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b: int, n_pad: int, n_real: int, heads: int, d: int):
    """Least time for one packed attention call on an H100 SXM, the larger
    of two. Bytes: Q read and the output written over all Npad rows (the
    function writes pad rows too), K and V read over the n_real real rows,
    bf16. Operations: every query row against the real keys, on the tensor
    cores (4*B*H*Npad*n_real*d)."""
    w = heads * d
    nbytes = 2 * (2 * b * n_pad * w + 2 * b * n_real * w)
    flops = 4 * b * heads * n_pad * n_real * d
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(shape: dict, seed: int, nan_pad: bool = False) -> dict:
    """K1 against its plain version on the card at one path shape."""
    import torch
    import torch.nn.functional as F

    from labelany3d_tpu_torch.ops import attention as att

    b, n_pad, n_real, heads, d = (shape[k] for k in ("b", "n_pad", "n_real", "heads", "d"))
    w = heads * d
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n_pad, 3 * w, device="cuda", generator=g).bfloat16()
    if nan_pad:
        qkv[:, n_real:] = float("nan")
    out = att.packed_sdpa(qkv, heads, n_real)
    ref = att.packed_sdpa_reference(qkv.float(), heads, n_real)  # fp32 from bf16 inputs
    torch.cuda.synchronize()
    diff = (out.float() - ref)[:, :n_real]
    err = diff.abs()
    finite = bool(torch.isfinite(out[:, :n_real]).all())
    res = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "rel_err": float(diff.norm() / ref[:, :n_real].norm()), "finite": finite}
    if not nan_pad:
        q, k, v = (qkv[..., i * w:(i + 1) * w].view(b, n_pad, heads, d).transpose(1, 2)
                   for i in range(3))
        key_mask = (torch.arange(n_pad, device="cuda") < n_real).view(1, 1, 1, n_pad)
        res["ms"] = time_cuda(lambda: att.packed_sdpa(qkv, heads, n_real))
        res["plain_ms"] = time_cuda(lambda: att.packed_sdpa_reference(qkv, heads, n_real),
                                    iters=5)
        res["library_ms"] = time_cuda(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask))
        res["bound_ms"], res["bound_by"] = attention_bound_ms(b, n_pad, n_real, heads, d)
    return res


def synthetic_scene(rng, hw, n_inst):
    """One image with `n_inst` flat-coloured rectangles on a 4x4 grid of
    cells (so every instance passes the COCONUT filters) and their RLE
    annotations."""
    import numpy as np

    from labelany3d_tpu_torch.data.categories import _COCO_THINGS
    from labelany3d_tpu_torch.data.rle import rle_encode

    h, w = hw
    img = np.full((h, w, 3), 127, np.uint8)
    img += rng.integers(0, 20, size=(h, w, 3), dtype=np.uint8)
    cats = sorted(_COCO_THINGS)
    cells = rng.permutation(16)[:n_inst]
    ch, cw = (h - 32) // 4, (w - 32) // 4
    annos = []
    for cell in cells:
        cy, cx = 16 + (cell // 4) * ch, 16 + (cell % 4) * cw
        rh, rw = rng.integers(ch // 2, ch - 4), rng.integers(cw // 2, cw - 4)
        y0, x0 = cy + rng.integers(0, ch - rh), cx + rng.integers(0, cw - rw)
        m = np.zeros((h, w), bool)
        m[y0:y0 + rh, x0:x0 + rw] = True
        img[m] = rng.integers(0, 255, size=3, dtype=np.uint8)
        rle = rle_encode(m)
        annos.append({"category_id": int(rng.choice(cats)), "iscrowd": 0,
                      "bbox": [float(x0), float(y0), float(rw), float(rh)],
                      "segmentation": {"size": rle["size"], "counts": rle["counts"].decode()}})
    return img, annos


class SyntheticLoader:
    """CoconutLoader-compatible loader over in-memory scenes."""

    def __init__(self, n: int, hw, seed: int = 0, min_inst: int = 2, max_inst: int = 16):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.images, self.annos, self.pixels = [], {}, {}
        for i in range(n):
            img, annos = synthetic_scene(rng, hw, int(rng.integers(min_inst, max_inst + 1)))
            iid = i + 1
            self.images.append({"id": iid, "file_name": f"{iid:012d}.jpg",
                                "height": hw[0], "width": hw[1]})
            self.annos[iid] = [dict(a, image_id=iid) for a in annos]
            self.pixels[iid] = img

    def get_image_by_index(self, i):
        return self.images[i]

    def get_annotations(self, image_id):
        return self.annos.get(image_id, [])

    def __len__(self):
        return len(self.images)


def check_labeling(device: str, b: int = 8, hw=IMAGE_HW, n_inst: int = 16,
                   n_pts: int = 512) -> dict:
    """The fused labeling program on `device` against the CPU, same draws."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.geometry.align import draw_ransac
    from labelany3d_tpu_torch.geometry.backproject import draw_instance_ranks
    from labelany3d_tpu_torch.pipeline.labeling import LabelingDraws, fused_label_program
    from labelany3d_tpu_torch.pipeline.stages.common import pack_instance_masks

    loader = SyntheticLoader(b, hw, seed=1, min_inst=n_inst, max_inst=n_inst)
    from labelany3d_tpu_torch.data.sources import CoconutInstanceProvider

    prov = CoconutInstanceProvider(loader)
    masks = np.stack([prov.instances(info).masks for info in loader.images])
    rng = np.random.default_rng(2)
    rel = rng.uniform(0.5, 3.0, size=(b, *hw)).astype(np.float32)
    met = (1.7 * rel + 0.05 * rng.standard_normal(rel.shape)).astype(np.float32)
    dmask = rng.uniform(size=rel.shape) > 0.1
    K = np.broadcast_to(np.array([[400.0, 0, hw[1] / 2], [0, 400.0, hw[0] / 2], [0, 0, 1]],
                                 np.float32), (b, 3, 3)).copy()
    packed = np.stack([pack_instance_masks(m) for m in masks])
    gen = torch.Generator().manual_seed(3)
    counts = torch.from_numpy((masks & dmask[:, None]).sum(axis=(-2, -1)))
    draws = LabelingDraws(draw_ransac(b, hw[0] * hw[1], generator=gen),
                          draw_instance_ranks(counts, n_pts, gen))

    def run(dev):
        ins = [torch.from_numpy(a).to(dev) for a in (rel, met, dmask, K, packed)]
        d = LabelingDraws(type(draws.ransac)(*(t.to(dev) for t in draws.ransac)),
                          draws.samples.to(dev))
        aligned, boxes = fused_label_program(*ins, max_instances=n_inst, num_points=n_pts,
                                             method="pca", draws=d)
        return aligned.cpu(), boxes._replace(**{k: v.cpu() for k, v in boxes._asdict().items()})

    t0 = time.perf_counter()
    a_dev, b_dev = run(device)
    dt = time.perf_counter() - t0
    a_cpu, b_cpu = run("cpu")
    ok = b_cpu.ok
    box_err = max(float((getattr(b_dev, f) - getattr(b_cpu, f))[ok].abs().max())
                  for f in ("center_cam", "dimensions", "R_cam"))
    depth_rel = float(((a_dev - a_cpu).abs() / a_cpu.abs().clamp_min(1e-6)).max())
    return {"box_err": box_err, "depth_rel_err": depth_rel, "boxes": int(ok.sum()),
            "ok_equal": bool(torch.equal(b_dev.ok, ok)), "s": dt}


def check_scene_outputs(save_dir: str, loader) -> tuple[set, set]:
    """Every scene has its artifacts with finite values of the right shape.
    Returns the scenes that have boxes and the scenes COCO3D lists, which
    must be the same: export skips exactly the scenes without boxes."""
    import numpy as np

    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name

    with_boxes = set()
    for info in loader.images:
        name = scene_dir_name(info["file_name"])
        sd = SceneDir(os.path.join(save_dir, "val", name))
        for p in (sd.depth_map, sd.cam_params, sd.bbox3d):
            if not p.exists():
                raise RuntimeError(f"missing {p}")
        depth = sd.read_depth()
        if depth.shape != (info["height"], info["width"]) or not np.isfinite(depth).all():
            raise RuntimeError(f"bad depth map in {sd.root}")
        boxes = sd.read_bbox3d()
        if any(not np.isfinite(b["bbox3D_cam"]).all() or np.shape(b["bbox3D_cam"]) != (8, 3)
               for b in boxes):
            raise RuntimeError(f"bad boxes in {sd.root}")
        if boxes:
            with_boxes.add(name)
    with open(os.path.join(save_dir, "COCO3D_val.json")) as f:
        listed = {os.path.basename(im["file_path"]).rsplit(".", 1)[0]
                  for im in json.load(f)["images"]}
    return with_boxes, listed


def profile_fast(run) -> dict:
    """One `fast` pass under torch.profiler: the summed time of the device's
    own events (kernels, copies), the ones that take most of it, and the
    host ops with the most self CPU time. Host ops that launch kernels also
    carry device time in `key_averages`; only device events are summed, so
    nothing is counted twice."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.self_device_time_total / 1e3, e.key, e.count))
        else:
            host.append((e.self_cpu_time_total / 1e3, e.key, e.count))
    dev.sort(reverse=True)
    host.sort(reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": sum(r[0] for r in dev),
            "k1_ms": sum(r[0] for r in dev if "packed_attention" in r[1]),
            "top_device": [(round(ms, 3), name[:60], n) for ms, name, n in dev[:10]],
            "top_host": [(round(ms, 3), name[:60], n) for ms, name, n in host[:8]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to do", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from labelany3d_tpu_torch.ops import attention as att
        from labelany3d_tpu_torch.ops import build
        from labelany3d_tpu_torch.pipeline.backends import default_registry
        from labelany3d_tpu_torch.pipeline.config import PipelineConfig
        from labelany3d_tpu_torch.pipeline.runner import run_stages
        from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
        from labelany3d_tpu_torch.utils.profiling import StageTimer
    except ImportError as e:
        print(f"chip_smoke: the labelany3d_tpu_torch package is missing: {e}", file=sys.stderr)
        return 1

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip().splitlines()
    _say("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi[0] if smi else "nvidia-smi: unavailable", flush=True)

    # 2. Kernel build: one nvcc per source, all started together.
    t0 = time.perf_counter()
    log = build.build("packed_attention", verbose=True)
    ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln)
    _say("build", s=time.perf_counter() - t0, ptxas=json.dumps(ptxas))

    # 3. K1 against its plain version at both path shapes, and with NaN pads.
    shapes = {"moge": dict(b=8, n_pad=1408, n_real=1297, heads=16, d=64),
              "depth_pro": dict(b=40, n_pad=384, n_real=325, heads=16, d=64)}
    k1 = {}
    for i, (name, shape) in enumerate(shapes.items()):
        k1[name] = check_attention(shape, seed=i)
        _say(f"K1:{name}", **k1[name], max_abs_tol=K1_MAX_ABS_TOL, rel_tol=K1_REL_TOL)
    nan = check_attention(shapes["moge"], seed=7, nan_pad=True)
    _say("K1:nan_pad", **nan, max_abs_tol=K1_MAX_ABS_TOL, rel_tol=K1_REL_TOL)
    failures = [n for n, r in {**k1, "nan_pad": nan}.items()
                if not r["finite"] or r["max_abs_err"] > K1_MAX_ABS_TOL
                or r["rel_err"] > K1_REL_TOL]
    if failures:
        raise SystemExit(f"K1 disagrees with its plain version: {failures}")

    # 4. Fused labeling program on the card against the CPU.
    lab = check_labeling("cuda")
    _say("labeling", **lab, tol=BOX_TOL)
    if not lab["ok_equal"] or lab["box_err"] > BOX_TOL or lab["depth_rel_err"] > 1e-4:
        raise SystemExit("fused labeling on the card disagrees with the CPU")

    # 5. The fast route at the large preset: 16 images, two batches of 8.
    cfg = PipelineConfig()
    loader = SyntheticLoader(N_IMAGES, IMAGE_HW, seed=0)
    source = ArrayImageSource(loader.pixels)
    t0 = time.perf_counter()
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    with tempfile.TemporaryDirectory() as tmp:
        att.KERNEL_LAUNCHES.reset()
        att.PLAIN_CALLS.reset()
        torch.cuda.reset_peak_memory_stats()
        cold = os.path.join(tmp, "cold")
        run_stages("fast", cfg, loader, source, cold, "val", 0, N_IMAGES,
                   backend=backend, device="cuda")
        torch.cuda.synchronize()
        launches, plain = att.KERNEL_LAUNCHES.count, att.PLAIN_CALLS.count
        cold_s = time.perf_counter() - t0
        with_boxes, listed = check_scene_outputs(cold, loader)
        _say("fast:cold", s=cold_s, k1_launches=launches, plain_calls=plain,
             scenes_with_boxes=len(with_boxes), coco3d_images=len(listed))
        # With random weights, whether a scene keeps any valid depth (and so
        # any box) depends on the seed; what must hold is that every scene
        # with boxes, and only those, reaches COCO3D, and that some do.
        want = 2 * (backend.moge_cfg.backbone.depth + backend.dp_cfg.backbone.depth)
        if launches != want or plain != 0 or not with_boxes or listed != with_boxes:
            raise SystemExit(f"fast route: K1 launches {launches} (want {want}), plain "
                             f"calls {plain} (want 0), scenes with boxes "
                             f"{sorted(with_boxes)}, COCO3D lists {sorted(listed)}")

        timer = StageTimer()
        t0 = time.perf_counter()
        run_stages("fast", cfg, loader, source, os.path.join(tmp, "warm"), "val", 0,
                   N_IMAGES, backend=backend, device="cuda", timer=timer)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        stage_s = {f"{k}_s": timer.stats[k].total_seconds
                   for k in ("fused", "crops", "export")}
        _say("fast:warm", s=warm_s, images_per_s=N_IMAGES / warm_s,
             **stage_s, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

        prof = profile_fast(lambda: run_stages(
            "fast", cfg, loader, source, os.path.join(tmp, "prof"), "val", 0, N_IMAGES,
            backend=backend, device="cuda"))
        # The profiler slows the host several-fold but not the device, so
        # the idle share sets the traced pass's device time against the
        # untraced warm pass's wall time. No device time: not measured.
        idle = (1.0 - prof["device_ms"] / (warm_s * 1e3) if prof["device_ms"] > 0
                else "not measured")
        _say("fast:profile", traced_wall_ms=prof["wall_ms"],
             device_ms=prof["device_ms"], k1_device_ms=prof["k1_ms"],
             idle_share_of_warm_pass=idle, top_device=json.dumps(prof["top_device"]),
             top_host=json.dumps(prof["top_host"]))

    m = k1["moge"]
    table = {"kernels": [{
        "name": "packed_attention", "route": "cuda",
        "source": "labelany3d_tpu_torch/csrc/packed_attention.cu",
        "replaces": "labelany3d_tpu/ops/attention.py:133",
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "shape": "MoGe B=8 Npad=1408 n_real=1297 H=16 d=64",
        "depth_pro": {k: k1["depth_pro"][k] for k in
                      ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }]}
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
