#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

builds the port's four CUDA kernels from `labelany3d_tpu_torch/csrc/` with
nvcc (one process per source, all at once), checks that the two attention
kernels and the reciprocal-NN argmax compiled to wgmma (HGMMA) and TMA loads
(UTMALDG), holds each kernel
against its plain PyTorch version on the card, checks the fused labeling
program on the card against the CPU, and drives two paths with random
weights from a seed:

  * the `fast` route (MoGe + DepthPro with ViT-L backbones at the `large`
    preset) over 16 synthetic 512x512 images in two batches of 8;
  * the registration chain depth -> crops -> reconstruction -> layout ->
    export over 8 synthetic 512x512 images with 4 objects each, at the
    `large` depth preset, the full-width `MatcherConfig()` matcher (ViT-L
    encoder, 12-block decoder of width 768) and `bbox_method=minarea_pallas`;
  * the same chain at the checkpoint-faithful models: the `vitl_reference`
    depth preset (MoGe ViT-L with the released head; the 35-patch DepthPro
    at 1536 px with its image and FoV encoders) and
    `MatcherConfig.mast3r_vitl()` (CroCo ViT-L/16 rope encoder, whose
    attention runs K2, and the CatMLP+DPT head), with weights made as
    released torch state dicts from a seed and loaded through the port's
    converters (`models/convert.py`) and `flax_to_state_dict`;
  * the `boxes` route: depth with the scene PLYs -> boxes (K4 box fit) ->
    export over the `fast` route's 16 images at the `large` preset;
  * the `all` route (depth -> enhance -> crops -> completion -> elevation ->
    reconstruction -> layout -> export) over the registration chain's 8
    images, at the shipping defaults: 4x bicubic enhance, crops cut from the
    2048x2048 enhanced images, passthrough completion, 0-degree elevation;
  * TRELLIS, stage 6's `obj_rec=trellis` backend: `TrellisPipeline.run` at
    `TrellisPipelineConfig()`'s full widths on one object, timed by
    component through the run's own spans, with weights
    made as released torch state dicts from a seed and loaded through
    `models/convert_trellis.py` (DINOv2 ViT-L/14 with registers -> K1; the
    SS and SLat flow DiTs, 25 steps each with CFG as a batch of 2 -> K2;
    decoders, surface extraction and the texture bake) and a reduced
    TRELLIS with head dim 64 on the card against the CPU;
  * the SD-class stack, stages 2, 4 and 5 at `run.enhance=invsr`,
    `run.amodal_completion=our` and `run.elevation=zero123`: the components
    at the SD-1.5 widths (CLIP ViT-L/14 text and vision towers, three
    UNets, the VAE, ISNet at 1024^2, the elevation estimator whose tiny
    matcher runs K1 and K2 at head dim 32) with weights made as released
    torch state dicts from a seed and loaded through the port's
    converters, the `all` route at the reference's configuration (those
    three and `run.obj_rec=trellis`) over 2 images with 2 objects each, and
    the tiny configs on the card against the CPU;
  * Hunyuan3D, stage 6's `obj_rec=hunyuan3d` and `hunyuan3d_carve`: the
    components at the released widths (the SDXL-class mvd_std grid
    diffusion with its CLIP ViT-L/14 and ViT-bigG/14 towers and VAE, 50
    Euler-ancestral steps at 1536x1024; SVRM's camera-modulated DINOv2
    ViT-B/14 and 16 LRM blocks -> K2, the triplane field on a 96^3 lattice,
    the mesh; the visual-hull carver over Zero123 views) with weights made
    as released torch state dicts from a seed and loaded through the
    converters, the `all` route with `obj_rec=hunyuan3d` over 1 image with
    2 objects, and SVRM (reduced, heads of 64) and the tiny mvd_std
    pipeline on the card against the CPU;
  * wild mode (`--wild`): SAM ViT-B at 1024^2 (point-grid segmentation at 8
    and 16 points a side) and SegFormer-B0 at 512^2 with weights made as
    released `transformers` state dicts from a seed and loaded through
    `convert_sam` and `convert_segformer`, the background SDF fit and mesh;
    the `fast` route at the `large` preset over the 16 images with the wild
    provider (SAM relaxed as the JAX package's tests relax it, the
    SegFormer filter, the constant tagger), whose depth pass runs K1; the
    `--wild` CLI over 4 PNGs at the shipping thresholds; and SAM (depth 2),
    SegFormer-B0 and the fit on the card against the CPU, with a fault
    planted on the card;
  * the released-weight workflow: TRELLIS's six components at full width
    (1.71 G parameters) written as the release's float16 safetensors,
    converted by `python -m labelany3d_tpu_torch.models.convert_cli` into
    the store and read back bit for bit; the `all` route with
    `obj_rec=trellis` reading the store through `ckpt_dir` over 1 image with
    2 objects (K1, K2, K3 and K4 launches, the runner freeing what it built
    between stages); `compare_coco3d` on the card over a seeded COCO3D pair
    of 5,000 images x 8 boxes, the first pairs against the CPU;
  * DINOv2-giant, the SwiGLU ViT a TRELLIS pipeline.json may name as its
    conditioner (width 1536, 40 blocks, 24 heads of 64 -> K1, 1.14 G
    parameters): drawn in the torch-hub layout from a seed, written as
    float16 safetensors, converted by the CLI's `trellis_cond` entry with a
    pipeline.json naming it, read back bit for bit, and run at 518 px from
    the store; at depth 2 on the card against the CPU, with a fault planted;
    the trajectory video of a scene of the route from the store; and the
    host code no route calls: the auction against scipy's Hungarian solver,
    Kabsch and Umeyama, the native RLE codec against the numpy one, and a
    `fast` batch under `trace`;
  * the fine-tuning step (`parallel/train.py`): K1 and its autograd (the
    kernel forward, the plain fp32 backward) at MoGe ViT-L's train shape
    against the plain version; `MoGeModel(MoGeConfig.vitl())` trained at
    518 px on a batch of 8 (a cold and 5 warm steps, then 2 through a
    one-rank mesh under NCCL against the steps without one); its
    gradients at depth 2 on the card against the CPU, with the attention
    output cut from the graph as a planted fault; `parallel.dryrun`'s
    `entry()` and `dryrun_multichip(1)`.

Each phase prints one line; any failure exits non-zero. Without CUDA, or
without the rest of the repository beside it, it exits non-zero and prints
no result.

The line before the last is the kernel table (JSON); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

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
# K2 against its fp32 plain version on the same bf16 inputs: the same
# reasoning and tolerances as K1.
K2_MAX_ABS_TOL = 5e-3
K2_REL_TOL = 5e-3
# K3 against its plain version on the same bf16-rounded operands: both sum
# 24 products of unit-norm descriptors in fp32, in another order, so the
# best scores agree to a few ulp of 1; indices must agree wherever the
# plain version's best beats its runner-up by more than the score tolerance.
K3_SCORE_TOL = 1e-5
# K3's library yardstick materialises the bf16 score matrix: timed only
# where it fits beside everything else (the compact round's is 17.2 GB).
LIBRARY_SCORE_BYTES = 24e9
# K4: the same fp32 arithmetic per angle; the yaw must agree wherever the
# best area beats the runner-up by more than this relative margin.
K4_REL_TOL = 1e-6
H100_F32_FLOPS = 67e12     # fp32 outside the tensor cores, H100 SXM data sheet
BOX_TOL = 1e-3             # geometry in f32 with TF32 off, sums reordered
IMAGE_HW = (512, 512)
N_IMAGES = 16
N_REG_IMAGES = 8           # registration chain: one depth batch of 8
REG_INSTANCES = 4
STAGE_A_PAIRS = REG_INSTANCES * 8  # a stage-A matcher forward: 4 objects x 8 orbit views
# Stage 5's elevation matcher (the tiny MatcherConfig): 256^2 Zero123 views,
# 8-wide descriptors, start points every 8 px.
ELEVATION_VIEW = 256
ELEVATION_DESC = 8
ELEVATION_STARTS = (ELEVATION_VIEW // 8) ** 2
CHAIN = ("depth", "crops", "reconstruction", "layout", "export")
ALL_STAGES = ("depth", "enhance", "crops", "completion", "elevation", "reconstruction",
              "layout", "export")
ENHANCE_FACTOR = 4
CROP_SIZE = 512            # CropStage's default, as the runners cut crops
MESH_FACE_TOL = 1e-3       # the card's scene-mesh face count against the CPU's, relative


_T0 = time.perf_counter()


def _say(phase: str, **kw) -> None:
    """One line per phase, with the seconds since the script started."""
    print(f"[{phase}] at_s={time.perf_counter() - _T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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


def time_cuda_graph(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around the replay of
    one CUDA graph of `iters` calls. For calls whose device work is shorter
    than the host's time to launch them, where `time_cuda` would time the
    host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def check_attention(shape: dict, seed: int, nan_pad: bool = False,
                    graph: bool = False) -> dict:
    """K1 against its plain version on the card at one path shape. With
    `graph`, also the kernel's and SDPA's device times from CUDA-graph
    replays (`graph_ms`, `library_graph_ms`): at a size whose device work is
    shorter than the host's launch (the elevation matcher's), the eager
    `ms` times the host."""
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
        res.update(against_yardsticks(res))
        if graph:
            res["graph_ms"] = time_cuda_graph(lambda: att.packed_sdpa(qkv, heads, n_real))
            res["library_graph_ms"] = time_cuda_graph(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask))
    return res


def against_yardsticks(res: dict) -> dict:
    """A timed kernel's time over its library call's, and its bound's share
    of its time (1.0 would be the card's best)."""
    return {"ratio_to_library": res["ms"] / res["library_ms"],
            "share_of_bound": res["bound_ms"] / res["ms"]}


def bound(nbytes: float, flops: float, peak_flops: float = H100_BF16_FLOPS):
    """Least time (ms) on an H100 SXM and what sets it."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_flash(b: int, sq: int, sk: int, seed: int, heads: int = 12, d: int = 64,
                pad_keys: int = 0, strided: bool = False, fused: bool = False,
                timed: bool = False, graph: bool = False) -> dict:
    """K2 against its plain version on the card. `pad_keys` > 0 masks the
    last keys through segment ids (self-attention) and fills every pad row
    of q, k and v with NaN; `strided` reads q from a (B, H, S, D) tensor
    through its transposed view; `fused` (self-attention) reads q, k and v
    as column views of one (B, S, 3 * H * D) tensor, as SVRM's encoder
    splits its fused projection; `graph` as in `check_attention`."""
    import torch
    import torch.nn.functional as F

    from labelany3d_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(s):
        return torch.randn(b, s, heads, d, device="cuda", generator=g).bfloat16()

    q = rand(sq)
    if strided:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    k, v = rand(sk), rand(sk)
    if fused:
        w = heads * d
        qkv = torch.randn(b, sq, 3 * w, device="cuda", generator=g).bfloat16()
        q, k, v = (qkv[..., i * w:(i + 1) * w].unflatten(-1, (heads, d)) for i in range(3))
    seg, real = None, slice(None)
    if pad_keys:
        seg = torch.zeros(b, sk, dtype=torch.int32, device="cuda")
        seg[:, sk - pad_keys:] = 1
        for t in (q, k, v):
            t[:, sk - pad_keys:] = float("nan")
        real = slice(0, sk - pad_keys)
    out = att.flash_sdpa(q, k, v, seg)
    ref = att.flash_sdpa_reference(q.float(), k.float(), v.float(), seg)
    torch.cuda.synchronize()
    diff = (out.float() - ref)[:, real]
    res = {"max_abs_err": float(diff.abs().max()),
           "rel_err": float(diff.norm() / ref[:, real].norm()),
           "finite": bool(torch.isfinite(out[:, real]).all())}
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if seg is None else (seg == 0)[:, None, None, :]
        res["ms"] = time_cuda(lambda: att.flash_sdpa(q, k, v, seg))
        res["plain_ms"] = time_cuda(lambda: att.flash_sdpa_reference(q, k, v, seg), iters=5)
        res["library_ms"] = time_cuda(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        # q read and the output written once, k and v over the real keys
        # (bf16); QK^T and PV against the real keys.
        sk_real = sk - pad_keys
        res["bound_ms"], res["bound_by"] = bound(2 * b * heads * d * (2 * sq + 2 * sk_real),
                                                 4 * b * heads * sq * sk_real * d)
        res.update(against_yardsticks(res))
        if graph:
            res["graph_ms"] = time_cuda_graph(lambda: att.flash_sdpa(q, k, v, seg))
            res["library_graph_ms"] = time_cuda_graph(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    return res


def check_nn(pairs: int, s: int, n: int, seed: int, precision: str,
             n_real: int | None = None, timed: bool = False, c: int = 24,
             negative: bool = False, graph: bool = False) -> dict:
    """K3 against its plain version on the same bf16-rounded operands:
    unit-norm descriptors, queries (pairs, s, c) against banks (pairs, n, c).
    With `n_real`, the bank rows at and beyond it hold garbage (NaN and
    1e30). With `negative`, every real score is negative (bank rows in the
    positive orthant, queries the negatives of bank rows), so a zero-filled
    pad row that the kernel failed to mask would win. The kernel reads the
    bank prepared once (`prepare_bank_for_nn`), as the matcher's rounds do;
    the plain version reads the float32 bank. `library_ms`
    (`torch.bmm(q, bank^T).max(-1)` in bf16) is timed where its score
    matrix fits the card (one pair, the compact round). `graph` as in
    `check_attention`."""
    import torch
    import torch.nn.functional as F

    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    g = torch.Generator(device="cuda").manual_seed(seed)
    bank = F.normalize(torch.randn(pairs, n, c, device="cuda", generator=g), dim=-1)
    nr = n if n_real is None else n_real
    if negative:
        bank = bank.abs()
        rows = torch.randperm(nr, device="cuda", generator=g)[:s]
        q = -bank[:, rows]
    else:
        q = F.normalize(torch.randn(pairs, s, c, device="cuda", generator=g), dim=-1)
    bank_p, _ = rnn.pad_bank_for_nn(bank)
    if n_real is not None:
        bank_p[:, nr::2] = float("nan")
        bank_p[:, nr + 1::2] = 1e30
    prep, _ = rnn.prepare_bank_for_nn(bank_p, precision)
    idx, best = rnn.nn_argmax(q, prep, n_real=nr, precision=precision)
    ref_idx, ref_best = rnn.nn_argmax_reference(q, bank_p, n_real=nr, precision=precision)
    torch.cuda.synchronize()

    def score_at(i):
        """The score of bank rows `i` (P, S) in fp64 sums of the rounded
        operands the plain version uses."""
        rows = bank.gather(1, i.long()[..., None].expand(-1, -1, c)).double()
        qd = q.double()
        if precision == "bf16":
            return (qd.bfloat16().double() * rows.bfloat16().double()).sum(-1)
        qh, bh = qd.float().bfloat16().double(), rows.float().bfloat16().double()
        ql = (qd.float() - qh.float()).bfloat16().double()
        bl = (rows.float() - bh.float()).bfloat16().double()
        return (qh * bh + qh * bl + ql * bh).sum(-1)

    differ = idx != ref_idx
    # Where the indices differ, the kernel's row must score within the
    # tolerance of the plain best: the top two were that close.
    gap = (ref_best.double() - score_at(idx))[differ]
    res = {"max_abs_err": float((best - ref_best).abs().max()),
           "idx_differ": int(differ.sum()),
           "max_gap_where_differ": float(gap.abs().max()) if differ.any() else 0.0,
           "in_range": bool(((idx >= 0) & (idx < nr)).all())}
    if negative:
        res["max_best"] = float(best.max())
    res["ok"] = (res["in_range"] and res["max_abs_err"] <= K3_SCORE_TOL
                 and res["max_gap_where_differ"] <= K3_SCORE_TOL
                 and (not negative or res["max_best"] < 0))
    if timed:
        res["ms"] = time_cuda(lambda: rnn.nn_argmax(q, prep, n_real=nr, precision=precision))
        res["plain_ms"] = time_cuda(lambda: rnn.nn_argmax_reference(
            q, bank_p, n_real=nr, precision=precision), iters=3, warmup=1)
        res["library_ms"] = None
        if pairs * s * n * 2 <= LIBRARY_SCORE_BYTES:
            qb, bt = q.bfloat16(), bank.bfloat16().transpose(1, 2)
            res["library_ms"] = time_cuda(lambda: torch.bmm(qb, bt).max(-1), iters=5)
            if graph:
                res["library_graph_ms"] = time_cuda_graph(lambda: torch.bmm(qb, bt).max(-1))
        if graph:
            res["graph_ms"] = time_cuda_graph(
                lambda: rnn.nn_argmax(q, prep, n_real=nr, precision=precision))
        # Queries and banks read once (fp32, c wide), indices and scores
        # written; 2*s*n*c operations per pair and operand pass (three
        # passes for bf16x3).
        passes = 1 if precision == "bf16" else 3
        res["bound_ms"], res["bound_by"] = bound(pairs * (4 * c * (s + nr) + 8 * s),
                                                 pairs * passes * 2 * s * nr * c)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        if res["library_ms"]:
            res["ratio_to_library"] = res["ms"] / res["library_ms"]
    return res


def check_yaw(i: int, n: int, seed: int, timed: bool = False, num_angles: int = 512) -> dict:
    """K4 against its plain version: random point sets and masks."""
    import math

    import torch

    from labelany3d_tpu_torch.ops import boxfit_yaw as by

    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.randn(i, n, 2, device="cuda", generator=g) * torch.tensor(
        [2.0, 0.5], device="cuda")
    pts = pts @ torch.linalg.qr(torch.randn(i, 2, 2, device="cuda", generator=g))[0]
    valid = torch.rand(i, n, device="cuda", generator=g) > 0.3
    valid[0] = False  # an instance without points
    yaw = by.yaw_minarea(pts, valid, num_angles)
    ref = by.yaw_minarea_reference(pts, valid, num_angles)
    area = by.footprint_areas(pts, valid, num_angles)
    torch.cuda.synchronize()
    step = (math.pi / 2.0) / num_angles
    k_idx = torch.round(yaw / step).long()
    top2 = area.topk(2, dim=-1, largest=False).values
    # An instance without valid points has infinite area at every angle;
    # both versions then return the first angle.
    finite = torch.isfinite(top2[:, 0])
    clear = ~finite | ((top2[:, 1] - top2[:, 0]) > K4_REL_TOL * top2[:, 0].abs())
    at_k = area.gather(1, k_idx[:, None])[:, 0]
    rel = torch.where(finite, (at_k - top2[:, 0]) / top2[:, 0].abs().clamp_min(1e-30),
                      torch.zeros_like(at_k))
    res = {"yaw_equal_where_clear": bool((yaw == ref)[clear].all()),
           "clear_rows": int(clear.sum()),
           "max_rel_area_excess": float(rel[~clear].max()) if (~clear).any() else 0.0,
           "max_abs_err": float((yaw - ref).abs().max())}
    res["ok"] = res["yaw_equal_where_clear"] and res["max_rel_area_excess"] <= K4_REL_TOL
    if timed:
        # Device time from graph replays: a call's host work (tens of
        # microseconds) is longer than its kernel, so event timing of eager
        # calls would time the host.
        vm = valid.to(torch.uint8)
        res["ms"] = time_cuda_graph(lambda: by.yaw_minarea(pts, vm, num_angles))
        res["plain_ms"] = time_cuda_graph(lambda: by.yaw_minarea_reference(pts, vm, num_angles))
        res["eager_ms"] = time_cuda(lambda: by.yaw_minarea(pts, valid, num_angles))
        res["library_ms"] = None
        # Points (fp32 pairs) and the mask (uint8) read once, yaws written;
        # per point and angle 4 multiplies, 2 adds and 4 min/max in fp32.
        res["bound_ms"], res["bound_by"] = bound(9 * i * n + 4 * i, 10 * i * n * num_angles,
                                                 H100_F32_FLOPS)
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


class SyntheticState(dict):
    """A torch-named state dict of numpy float32 arrays, as a released
    checkpoint holds after `load_torch_checkpoint`: norm scales 1, biases 0,
    every other weight N(0, std^2) from a torch generator seeded on `device`
    (the card's draws billions of parameters in seconds), each tensor copied
    to the host once."""

    def __init__(self, seed: int, std: float = 0.02, device: str | None = None):
        import numpy as np
        import torch

        super().__init__()
        self.np = np
        self.std = float(std)
        self.device = device or "cpu"
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def rand(self, name: str, *shape) -> None:
        import torch

        self[name] = (torch.randn(shape, generator=self.gen, device=self.device)
                      .mul_(self.std).cpu().numpy())

    def const(self, name: str, value: float, *shape) -> None:
        self[name] = self.np.full(shape, value, self.np.float32)

    def norm(self, pre: str, c: int) -> None:
        self.const(pre + "weight", 1.0, c)
        self.const(pre + "bias", 0.0, c)

    def linear(self, pre: str, n_in: int, n_out: int) -> None:
        self.rand(pre + "weight", n_out, n_in)
        self.const(pre + "bias", 0.0, n_out)

    def conv(self, pre: str, n_in: int, n_out: int, k: int, bias: bool = True) -> None:
        self.rand(pre + "weight", n_out, n_in, k, k)
        if bias:
            self.const(pre + "bias", 0.0, n_out)

    def deconv(self, pre: str, n_in: int, n_out: int, k: int, bias: bool = True) -> None:
        self.rand(pre + "weight", n_in, n_out, k, k)  # ConvTranspose2d: (in, out, k, k)
        if bias:
            self.const(pre + "bias", 0.0, n_out)

    def vit(self, pre: str, cfg, n_pos: int = 0, blocks: str = "blocks.",
            final_norm: str = "norm.") -> None:
        """A DINOv2 (timm) ViT, or with `n_pos` 0 and croco's names a CroCo
        encoder without position embeddings."""
        c, p = cfg.width, cfg.patch_size
        hid = int(c * cfg.mlp_ratio)
        self.conv(pre + "patch_embed.proj.", 3, c, p)
        if n_pos:
            self.rand(pre + "pos_embed", 1, int(cfg.use_class_token) + n_pos, c)
        if cfg.use_class_token:
            self.rand(pre + "cls_token", 1, 1, c)
        if cfg.num_register_tokens:
            self.rand(pre + "register_tokens", 1, cfg.num_register_tokens, c)
        for i in range(cfg.depth):
            b = f"{pre}{blocks}{i}."
            self.norm(b + "norm1.", c)
            self.norm(b + "norm2.", c)
            self.linear(b + "attn.qkv.", c, 3 * c)
            self.linear(b + "attn.proj.", c, c)
            if cfg.swiglu:  # DINOv2-giant's SwiGLU (timm's SwiGLUFFNFused names)
                from labelany3d_tpu_torch.models.vit import swiglu_hidden

                self.linear(b + "mlp.w12.", c, 2 * swiglu_hidden(cfg))
                self.linear(b + "mlp.w3.", swiglu_hidden(cfg), c)
            else:
                self.linear(b + "mlp.fc1.", c, hid)
                self.linear(b + "mlp.fc2.", hid, c)
            if cfg.layerscale_init is not None:
                self.rand(b + "ls1.gamma", c)
                self.rand(b + "ls2.gamma", c)
        self.norm(pre + final_norm, c)


def peak_timer():
    """A `StageTimer` that also records each stage's peak device memory in
    GB (`peaks_gb`): the peak statistics are reset as a stage starts and read
    as it ends, so a route's peak is the largest of them."""
    import contextlib

    import torch

    from labelany3d_tpu_torch.utils.profiling import StageTimer

    class PeakTimer(StageTimer):
        def __init__(self):
            super().__init__()
            self.peaks_gb = {}

        @contextlib.contextmanager
        def measure(self, stage: str, items: int = 0):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with StageTimer.measure(self, stage, items):
                yield
            torch.cuda.synchronize()
            self.peaks_gb[stage] = torch.cuda.max_memory_allocated() / 1e9

    return PeakTimer()


class StageKeep(dict):
    """A `stages` dict for `run_stages` that keeps, of each finished stage,
    what `keep(name, stage)` returns instead of the stage object. A stage
    holds its backend, so a dict of stage objects would keep every model the
    runner built (and frees between stages) to the end of the route. A stage
    has finished when the runner inserts the next one; `close()` takes the
    last."""

    def __init__(self, keep):
        super().__init__()
        self._keep, self._open = keep, None

    def __setitem__(self, name, stage):
        self.close()
        super().__setitem__(name, stage)
        self._open = name

    def close(self) -> None:
        if self._open is not None:
            name, self._open = self._open, None
            super().__setitem__(name, self._keep(name, self[name]))


def released_moge_state(cfg, seed: int = 0, std: float = 0.02, device: str | None = None) -> dict:
    """A MoGe release's names and shapes (`backbone.*`, `head.*`) for a
    `MoGeConfig` with the reference head, pos-embed on `cfg.backbone.pos_grid`."""
    st = SyntheticState(seed, std, device)
    bb = cfg.backbone
    gh, gw = bb.pos_grid
    st.vit("backbone.", bb, n_pos=gh * gw)

    def res_block(pre, c):
        st.norm(pre + "layers.0.", c)
        st.conv(pre + "layers.2.", c, c, 3)
        st.norm(pre + "layers.3.", c)
        st.conv(pre + "layers.5.", c, c, 3)

    for i in range(len(bb.out_indices)):
        st.conv(f"head.projects.{i}.", bb.width, cfg.dim_proj, 1)
    ch = cfg.dim_proj
    for i, out in enumerate(cfg.dim_upsample):
        pre = f"head.upsample_blocks.{i}."
        st.deconv(pre + "0.0.", ch + 2, out, 2)
        st.conv(pre + "0.1.", out, out, 3)
        for r in range(cfg.num_res_blocks):
            res_block(pre + f"{1 + r}.", out)
        ch = out
    dims = [3, 1] if cfg.output_mask and cfg.split_head else [4 if cfg.output_mask else 3]
    cc = cfg.last_conv_channels
    for j, d in enumerate(dims):
        pre = f"head.output_block.{j}." if len(dims) > 1 else "head.output_block."
        st.conv(pre + "0.", ch + 2, cc, 3)
        for r in range(cfg.last_res_blocks):
            res_block(pre + f"{1 + r}.", cc)
        st.conv(pre + f"{cfg.last_res_blocks + 2}.", cc, d, cfg.last_conv_size)
    return st


def released_depth_pro_state(cfg, seed: int = 1, std: float = 0.02,
                             device: str | None = None) -> dict:
    """The DepthPro release's names and shapes (`depth_pro.pt`) for a
    `DepthPro35Config`."""
    st = SyntheticState(seed, std, device)
    gh = cfg.patch_res // cfg.patch_encoder.patch_size
    st.vit("encoder.patch_encoder.", cfg.patch_encoder, n_pos=gh * gh)
    st.vit("encoder.image_encoder.", cfg.image_encoder, n_pos=gh * gh)
    c, de, df = cfg.patch_encoder.width, cfg.dims_encoder, cfg.decoder_features
    for name, dim_int, dim_out, n_up in (("upsample_latent0", de[0], df, 3),
                                         ("upsample_latent1", de[0], de[0], 2),
                                         ("upsample0", de[1], de[1], 1),
                                         ("upsample1", de[2], de[2], 1),
                                         ("upsample2", de[3], de[3], 1)):
        st.conv(f"encoder.{name}.0.", c, dim_int, 1, bias=False)
        for i in range(n_up):
            st.deconv(f"encoder.{name}.{i + 1}.", dim_int if i == 0 else dim_out, dim_out, 2,
                      bias=False)
    st.deconv("encoder.upsample_lowres.", cfg.image_encoder.width, de[3], 2)
    st.conv("encoder.fuse_lowres.", 2 * de[3], de[3], 1)
    for i, d in enumerate(de, start=1):
        st.conv(f"decoder.convs.{i}.", d, df, 3, bias=False)
    for i in range(5):
        pre = f"decoder.fusions.{i}."
        for unit in ("resnet1", "resnet2"):
            st.conv(f"{pre}{unit}.residual.1.", df, df, 3)
            st.conv(f"{pre}{unit}.residual.3.", df, df, 3)
        if i:
            st.deconv(pre + "deconv.", df, df, 2, bias=False)
        st.conv(pre + "out_conv.", df, df, 1)
    st.conv("head.0.", df, df // 2, 3)
    st.deconv("head.1.", df // 2, df // 2, 2)
    st.conv("head.2.", df // 2, cfg.last_dims[0], 3)
    st.conv("head.4.", cfg.last_dims[0], cfg.last_dims[1], 1)
    if cfg.fov_encoder is not None:
        st.vit("fov.encoder.0.", cfg.fov_encoder, n_pos=gh * gh)
        st.linear("fov.encoder.1.", cfg.fov_encoder.width, df // 2)
        st.conv("fov.downsample.0.", df, df // 2, 3)
        st.conv("fov.head.0.", df // 2, df // 4, 3)
        st.conv("fov.head.2.", df // 4, max(df // 8, 1), 3)
        st.conv("fov.head.4.", max(df // 8, 1), 1, cfg.fov_final_kernel)
    return st


def released_mast3r_state(cfg, seed: int = 2, std: float = 0.02,
                          device: str | None = None) -> dict:
    """A MASt3R release's names and shapes (croco encoder and decoders,
    `downstream_head1/2`) for a `MatcherConfig` with the catmlpdpt head."""
    st = SyntheticState(seed, std, device)
    st.vit("", cfg.encoder, blocks="enc_blocks.", final_norm="enc_norm.")
    ew, dw = cfg.encoder.width, cfg.dec_width
    st.linear("decoder_embed.", ew, dw)
    st.norm("dec_norm.", dw)
    for blocks in ("dec_blocks.", "dec_blocks2."):
        for i in range(cfg.dec_depth):
            pre = f"{blocks}{i}."
            for n in ("norm1.", "norm2.", "norm3.", "norm_y."):
                st.norm(pre + n, dw)
            st.linear(pre + "attn.qkv.", dw, 3 * dw)
            st.linear(pre + "attn.proj.", dw, dw)
            for n in ("projq.", "projk.", "projv.", "proj."):
                st.linear(pre + "cross_attn." + n, dw, dw)
            st.linear(pre + "mlp.fc1.", dw, 4 * dw)
            st.linear(pre + "mlp.fc2.", 4 * dw, dw)
    ld, fd, p = cfg.layer_dims, cfg.feature_dim, cfg.encoder.patch_size
    for head in ("downstream_head1.", "downstream_head2."):
        act = head + "dpt.act_postprocess."
        st.conv(act + "0.0.", ew, ld[0], 1)
        st.deconv(act + "0.1.", ld[0], ld[0], 4)
        st.conv(act + "1.0.", dw, ld[1], 1)
        st.deconv(act + "1.1.", ld[1], ld[1], 2)
        st.conv(act + "2.0.", dw, ld[2], 1)
        st.conv(act + "3.0.", dw, ld[3], 1)
        st.conv(act + "3.1.", ld[3], ld[3], 3)
        for i in range(4):
            st.conv(f"{head}dpt.scratch.layer{i + 1}_rn.", ld[i], fd, 3, bias=False)
        for k in range(1, 5):
            for unit in ("resConfUnit1", "resConfUnit2"):
                st.conv(f"{head}dpt.scratch.refinenet{k}.{unit}.conv1.", fd, fd, 3)
                st.conv(f"{head}dpt.scratch.refinenet{k}.{unit}.conv2.", fd, fd, 3)
            st.conv(f"{head}dpt.scratch.refinenet{k}.out_conv.", fd, fd, 1)
        st.conv(head + "dpt.head.0.", fd, fd // 2, 3)
        st.conv(head + "dpt.head.2.", fd // 2, cfg.last_dim, 3)
        st.conv(head + "dpt.head.4.", cfg.last_dim, 4, 1)
        idim = ew + dw
        st.linear(head + "head_local_features.fc1.", idim, 4 * idim)
        st.linear(head + "head_local_features.fc2.", 4 * idim,
                  (cfg.desc_dim + int(cfg.two_confs)) * p * p)
    return st


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


F16_MAX = 65504.0  # the layout stage rounds box vertices to float16, as the reference


def f16_overflow(box: dict) -> bool:
    """True when a box's vertices are non-finite only because the float16
    rounding of vertices (`geometry/boxfit.py`, src/util_3dbox.py:165)
    overflowed: its unrounded centre and dimensions are finite and reach past
    +-65504."""
    import numpy as np

    c, d = np.asarray(box["center_cam"]), np.asarray(box["dimensions"])
    return bool(np.isfinite(c).all() and np.isfinite(d).all()
                and np.linalg.norm(c) + 0.5 * np.linalg.norm(d) > F16_MAX)


def check_scene_outputs(save_dir: str, loader, f16_overflow_ok: bool = False) -> tuple:
    """Every scene has its artifacts with finite values of the right shape
    (with `f16_overflow_ok`, a box may instead be a float16 overflow).
    Returns the scenes that have boxes and the scenes COCO3D lists, which
    must be the same (export skips exactly the scenes without boxes), and
    the number of overflowed boxes."""
    import numpy as np

    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name

    with_boxes, overflowed = set(), 0
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
        for b in boxes:
            if np.shape(b["bbox3D_cam"]) != (8, 3):
                raise RuntimeError(f"bad box shape in {sd.root}")
            if not np.isfinite(b["bbox3D_cam"]).all():
                if not (f16_overflow_ok and f16_overflow(b)):
                    raise RuntimeError(f"bad boxes in {sd.root}")
                overflowed += 1
        if boxes:
            with_boxes.add(name)
    with open(os.path.join(save_dir, "COCO3D_val.json")) as f:
        listed = {os.path.basename(im["file_path"]).rsplit(".", 1)[0]
                  for im in json.load(f)["images"]}
    return with_boxes, listed, overflowed


NN_DESIGN = ("nn_argmax.cu: 256-query blocks of four consumer warpgroups and a TMA "
             "producer warpgroup (setmaxnreg 112/24), bf16 bank prepared once per match, "
             "128-row bank tiles in an 8-stage mbarrier ring (64-byte swizzle), wgmma "
             "m64n64k16 with the query from registers, two accumulator sets a warpgroup, "
             "max-tree epilogue with first-index search on a new best, bank split for "
             "small launches")
YAW_DESIGN = ("yaw_minarea.cu: a cluster of 8 blocks an instance, valid points compacted "
              "in shared memory, 4 threads an angle, results merged through distributed "
              "shared memory")
KERNEL_NAMES = {"k1": "packed_attention", "k2": "flash_attention", "k3": "nn_argmax",
                "k4": "yaw_minarea"}
# What each kernel's device events are called in a profile: K1 and K2 are
# one template (attn_sm90::attention_kernel) over their loaders; a K3 call
# whose bank is split over blocks adds a merge kernel.
PROFILE_NAMES = {"k1": "PackedLoader", "k2": "StridedLoader", "k3": "nn_argmax_kernel",
                 "k3_merge": "nn_argmax_merge", "k4": "yaw_minarea"}
# What the Hopper designs of K1, K2 and K3 must compile to: warpgroup MMAs
# (wgmma) and TMA tile loads.
SASS_REQUIRED = ("HGMMA", "UTMALDG")


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, or the copy Triton ships, or None."""
    import shutil

    found = shutil.which("cuobjdump")
    candidates = [found] if found else []
    candidates.append("/usr/local/cuda/bin/cuobjdump")
    try:
        import triton

        candidates.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                                       "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in candidates if c and os.path.exists(c)), None)


def sass_opcodes(library: Path, tool: str) -> dict:
    """How often each opcode of SASS_REQUIRED (and TMA stores) appears in a
    built library's SASS."""
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {op: sass.count(op) for op in (*SASS_REQUIRED, "UTMASTG")}


def device_events(prof) -> list[tuple[float, str, int]]:
    """(ms, name, count) of a finished trace's device events (kernels,
    copies) by name, summed from the raw Kineto events: building
    `key_averages()`'s event tree takes tens of seconds over the 10^5
    kernels of a chain pass, this a fraction of a second. Falls back to
    `key_averages()` where the raw events are not exposed."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    acc: dict[str, list] = {}
    try:
        raw = [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
    except AttributeError:
        return [(e.self_device_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
                if e.device_type == cuda]
    for name, ms in raw:
        a = acc.setdefault(name, [0.0, 0])
        a[0] += ms
        a[1] += 1
    return [(ms, name, n) for name, (ms, n) in acc.items()]


def profile_pass(run, host: bool = True) -> dict:
    """One pass under torch.profiler: the summed time of the device's own
    events (kernels, copies), each port kernel's share, the events that take
    most of it, and the host ops with the most self CPU time. Only device
    events are summed, so nothing is counted twice. With `host` False only
    the device is traced (no host ops listed), which costs a fraction of
    the time of recording every host op."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = sorted(device_events(prof), reverse=True)
    hosts = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
                    if e.device_type != torch.autograd.DeviceType.CUDA), reverse=True) \
        if host else []
    out = {"wall_ms": wall * 1e3, "device_ms": sum(r[0] for r in dev),
           "top_device": [(round(ms, 3), name[:60], n) for ms, name, n in dev[:10]],
           "top_host": [(round(ms, 3), name[:60], n) for ms, name, n in hosts[:8]]}
    for k, sub in PROFILE_NAMES.items():
        out[f"{k}_ms"] = sum(r[0] for r in dev if sub in r[1])
        out[f"{k}_events"] = sum(r[2] for r in dev if sub in r[1])
    return out


def check_registration_outputs(save_dir: str, loader) -> tuple:
    """Every scene of the registration chain has its object meshes, a
    full-scene mesh and boxes that are finite or float16 overflows: with
    random weights, random descriptors pass PnP for some objects, and the
    depth models' maps, mostly the 10000 sentinel, then give scales near
    1e4. Returns what `check_scene_outputs` returns."""
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name

    for info in loader.images:
        sd = SceneDir(os.path.join(save_dir, "val", scene_dir_name(info["file_name"])))
        if not list((sd.root / "object_space").glob("*.glb")):
            raise RuntimeError(f"no object meshes in {sd.root}")
        if not (sd.root / "reconstruction" / "full_scene.glb").exists():
            raise RuntimeError(f"no full_scene.glb in {sd.root}")
    return check_scene_outputs(save_dir, loader, f16_overflow_ok=True)


def kernel_counters() -> tuple[dict, dict]:
    """Each kernel wrapper's launch counter and plain-version call counter."""
    from labelany3d_tpu_torch.ops import attention as att
    from labelany3d_tpu_torch.ops import boxfit_yaw as by
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    return ({"k1": att.KERNEL_LAUNCHES, "k2": att.FLASH_LAUNCHES, "k3": rnn.KERNEL_LAUNCHES,
             "k4": by.KERNEL_LAUNCHES},
            {"k1": att.PLAIN_CALLS, "k2": att.FLASH_PLAIN_CALLS, "k3": rnn.PLAIN_CALLS,
             "k4": by.PLAIN_CALLS})


def png_size(path) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk, without decoding it."""
    with open(path, "rb") as f:
        w, h = struct.unpack(">II", f.read(24)[16:24])
    return h, w


def check_all_route_outputs(save_dir: str, loader) -> dict:
    """The `all` route's stages 2 to 5 on every scene: the enhanced image's
    size, and each crop's square, whose params must be in original-image
    pixels: centred on its instance's box and as wide as the crop stage
    makes it (max(w, h) / 0.7) within a pixel, centre inside the image.
    Cut from the 4x image with its params left at 4x, a crop's square would
    be 4x too wide."""
    import numpy as np

    from labelany3d_tpu_torch.data.sources import CoconutInstanceProvider
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name

    prov = CoconutInstanceProvider(loader)
    sizes, crops, bad, missing = set(), 0, [], 0
    for info in loader.images:
        sd = SceneDir(os.path.join(save_dir, "val", scene_dir_name(info["file_name"])))
        sizes.add(png_size(sd.enhanced_image))
        boxes = prov.instances(info).bboxes
        for obj_id in sd.list_crop_ids():
            crops += 1
            missing += not (sd.crop_completed(obj_id).exists()
                            and sd.elevation(obj_id).exists())
            x, y, w, h = boxes[int(obj_id.split("_")[0])]
            ox, oy, sc = np.load(sd.crop_params(obj_id))
            side = CROP_SIZE / sc
            cx, cy = ox + side / 2, oy + side / 2
            if (abs(cx - (x + w / 2)) > 1.0 or abs(cy - (y + h / 2)) > 1.0
                    or abs(side - max(w, h) / 0.7) > 1.0
                    or not (0 <= cx < info["width"] and 0 <= cy < info["height"])):
                bad.append(f"{info['id']}:{obj_id}")
    want = (ENHANCE_FACTOR * IMAGE_HW[0], ENHANCE_FACTOR * IMAGE_HW[1])
    return {"enhanced_hw": sorted(sizes), "crops": crops, "crops_bad": bad,
            "crops_without_stage_4_5": missing,
            "ok": sizes == {want} and crops > 0 and not bad and not missing}


def matcher_launches(cfg, forwards: int) -> dict:
    """K1, K2 and K3 launches of `forwards` matcher forwards: its encoder
    runs K1 with learned positions, K2 with rope; each decoder block's two
    streams run K2 for self- and cross-attention; a reciprocal-NN match
    runs K3 twice in each of its 6 rounds."""
    enc = cfg.encoder
    enc_k1 = enc.depth if enc.pos_embed == "learned" else 0
    return {"k1": enc_k1 * forwards, "k2": (enc.depth - enc_k1 + 4 * cfg.dec_depth) * forwards,
            "k3": 12 * forwards}


def run_registration(cfg_kw: dict, tmp: str, seed: int = 3, name: str = "reg",
                     depth_kw: dict | None = None, matcher_cfg=None,
                     matcher_params=None, route: str = "chain",
                     trace_host: bool = True) -> dict:
    """The registration chain on the card: cold pass (models built, first
    launches; launch counts read here), warm pass (timed), traced pass.
    `route` is "chain" (depth -> crops -> reconstruction -> layout ->
    export, one `run_stages` call a stage) or "all" (the runner's `all`
    route, which adds enhance, completion and elevation at their shipping
    defaults). `depth_kw` goes to the registry's depth factory (default:
    the `large` preset); `matcher_cfg` and `matcher_params` to
    `TorchMatcherBackend` (default: the full-width `MatcherConfig()`,
    random weights). `trace_host` False traces only the device in the
    traced pass. Output directories are `<tmp>/<name>_{cold,warm,prof}`."""
    import torch

    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn
    from labelany3d_tpu_torch.pipeline.backends import TorchMatcherBackend, default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils.profiling import StageTimer

    cfg = PipelineConfig(bbox_method="minarea_pallas", **cfg_kw)
    loader = SyntheticLoader(N_REG_IMAGES, IMAGE_HW, seed=seed, min_inst=REG_INSTANCES,
                             max_inst=REG_INSTANCES)
    source = ArrayImageSource(loader.pixels)
    backend = default_registry().get("depth", **(depth_kw or {"preset": "large"}),
                                     pin_hw=cfg.bucket_sizes()[0], device="cuda",
                                     seed=cfg.seed)
    matcher = TorchMatcherBackend(cfg=matcher_cfg, params=matcher_params, tiny=False,
                                  seed=cfg.seed, device="cuda")
    calls, stage_names = (["all"], ALL_STAGES) if route == "all" else (CHAIN, CHAIN)
    counters, plains = kernel_counters()

    def run(out_dir, timer=None, stages=None):
        for stage in calls:
            run_stages(stage, cfg, loader, source, out_dir, "val", 0, N_REG_IMAGES,
                       backend=backend, matcher=matcher, device="cuda", timer=timer,
                       stages=stages)
        torch.cuda.synchronize()

    res = {}
    for c in (*counters.values(), *plains.values()):
        c.reset()
    rnn.LAUNCHES_BY_SHAPE.clear()
    matcher.forwards = 0
    torch.cuda.reset_peak_memory_stats()
    stages: dict = {}
    t0 = time.perf_counter()
    cold = os.path.join(tmp, f"{name}_cold")
    run(cold, stages=stages)
    res["cold_s"] = time.perf_counter() - t0
    res["launches"] = {k: c.count for k, c in counters.items()}
    res["plain_calls"] = {k: c.count for k, c in plains.items()}
    res["k3_by_shape"] = dict(rnn.LAUNCHES_BY_SHAPE)
    res["forwards"] = matcher.forwards
    res["failures"] = list(stages["layout"].failures)
    with_boxes, listed, res["f16_overflow_boxes"] = check_registration_outputs(cold, loader)
    res["scenes_with_boxes"], res["coco3d_images"] = len(with_boxes), len(listed)
    from labelany3d_tpu_torch.pipeline.scene import scene_dir_name

    placed = sum((Path(cold) / "val" / scene_dir_name(i["file_name"]) / "reconstruction"
                  / "full_scene.glb").exists() for i in loader.images)
    # Per depth batch one forward of each depth ViT: MoGe's, and DepthPro's
    # (the 2x2-tile model's one, or the 35-patch model's patch, image and
    # FoV encoders); learned position embeddings run K1 in every block.
    dp = backend.dp_cfg
    depth_vits = ([dp.patch_encoder, dp.image_encoder, dp.fov_encoder] if backend._dp35
                  else [dp.backbone])
    depth_k1 = (-(-N_REG_IMAGES // cfg.batch_size)
                * sum(v.depth for v in [backend.moge_cfg.backbone, *depth_vits] if v))
    fwd = res["forwards"]
    m = matcher_launches(matcher.cfg, fwd)
    res["want"] = {"k1": depth_k1 + m["k1"], "k2": m["k2"], "k3": m["k3"], "k4": placed}
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and not res["failures"] and fwd > 0
                 and with_boxes == listed and len(with_boxes) == N_REG_IMAGES)
    if route == "all":
        res["stages_2_to_5"] = check_all_route_outputs(cold, loader)
        res["ok"] = res["ok"] and res["stages_2_to_5"]["ok"]

    timer = StageTimer()
    t0 = time.perf_counter()
    run(os.path.join(tmp, f"{name}_warm"), timer=timer)
    warm_s = time.perf_counter() - t0
    res["warm_s"] = warm_s
    res["images_per_s"] = N_REG_IMAGES / warm_s
    res["stage_s"] = {k: timer.stats[k].total_seconds for k in stage_names}
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_pass(lambda: run(os.path.join(tmp, f"{name}_prof")), host=trace_host)
    res["profile"] = prof
    res["idle_share"] = (1.0 - prof["device_ms"] / (warm_s * 1e3) if prof["device_ms"] > 0
                         else "not measured")
    return res


def check_scene_plys(save_dir: str, loader) -> int:
    """Scenes whose two PLYs exist, with one point-cloud vertex a pixel."""
    from labelany3d_tpu_torch.data.meshio import load_ply_points
    from labelany3d_tpu_torch.pipeline.scene import scene_dir_name

    n = 0
    for info in loader.images:
        root = Path(save_dir) / "val" / scene_dir_name(info["file_name"])
        if not (root / "depth_scene_no_edge.ply").exists():
            continue
        pts, cols = load_ply_points(root / "depth_scene.ply")
        n += pts.shape == (info["height"] * info["width"], 3) and cols is not None
    return n


def boxes_against_cpu(cfg, loader, save_dir: str) -> dict:
    """The boxes stage's first batch labelled on the card and on the CPU,
    from the same depth, packed masks and draws (the stage's own host prep);
    and the first scene's edge-filtered mesh on both, from the same depth.
    Box error is absolute, relative above 1 (depths reach the hundreds)."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.geometry.backproject import depth_to_points, draw_instance_ranks
    from labelany3d_tpu_torch.geometry.edges import edge_filtered_scene_mesh
    from labelany3d_tpu_torch.pipeline.labeling import unpack_instance_masks
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.pipeline.stages import BoxStage

    scenes = [(info, SceneDir(os.path.join(save_dir, "val", scene_dir_name(info["file_name"]))))
              for info in loader.images[:cfg.batch_size]]
    probe = BoxStage(cfg, loader, save_dir, "val", device="cpu")
    group = [g for g in map(probe._prep, scenes) if g is not None]
    packed = torch.as_tensor(np.stack([g[6] for g in group]).astype(np.int64))
    depth = torch.as_tensor(np.stack([g[4] for g in group]))
    ok_px = (depth > 0) & (depth < 9000.0) & torch.isfinite(depth)
    eff = unpack_instance_masks(packed, cfg.max_instances) & ok_px[:, None]
    ranks = draw_instance_ranks(eff.flatten(-2).sum(-1), cfg.num_points,
                                torch.Generator().manual_seed(9))
    out = {}
    for dev in ("cuda", "cpu"):
        boxes = BoxStage(cfg, loader, save_dir, "val", device=dev,
                         draws=[ranks.to(dev)]).label(group).boxes
        out[dev] = type(boxes)(*(t.cpu() for t in boxes))
    ok = out["cpu"].ok
    err = max(float(((getattr(out["cuda"], f) - getattr(out["cpu"], f)).abs()
                     / getattr(out["cpu"], f).abs().clamp_min(1.0))[ok].max())
              for f in ("center_cam", "dimensions", "R_cam"))
    depth0 = scenes[0][1].read_depth()
    K0 = np.asarray(scenes[0][1].read_cam_params()["K"], np.float32)
    image0 = loader.pixels[scenes[0][0]["id"]]
    faces = {}
    for dev in ("cuda", "cpu"):
        d = torch.as_tensor(depth0, device=dev)
        pts = depth_to_points(d, torch.as_tensor(K0, device=dev))
        faces[dev] = len(edge_filtered_scene_mesh(pts, image0, d, (d > 0) & (d < 9000))[1])
    face_rel = abs(faces["cuda"] - faces["cpu"]) / max(faces["cpu"], 1)
    return {"box_err": err, "boxes": int(ok.sum()),
            "ok_equal": bool(torch.equal(out["cuda"].ok, ok)),
            "mesh_faces_card": faces["cuda"], "mesh_faces_cpu": faces["cpu"],
            "mesh_face_rel_diff": face_rel,
            "ok": (bool(torch.equal(out["cuda"].ok, ok)) and int(ok.sum()) > 0
                   and err <= BOX_TOL and face_rel <= MESH_FACE_TOL)}


def run_boxes_route(tmp: str) -> dict:
    """The `boxes` route on the card over the `fast` route's 16 images at
    the `large` preset: depth with the scene PLYs, boxes with
    `bbox_method=minarea_pallas`, export. Cold pass (launch counts read
    here), then the checks against the CPU, then a warm pass (timed)."""
    import torch

    from labelany3d_tpu_torch.pipeline.backends import default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.stages import DepthStage
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils.profiling import StageTimer

    cfg = PipelineConfig(bbox_method="minarea_pallas")
    loader = SyntheticLoader(N_IMAGES, IMAGE_HW, seed=0)
    source = ArrayImageSource(loader.pixels)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    counters, plains = kernel_counters()

    def run(out_dir, timer):
        with timer.measure("depth"):
            n = DepthStage(cfg, backend, loader, source, out_dir, "val",
                           write_ply=True).run(0, N_IMAGES)
        timer.add_items("depth", n)
        for stage in ("boxes", "export"):
            run_stages(stage, cfg, loader, source, out_dir, "val", 0, N_IMAGES,
                       device="cuda", timer=timer)
        torch.cuda.synchronize()

    for c in (*counters.values(), *plains.values()):
        c.reset()
    res = {}
    t0 = time.perf_counter()
    cold = os.path.join(tmp, "boxes_cold")
    run(cold, StageTimer())
    res["cold_s"] = time.perf_counter() - t0
    res["launches"] = {k: c.count for k, c in counters.items()}
    res["plain_calls"] = {k: c.count for k, c in plains.items()}
    batches = -(-N_IMAGES // cfg.batch_size)
    res["want"] = {"k1": batches * (backend.moge_cfg.backbone.depth
                                    + backend.dp_cfg.backbone.depth),
                   "k2": 0, "k3": 0, "k4": batches}
    with_boxes, listed, _ = check_scene_outputs(cold, loader)
    res["scenes_with_boxes"], res["coco3d_images"] = len(with_boxes), len(listed)
    res["scenes_with_plys"] = check_scene_plys(cold, loader)
    res["check"] = boxes_against_cpu(cfg, loader, cold)
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and with_boxes == listed and bool(with_boxes)
                 and res["scenes_with_plys"] == N_IMAGES and res["check"]["ok"])

    timer = StageTimer()
    t0 = time.perf_counter()
    run(os.path.join(tmp, "boxes_warm"), timer)
    res["warm_s"] = time.perf_counter() - t0
    res["images_per_s"] = N_IMAGES / res["warm_s"]
    res["stage_s"] = {k: timer.stats[k].total_seconds for k in ("depth", "boxes", "export")}
    return res


def reference_weights() -> tuple[dict, dict]:
    """Released-checkpoint-shaped state dicts for the `vitl_reference` depth
    preset and `MatcherConfig.mast3r_vitl()` at full size, made from seeds,
    through the port's converters: Flax-layout trees under `params_moge`,
    `params_depth_pro` and `matcher`, and each one's parameter count."""
    from labelany3d_tpu_torch.models import convert
    from labelany3d_tpu_torch.models.depth_pro import DepthPro35Config
    from labelany3d_tpu_torch.models.matcher import MatcherConfig
    from labelany3d_tpu_torch.models.moge import MoGeConfig

    out, counts = {}, {}
    for key, cfg, make, conv in (
            ("params_moge", MoGeConfig.vitl(), released_moge_state,
             lambda st, c: convert.convert_moge_checkpoint(st, c, c.backbone.pos_grid)),
            ("params_depth_pro", DepthPro35Config(), released_depth_pro_state,
             convert.convert_depth_pro),
            ("matcher", MatcherConfig.mast3r_vitl(), released_mast3r_state,
             convert.convert_mast3r)):
        state = make(cfg, device="cuda")  # one released state dict in memory at a time
        counts[key] = sum(v.size for v in state.values())
        out[key] = conv(state, cfg)
        del state
    return out, counts


def k3_launches(by_shape: dict, pairs: int, s: int, precision: str = "bf16") -> int:
    """K3 launches the registration run made at (pairs, s, precision),
    whatever their bank split, from `rnn.LAUNCHES_BY_SHAPE`."""
    return sum(n for (p, q, _, prec), n in by_shape.items() if (p, q, prec) == (pairs, s, precision))


def k3_shapes_json(by_shape: dict) -> str:
    """{"pairs x queries x chunks precision": launches}, largest first."""
    return json.dumps({f"{p}x{q}x{c} {prec}": n
                       for (p, q, c, prec), n in sorted(by_shape.items(), reverse=True)})


def kernel_checks() -> dict:
    """K2, K3 and K4 against their plain versions at the registration
    path's shapes; raises SystemExit on any disagreement. Returns the timed
    result of each kernel."""
    # K2: the decoder's self-attention over 4 objects x 8 views, a cross
    # shape with Sq != Sk read through strides, and segment ids with NaN pads.
    k2 = {"path": check_flash(32, 1296, 1296, seed=11, timed=True),
          "cross": check_flash(8, 1296, 777, seed=12, strided=True),
          "segment_ids": check_flash(4, 1296, 1296, seed=13, pad_keys=101),
          # The reference chain: the MASt3R rope encoder over 4 references +
          # 32 views (16 heads, 32x32 tokens at 512^2, no pad), a padded rope
          # encoder's segment ids at 16 heads, and the decoder at 1024
          # tokens in a stage-A (32 pairs) and a stage-B (4 pairs) forward.
          "rope_encoder": check_flash(36, 1024, 1024, seed=14, heads=16, timed=True),
          "rope_segment_ids": check_flash(4, 1024, 1024, seed=15, heads=16, pad_keys=101),
          "decoder_1024": check_flash(32, 1024, 1024, seed=16, timed=True),
          "stage_b_1024": check_flash(4, 1024, 1024, seed=17, timed=True),
          # Stage B's rope encoder: 4 references + 4 views (match_pairs
          # buckets both to 4).
          "rope_encoder_stage_b": check_flash(8, 1024, 1024, seed=18, heads=16, timed=True),
          # TRELLIS's flows, CFG as one batch of 2: the SS DiT over 16^3
          # tokens, its cross-attention to the 1374 DINOv2 tokens (a ragged
          # last key tile), the SLat torso at the largest bucket (8192 slots)
          # with 1024 pad slots masked by segment ids, and its cross-attention.
          "trellis_ss_self": check_flash(2, 4096, 4096, seed=41, heads=16, timed=True),
          "trellis_ss_cross": check_flash(2, 4096, 1374, seed=42, heads=16, timed=True),
          "trellis_slat_self": check_flash(2, 8192, 8192, seed=43, heads=16, pad_keys=1024,
                                           timed=True),
          "trellis_slat_cross": check_flash(2, 8192, 1374, seed=44, heads=16, timed=True),
          # The torso shape without segment ids: what the masking costs.
          "trellis_slat_self_unmasked": check_flash(2, 8192, 8192, seed=45, heads=16,
                                                    timed=True),
          # Stage 5's elevation matcher: its tiny decoder (2 heads of 32)
          # over one pair of 256^2 views, and a cross shape through strides.
          "elevation_decoder": check_flash(1, 1024, 1024, seed=46, heads=2, d=32, timed=True,
                                           graph=True),
          "elevation_cross_d32": check_flash(2, 1024, 777, seed=47, heads=2, d=32,
                                             strided=True),
          # Stage 6's SVRM (obj_rec=hunyuan3d): its DINOv2 ViT-B/14 encoder
          # over 7 views of 1 + 36^2 tokens (an odd Sq), again with q, k and
          # v as column views of the fused qkv projection; an LRM block's
          # self-attention over the 3 * 64^2 plane tokens and its
          # cross-attention to the 7 x 1297 view tokens.
          "svrm_encoder": check_flash(7, 1297, 1297, seed=48, heads=12, timed=True),
          "svrm_encoder_fused": check_flash(7, 1297, 1297, seed=49, heads=12, fused=True),
          "svrm_lrm_self": check_flash(1, 12288, 12288, seed=50, heads=16, timed=True),
          "svrm_lrm_cross": check_flash(1, 12288, 9079, seed=51, heads=16, timed=True)}
    for name, r in k2.items():
        _say(f"K2:{name}", **r, max_abs_tol=K2_MAX_ABS_TOL, rel_tol=K2_REL_TOL)
    bad = [n for n, r in k2.items() if not r["finite"] or r["max_abs_err"] > K2_MAX_ABS_TOL
           or r["rel_err"] > K2_REL_TOL]
    if bad:
        raise SystemExit(f"K2 disagrees with its plain version: {bad}")

    # K3: round 1 of a stage-A matcher forward (32 pairs, 4096 queries each,
    # against 512^2 banks), a compacted round (1024 queries, with its library
    # yardstick), the same two rounds of a stage-B forward (at most 4 pairs:
    # the bank split over blocks), one pair (with its yardstick), a
    # pre-padded bank with garbage beyond n_real, and all-negative scores
    # with an n_real that ends inside a bank tile.
    n = IMAGE_HW[0] * IMAGE_HW[1]
    pairs = STAGE_A_PAIRS
    k3 = {}
    for prec in ("bf16", "bf16x3"):
        k3[f"path_{prec}"] = check_nn(pairs, 4096, n, seed=21, precision=prec, timed=True)
        k3[f"compact_{prec}"] = check_nn(pairs, 1024, n, seed=22, precision=prec,
                                         timed=prec == "bf16")
        if prec == "bf16":
            k3["stage_b_path_bf16"] = check_nn(4, 4096, n, seed=26, precision=prec, timed=True)
            k3["stage_b_compact_bf16"] = check_nn(4, 1024, n, seed=27, precision=prec,
                                                  timed=True)
        k3[f"one_pair_{prec}"] = check_nn(1, 4096, n, seed=24, precision=prec, timed=True)
        if prec == "bf16":
            # Stage 5's elevation matcher: one pair of 256^2 views, 8-wide
            # descriptors, 32^2 start points. Its compacted rounds query
            # min(1024, 32^2) points, so every round has this shape.
            k3["elevation_bf16"] = check_nn(1, ELEVATION_STARTS, ELEVATION_VIEW ** 2, seed=28,
                                            precision=prec, c=ELEVATION_DESC, timed=True,
                                            graph=True)
        k3[f"padded_{prec}"] = check_nn(2, 1024, n, seed=23, precision=prec, n_real=n - 37)
        k3[f"negative_{prec}"] = check_nn(2, 1000, n, seed=25, precision=prec, n_real=n - 37,
                                          negative=True)
    for name, r in k3.items():
        _say(f"K3:{name}", **r, score_tol=K3_SCORE_TOL)
    bad = [name for name, r in k3.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"K3 disagrees with its plain version: {bad}")

    # K4: the layout stage's box fit (16 slots x 500 samples) and the fast
    # route's (8 images x 16 instances, 512 points).
    k4 = {"layout": check_yaw(16, 500, seed=31, timed=True),
          "fast": check_yaw(128, 512, seed=32, timed=True)}
    for name, r in k4.items():
        _say(f"K4:{name}", **r, rel_tol=K4_REL_TOL)
    bad = [name for name, r in k4.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"K4 disagrees with its plain version: {bad}")
    return {"k2": k2, "k3": k3, "k4": k4}


# Phase 11, TRELLIS: weights in the release's torch layout, the components at
# full width on one object, and the card against the CPU at a reduced config
# with head dim 64. (The `all` route with obj_rec=trellis is phase 12(c).)

# The card (K1, K2: bf16 P before the PV product) against the CPU's plain
# versions, relative L2, stage by stage from the same inputs and bf16
# weights. The first card run measured at most 5.5e-4 (SLat, after 25 CFG
# steps); one bf16 rounding is 2^-9 = 2e-3. An unmasked pad key or a lost
# key tile moves an attention output by a few percent.
TRELLIS_REL_TOL = 5e-3
# The decoded Gaussians' means hold the decoder's card path (sparse convs,
# window attention: plain PyTorch on both sides, no K1 or K2) to the CPU's.
# The voxel positions, equal on both, dominate them: the first card run
# measured 1.3e-6. A shifted window or a lost voxel moves them by 1e-3 or
# more.
TRELLIS_MEANS_TOL = 1e-4
TRELLIS_IMAGES = 2
TRELLIS_INSTANCES = 2


def _dit_block_state(st, pre: str, dit, ctx: int) -> None:
    """A ModulatedTransformerCrossBlock (`blocks.{i}.`) in the release's names."""
    w, hd, hid = dit.width, dit.width // dit.num_heads, int(dit.width * dit.mlp_ratio)
    st.norm(pre + "norm2.", w)
    st.linear(pre + "self_attn.to_qkv.", w, 3 * w)
    st.linear(pre + "self_attn.to_out.", w, w)
    st.linear(pre + "cross_attn.to_q.", w, w)
    st.linear(pre + "cross_attn.to_kv.", ctx, 2 * w)
    st.linear(pre + "cross_attn.to_out.", w, w)
    for attn, on in (("self_attn.", dit.qk_rms_norm), ("cross_attn.", dit.qk_rms_norm_cross)):
        if on:
            st.const(pre + attn + "q_rms_norm.gamma", 1.0, dit.num_heads, hd)
            st.const(pre + attn + "k_rms_norm.gamma", 1.0, dit.num_heads, hd)
    st.linear(pre + "mlp.mlp.0.", w, hid)
    st.linear(pre + "mlp.mlp.2.", hid, w)
    st.linear(pre + "adaLN_modulation.1.", w, 6 * w)


def _flow_state(st, dit, ctx: int, n_in: int, n_out: int, end: int | None = None) -> None:
    """A flow model's input and output layers (`end` wide on the model's
    side: the DiT's width, or the SLat UNet's outer blocks'), timestep
    embedder and DiT blocks."""
    st.linear("input_layer.", n_in, end or dit.width)
    st.linear("t_embedder.mlp.0.", 256, dit.width)
    st.linear("t_embedder.mlp.2.", dit.width, dit.width)
    st.linear("out_layer.", end or dit.width, n_out)
    for i in range(dit.depth):
        _dit_block_state(st, f"blocks.{i}.", dit, ctx)


def _conv3d_state(st, pre: str, n_in: int, n_out: int, k: int = 3) -> None:
    st.rand(pre + "weight", n_out, n_in, k, k, k)
    st.const(pre + "bias", 0.0, n_out)


def _spconv_state(st, pre: str, n_in: int, n_out: int, k: int = 3) -> None:
    st.rand(pre + "conv.weight", n_out, k, k, k, n_in)  # spconv: (out, k, k, k, in)
    st.const(pre + "conv.bias", 0.0, n_out)


def _swin_torso_state(st, cfg) -> None:
    w, hid = cfg.model_channels, int(cfg.model_channels * cfg.mlp_ratio)
    st.linear("input_layer.", cfg.latent_channels, w)
    for i in range(cfg.num_blocks):
        st.linear(f"blocks.{i}.attn.to_qkv.", w, 3 * w)
        st.linear(f"blocks.{i}.attn.to_out.", w, w)
        st.linear(f"blocks.{i}.mlp.mlp.0.", w, hid)
        st.linear(f"blocks.{i}.mlp.mlp.2.", hid, w)


def released_trellis_states(cfg, seed: int = 40, std: float = 0.02, device: str | None = None):
    """The six components of a `TrellisPipelineConfig` as released torch
    state dicts (DINOv2 with registers in timm's names, then the five
    TRELLIS models), N(0, std^2) from seeds: yields (component, state), one
    in memory at a time."""
    from labelany3d_tpu_torch.models.trellis.decoders import flexicubes_channels

    ctx = cfg.cond_backbone.width
    st = SyntheticState(seed, std, device)
    gh, gw = cfg.cond_backbone.pos_grid
    st.vit("", cfg.cond_backbone, n_pos=gh * gw)
    yield "cond", st

    ss = cfg.structure
    st = SyntheticState(seed + 1, std, device)
    _flow_state(st, ss.dit, ctx, ss.latent_channels * ss.patch_size ** 3,
                ss.out_channels * ss.patch_size ** 3)
    yield "ss", st

    dec, ch = cfg.ss_dec, list(cfg.ss_dec.channels)
    st = SyntheticState(seed + 2, std, device)
    _conv3d_state(st, "input_layer.", dec.latent_channels, ch[0])

    def res3d(pre, c):
        st.norm(pre + "norm1.", c)
        _conv3d_state(st, pre + "conv1.", c, c)
        st.norm(pre + "norm2.", c)
        _conv3d_state(st, pre + "conv2.", c, c)

    for m in range(dec.num_res_blocks_middle):
        res3d(f"middle_block.{m}.", ch[0])
    idx = 0
    for i, c in enumerate(ch):
        for _ in range(dec.num_res_blocks):
            res3d(f"blocks.{idx}.", c)
            idx += 1
        if i < len(ch) - 1:
            _conv3d_state(st, f"blocks.{idx}.conv.", c, ch[i + 1] * 8)
            idx += 1
    st.norm("out_layer.0.", ch[-1])
    _conv3d_state(st, "out_layer.2.", ch[-1], dec.out_channels)
    yield "ss_dec", st

    sl, dit = cfg.slat, cfg.slat.dit
    io = list(sl.io_block_channels)
    st = SyntheticState(seed + 3, std, device)
    _flow_state(st, dit, ctx, sl.latent_channels, sl.out_channels, end=io[0])

    def sres(pre, c_in, c_out):
        st.norm(pre + "norm1.", c_in)
        _spconv_state(st, pre + "conv1.", c_in, c_out)
        _spconv_state(st, pre + "conv2.", c_out, c_out)
        st.linear(pre + "emb_layers.1.", dit.width, 2 * c_out)
        if c_in != c_out:
            st.linear(pre + "skip_connection.", c_in, c_out)

    j = 0
    for chs, nxt in zip(io, io[1:] + [dit.width]):
        for _ in range(sl.num_io_res_blocks - 1):
            sres(f"input_blocks.{j}.", chs, chs)
            j += 1
        sres(f"input_blocks.{j}.", chs, nxt)
        j += 1
    j, mult = 0, 2 if sl.use_skip_connection else 1
    for chs, prev in zip(reversed(io), [dit.width] + list(reversed(io[1:]))):
        sres(f"out_blocks.{j}.", prev * mult, chs)
        j += 1
        for _ in range(sl.num_io_res_blocks - 1):
            sres(f"out_blocks.{j}.", chs * mult, chs)
            j += 1
    yield "slat", st

    st = SyntheticState(seed + 4, std, device)
    _swin_torso_state(st, cfg.dec_gs)
    st.linear("out_layer.", cfg.dec_gs.model_channels, cfg.gs_rep.num_gaussians * 14)
    yield "gs", st

    dm, c = cfg.dec_mesh, cfg.dec_mesh.model_channels
    st = SyntheticState(seed + 5, std, device)
    _swin_torso_state(st, dm)
    for i, (c_in, c_out) in enumerate(((c, c // 4), (c // 4, c // 8))):
        pre = f"upsample.{i}."
        st.norm(pre + "act_layers.0.", c_in)
        _spconv_state(st, pre + "out_layers.0.", c_in, c_out)
        st.norm(pre + "out_layers.1.", c_out)
        _spconv_state(st, pre + "out_layers.3.", c_out, c_out)
        _spconv_state(st, pre + "skip_connection.", c_in, c_out, k=1)
    st.linear("out_layer.", c // 8, flexicubes_channels(True))
    yield "mesh", st


def trellis_converters(cfg) -> dict:
    """`models/convert_trellis.py`'s converter of each component at `cfg`."""
    from labelany3d_tpu_torch.models import convert_trellis as ct

    return {"cond": lambda s: ct.convert_trellis_cond(s, cfg.cond_backbone),
            "ss": lambda s: ct.convert_trellis_ss_flow(s, cfg.structure),
            "ss_dec": lambda s: ct.convert_trellis_ss_decoder(s, cfg.ss_dec),
            "slat": lambda s: ct.convert_trellis_slat_flow(s, cfg.slat),
            "gs": lambda s: ct.convert_trellis_slat_gs(s, cfg.dec_gs),
            "mesh": lambda s: ct.convert_trellis_slat_mesh(s, cfg.dec_mesh)}


def trellis_weights(cfg, seed: int = 40) -> tuple[dict, int]:
    """Flax-layout trees of the six components from released-layout state
    dicts (`released_trellis_states`) through `models/convert_trellis.py`,
    and the parameter count."""
    conv = trellis_converters(cfg)
    params, n = {}, 0
    for name, state in released_trellis_states(cfg, seed, device="cuda"):
        n += sum(v.size for v in state.values())
        params[name] = conv[name](state)
        del state
    return params, n


def trellis_launches(cfg) -> tuple[int, int]:
    """K1 and K2 launches of one object: the conditioner's blocks; each flow
    step's self- and cross-attention in every block (CFG is one batch)."""
    return cfg.cond_backbone.depth, 2 * (cfg.ss_sampler.steps * cfg.structure.dit.depth
                                         + cfg.slat_sampler.steps * cfg.slat.dit.depth)


def trellis_crop(seed: int = 0, size: int = 512):
    """A crop as the crop stage writes it: an RGBA ellipse on transparency."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    inside = ((yy - size / 2) / (0.35 * size)) ** 2 + ((xx - size / 2) / (0.25 * size)) ** 2 < 1
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = rng.integers(0, 256, (size, size, 3))
    img[..., 3] = inside * 255
    return img


def run_trellis_components(tmp: str, weights: dict) -> dict:
    """Phase 11(a): `TrellisPipeline.run` at `TrellisPipelineConfig()`
    (weights held in bf16) on one crop, its components timed by the run's
    own spans: a cold run (launch counts read here), a warm run (timed), a
    device-only traced run (the whole run's device time); then the GLB
    written and read back."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.data.meshio import load_glb, save_glb
    from labelany3d_tpu_torch.models.trellis import TrellisPipeline
    from labelany3d_tpu_torch.utils.profiling import StageTimer

    counters, plains = kernel_counters()
    tp = TrellisPipeline(params=weights, params_dtype=torch.bfloat16, device="cuda")
    c = tp.cfg
    rgba = trellis_crop()

    def timed_run():
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tp.run(rgba, seed=1, timer=timer)
        torch.cuda.synchronize()
        secs = {k: s.total_seconds for k, s in timer.stats.items()}
        secs["run"] = time.perf_counter() - t0
        return out, secs

    t0 = time.perf_counter()
    tp.init_params()
    res = {"init_s": time.perf_counter() - t0}
    for k in (*counters.values(), *plains.values()):
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    _, res["cold_s"] = timed_run()
    res["launches"] = {k: v.count for k, v in counters.items()}
    res["plain_calls"] = {k: v.count for k, v in plains.items()}
    out, warm = timed_run()
    res["warm_s"] = warm
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_pass(lambda: tp.run(rgba, seed=1), host=False)
    res["profile"] = prof
    res["idle_share"] = (1.0 - prof["device_ms"] / (warm["run"] * 1e3) if prof["device_ms"] > 0
                         else "not measured")
    mesh, valid = out["mesh"], out["valid"]
    res["voxels"] = int(valid.sum())
    res["buckets"] = tp.slat_buckets(out["coords"], valid)
    res["fine_voxels"] = int(out["mesh_features"][2].sum())
    res["faces"], res["vertices"] = len(mesh.faces), len(mesh.vertices)
    res["texture_hw"] = list(mesh.texture.shape[:2]) if mesh.texture is not None else None
    want = trellis_launches(c)
    res["want"] = {"k1": want[0], "k2": want[1], "k3": 0, "k4": 0}

    path = os.path.join(tmp, "trellis_object.glb")
    t0 = time.perf_counter()
    save_glb(path, mesh)
    back = load_glb(path)
    res["glb"] = {"s": time.perf_counter() - t0, "mb": os.path.getsize(path) / 1e6}
    tex = back.texture
    th, tw = tex.shape[:2]
    ui = np.clip(back.uv[:, 0] * (tw - 1), 0, tw - 1).astype(np.int64)
    vi = np.clip(back.uv[:, 1] * (th - 1), 0, th - 1).astype(np.int64)
    res["glb"]["ok"] = bool(
        np.array_equal(back.faces, mesh.faces) and np.array_equal(tex, mesh.texture)
        and np.array_equal(back.vertices, mesh.vertices)
        and np.allclose(back.colors, tex[vi, ui] / 255.0, atol=1e-6))
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and res["voxels"] > 0 and res["faces"] > 0 and res["glb"]["ok"])
    del tp
    torch.cuda.empty_cache()
    return res


def trellis_check_config():
    """A reduced TRELLIS with head dim 64 everywhere, so K1 and K2 take it:
    a 2-block ViT of width 128 (2 heads) at 112 px, flows of width 128 (2
    heads, 2 blocks) over an 8^3 latent and 512 voxels of a 32^3 grid,
    decoders of width 128, the release's samplers (25 steps each)."""
    from labelany3d_tpu_torch.models.trellis import (
        DiTConfig,
        GaussianRepConfig,
        SLatConfig,
        SLatDecoderConfig,
        SparseStructureConfig,
        SSDecoderConfig,
        TrellisPipelineConfig,
    )
    from labelany3d_tpu_torch.models.vit import ViTConfig

    dit = DiTConfig(width=128, depth=2, num_heads=2, cond_dim=128, qk_rms_norm=True)
    dec = SLatDecoderConfig(resolution=32, model_channels=128, num_blocks=2, num_heads=2)
    return TrellisPipelineConfig(
        cond_backbone=ViTConfig(width=128, depth=2, num_heads=2, num_register_tokens=4,
                                pos_grid=(8, 8)),
        cond_size=112,
        structure=SparseStructureConfig(latent_res=8, grid_size=32, dit=dit),
        ss_dec=SSDecoderConfig(channels=(64, 32, 16), num_res_blocks=1, num_res_blocks_middle=1),
        slat=SLatConfig(resolution=32, io_block_channels=(32,), dit=dit),
        dec_gs=dec, dec_mesh=dec, gs_rep=GaussianRepConfig(num_gaussians=8), max_voxels=512)


def trellis_card_vs_cpu(seed: int = 50) -> dict:
    """Phase 11(c): the reduced config with seeded released-layout weights
    (bf16 held) on the card, where K1 and K2 run, and on the CPU, where the
    plain versions run; each stage from the CPU's inputs to it and the same
    draws: conditioning tokens, SS latent, SLat (valid rows: invalid ones
    are zero) and the Gaussians' means (valid Gaussians). Relative L2;
    K1 and K2 launch as often as `trellis_launches` says."""
    import copy

    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.trellis import TrellisPipeline

    cfg = trellis_check_config()
    weights, _ = trellis_weights(cfg, seed)
    pipes = {d: TrellisPipeline(cfg, params=copy.deepcopy(weights), params_dtype=torch.bfloat16,
                                device=d) for d in ("cpu", "cuda")}
    counters, plains = kernel_counters()
    for k in (*counters.values(), *plains.values()):
        k.reset()
    rng = np.random.default_rng(seed)
    ss_noise = rng.standard_normal((1, cfg.structure.latent_res ** 3, 8)).astype(np.float32)
    rgba = trellis_crop(seed, 256)

    def on(dev, t):
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    out = {d: {} for d in pipes}
    cpu = pipes["cpu"]
    out["cpu"]["cond"] = cpu.get_cond(cpu.preprocess(rgba))[0]
    for d, p in pipes.items():
        if d == "cuda":
            out[d]["cond"] = p.get_cond(p.preprocess(rgba))[0]
        cond = on(d, out["cpu"]["cond"])
        out[d]["latent"] = p.ss_latent(cond, torch.zeros_like(cond), on(d, torch.from_numpy(ss_noise)))
    coords, valid = cpu.sample_sparse_structure(out["cpu"]["cond"],
                                                torch.zeros_like(out["cpu"]["cond"]),
                                                torch.from_numpy(ss_noise))
    n_fine, torso = cpu.slat_buckets(coords, valid)
    slat_noise = torch.from_numpy(rng.standard_normal((1, n_fine, 8)).astype(np.float32))
    for d, p in pipes.items():
        cond = on(d, out["cpu"]["cond"])
        out[d]["slat"] = p.sample_slat(on(d, coords), on(d, valid), cond, torch.zeros_like(cond),
                                       on(d, slat_noise))
    for d, p in pipes.items():
        gs, _ = p.decode(on(d, out["cpu"]["slat"]), on(d, coords), on(d, valid))
        out[d]["means"] = gs.means[gs.valid]
    v = valid[0]
    res = {}
    for name in ("cond", "latent", "slat", "means"):
        a, b = out["cuda"][name].float().cpu(), out["cpu"][name].float()
        if name == "slat":
            a, b = a[0][v], b[0][v]
        res[name] = float((a - b).norm() / b.norm())
    res["launches"] = {k: c.count for k, c in counters.items()}
    k1, k2 = trellis_launches(cfg)
    res["want"] = {"k1": k1, "k2": k2, "k3": 0, "k4": 0}
    res["voxels"], res["buckets"] = int(v.sum()), (n_fine, torso)
    res["ok"] = (all(res[n] <= TRELLIS_REL_TOL for n in ("cond", "latent", "slat"))
                 and res["means"] <= TRELLIS_MEANS_TOL and res["launches"] == res["want"]
                 and res["voxels"] > 0)
    return res


def run_trellis(tmp: str) -> dict:
    """Phase 11: weights, (a) the components, (c) card against CPU; prints
    each part's lines. Phase 12(c) drives the `all` route with
    obj_rec=trellis. Returns both results."""
    from labelany3d_tpu_torch.models.trellis import TrellisPipelineConfig

    t0 = time.perf_counter()
    weights, n_params = trellis_weights(TrellisPipelineConfig())
    _say("trellis:weights", s=time.perf_counter() - t0, parameters=n_params)
    comp = run_trellis_components(tmp, weights)
    del weights
    p = comp["profile"]
    _say("trellis:components", init_s=comp["init_s"], cold_s=json.dumps(comp["cold_s"]),
         warm_s=json.dumps(comp["warm_s"]), voxels=comp["voxels"],
         buckets=json.dumps(comp["buckets"]), fine_voxels=comp["fine_voxels"],
         faces=comp["faces"], vertices=comp["vertices"], texture_hw=json.dumps(comp["texture_hw"]),
         launches=json.dumps(comp["launches"]), want=json.dumps(comp["want"]),
         plain_calls=json.dumps(comp["plain_calls"]), glb=json.dumps(comp["glb"]),
         max_memory_gb=comp["max_memory_gb"])
    _say("trellis:profile", device_ms=p["device_ms"], traced_wall_ms=p["wall_ms"],
         k1_device_ms=p["k1_ms"], k2_device_ms=p["k2_ms"], k1_device_events=p["k1_events"],
         k2_device_events=p["k2_events"], idle_share_of_warm_run=comp["idle_share"],
         top_device=json.dumps(p["top_device"]))
    if not comp["ok"]:
        raise SystemExit("trellis components: launches, plain calls, voxels, faces or the GLB "
                         "round trip are not as required (see trellis:components)")
    check = trellis_card_vs_cpu()
    _say("trellis:card_vs_cpu", **{k: json.dumps(v) if isinstance(v, (dict, tuple)) else v
                                   for k, v in check.items()}, rel_tol=TRELLIS_REL_TOL,
         means_tol=TRELLIS_MEANS_TOL)
    if not check["ok"]:
        raise SystemExit("trellis: the card disagrees with the CPU (see trellis:card_vs_cpu)")
    return {"components": comp, "card_vs_cpu": check}


# Phase 12, the SD-class stack (stage 2's `invsr`, stage 4's `our`, stage 5's
# `zero123`): weights in the releases' torch layouts (diffusers, transformers,
# DIS), the components at full width, the `all` route at the reference's
# configuration, and the card against the CPU at the tiny configs.


def _sd_resnet_state(st, pre: str, c_in: int, c_out: int, temb: int | None = None) -> None:
    """A diffusers ResnetBlock2D (with `time_emb_proj` when `temb`)."""
    st.norm(pre + "norm1.", c_in)
    st.conv(pre + "conv1.", c_in, c_out, 3)
    if temb:
        st.linear(pre + "time_emb_proj.", temb, c_out)
    st.norm(pre + "norm2.", c_out)
    st.conv(pre + "conv2.", c_out, c_out, 3)
    if c_in != c_out:
        st.conv(pre + "conv_shortcut.", c_in, c_out, 1)


def _sd_transformer_state(st, pre: str, c: int, ctx: int) -> None:
    """A diffusers SD-1.x Transformer2DModel: conv proj_in/out, one block."""
    st.norm(pre + "norm.", c)
    st.conv(pre + "proj_in.", c, c, 1)
    tb = pre + "transformer_blocks.0."
    for i, kv in ((1, c), (2, ctx)):
        st.norm(tb + f"norm{i}.", c)
        st.rand(tb + f"attn{i}.to_q.weight", c, c)
        st.rand(tb + f"attn{i}.to_k.weight", c, kv)
        st.rand(tb + f"attn{i}.to_v.weight", c, kv)
        st.linear(tb + f"attn{i}.to_out.0.", c, c)
    st.norm(tb + "norm3.", c)
    st.linear(tb + "ff.net.0.proj.", c, 8 * c)
    st.linear(tb + "ff.net.2.", 4 * c, c)
    st.conv(pre + "proj_out.", c, c, 1)


def _sd_attn_state(st, pre: str, c: int) -> None:
    """A diffusers group-norm Attention (VAE and noise-predictor blocks)."""
    st.norm(pre + "group_norm.", c)
    for n in ("to_q.", "to_k.", "to_v.", "to_out.0."):
        st.linear(pre + n, c, c)


def released_sd_unet_state(cfg, seed: int = 60, std: float = 0.02,
                           device: str | None = None) -> dict:
    """A diffusers `UNet2DConditionModel` release's names and shapes for a
    `UNetConfig`."""
    st = SyntheticState(seed, std, device)
    ws, nrb, ctx = list(cfg.widths), cfg.num_res_blocks, cfg.context_dim
    tdim = 4 * ws[0]
    st.conv("conv_in.", cfg.in_channels, ws[0], 3)
    st.linear("time_embedding.linear_1.", ws[0], tdim)
    st.linear("time_embedding.linear_2.", tdim, tdim)
    skips, c = [ws[0]], ws[0]
    for lvl, w in enumerate(ws):
        for i in range(nrb):
            _sd_resnet_state(st, f"down_blocks.{lvl}.resnets.{i}.", c, w, tdim)
            c = w
            if lvl in cfg.attn_levels:
                _sd_transformer_state(st, f"down_blocks.{lvl}.attentions.{i}.", c, ctx)
            skips.append(c)
        if lvl < len(ws) - 1:
            st.conv(f"down_blocks.{lvl}.downsamplers.0.conv.", c, c, 3)
            skips.append(c)
    _sd_resnet_state(st, "mid_block.resnets.0.", c, c, tdim)
    _sd_transformer_state(st, "mid_block.attentions.0.", c, ctx)
    _sd_resnet_state(st, "mid_block.resnets.1.", c, c, tdim)
    for u in range(len(ws)):
        lvl = len(ws) - 1 - u
        for i in range(nrb + 1):
            _sd_resnet_state(st, f"up_blocks.{u}.resnets.{i}.", c + skips.pop(), ws[lvl], tdim)
            c = ws[lvl]
            if lvl in cfg.attn_levels:
                _sd_transformer_state(st, f"up_blocks.{u}.attentions.{i}.", c, ctx)
        if lvl > 0:
            st.conv(f"up_blocks.{u}.upsamplers.0.conv.", c, c, 3)
    st.norm("conv_norm_out.", c)
    st.conv("conv_out.", c, cfg.out_channels, 3)
    return st


def with_conv_in(state: dict, in_channels: int, seed: int = 61) -> dict:
    """`state` with its `conv_in` widened to `in_channels` (the 8-channel
    completion and Zero123 UNets from one 4-channel state): the extra input
    channels N(0, std^2) from `seed`, everything else shared."""
    import numpy as np

    w = state["conv_in.weight"]
    extra = SyntheticState(seed, float(w.std()))
    extra.rand("w", w.shape[0], in_channels - w.shape[1], *w.shape[2:])
    out = dict(state)
    out["conv_in.weight"] = np.concatenate([w, extra["w"]], axis=1)
    return out


def released_sd_vae_state(cfg, seed: int = 62, std: float = 0.02,
                          device: str | None = None) -> dict:
    """A diffusers `AutoencoderKL` release's names and shapes for a `VAEConfig`."""
    st = SyntheticState(seed, std, device)
    ws, lc, n = list(cfg.widths), cfg.latent_channels, len(cfg.widths)

    def mid(pre, c):
        _sd_resnet_state(st, pre + "resnets.0.", c, c)
        _sd_attn_state(st, pre + "attentions.0.", c)
        _sd_resnet_state(st, pre + "resnets.1.", c, c)

    st.conv("encoder.conv_in.", 3, ws[0], 3)
    c = ws[0]
    for i, w in enumerate(ws):
        for r in range(cfg.layers_per_block):
            _sd_resnet_state(st, f"encoder.down_blocks.{i}.resnets.{r}.", c, w)
            c = w
        if i < n - 1:
            st.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.", w, w, 3)
    mid("encoder.mid_block.", c)
    st.norm("encoder.conv_norm_out.", c)
    st.conv("encoder.conv_out.", c, 2 * lc, 3)
    st.conv("quant_conv.", 2 * lc, 2 * lc, 1)
    st.conv("post_quant_conv.", lc, lc, 1)
    st.conv("decoder.conv_in.", lc, ws[-1], 3)
    c = ws[-1]
    mid("decoder.mid_block.", c)
    for j, w in enumerate(reversed(ws)):
        for r in range(cfg.layers_per_block + 1):
            _sd_resnet_state(st, f"decoder.up_blocks.{j}.resnets.{r}.", c, w)
            c = w
        if j < n - 1:
            st.conv(f"decoder.up_blocks.{j}.upsamplers.0.conv.", w, w, 3)
    st.norm("decoder.conv_norm_out.", c)
    st.conv("decoder.conv_out.", c, 3, 3)
    return st


def _clip_layers_state(st, pre: str, cfg) -> None:
    w, hid = cfg.width, int(cfg.width * cfg.mlp_ratio)
    for i in range(cfg.depth):
        b = f"{pre}encoder.layers.{i}."
        st.norm(b + "layer_norm1.", w)
        st.norm(b + "layer_norm2.", w)
        for n in ("q_proj.", "k_proj.", "v_proj.", "out_proj."):
            st.linear(b + "self_attn." + n, w, w)
        st.linear(b + "mlp.fc1.", w, hid)
        st.linear(b + "mlp.fc2.", hid, w)


def released_clip_text_state(cfg, seed: int = 63, std: float = 0.02,
                             device: str | None = None) -> dict:
    """A transformers `CLIPTextModel(WithProjection)` release for a
    `CLIPTextConfig`."""
    st = SyntheticState(seed, std, device)
    st.rand("text_model.embeddings.token_embedding.weight", cfg.vocab_size, cfg.width)
    st.rand("text_model.embeddings.position_embedding.weight", cfg.max_len, cfg.width)
    _clip_layers_state(st, "text_model.", cfg)
    st.norm("text_model.final_layer_norm.", cfg.width)
    if cfg.projection_dim is not None:
        st.rand("text_projection.weight", cfg.projection_dim, cfg.width)
    return st


def released_clip_vision_state(cfg, seed: int = 64, std: float = 0.02,
                               device: str | None = None) -> dict:
    """A transformers `CLIPVisionModelWithProjection` release for a
    `CLIPVisionConfig` (HF's `pre_layrnorm` spelling)."""
    st = SyntheticState(seed, std, device)
    p, w = cfg.patch_size, cfg.width
    st.conv("vision_model.embeddings.patch_embedding.", 3, w, p, bias=False)
    st.rand("vision_model.embeddings.class_embedding", w)
    st.rand("vision_model.embeddings.position_embedding.weight",
            1 + (cfg.image_size // p) ** 2, w)
    st.norm("vision_model.pre_layrnorm.", w)
    _clip_layers_state(st, "vision_model.", cfg)
    st.norm("vision_model.post_layernorm.", w)
    if cfg.projection_dim is not None:
        st.rand("visual_projection.weight", cfg.projection_dim, w)
    return st


def released_cc_state(emb_dim: int, out_dim: int, seed: int = 65, std: float = 0.02,
                      device: str | None = None) -> dict:
    """Zero123's `clip_camera_projection` (Linear(emb_dim + 4 -> out_dim))."""
    st = SyntheticState(seed, std, device)
    st.linear("proj.", emb_dim + 4, out_dim)
    return st


def released_isnet_state(cfg, seed: int = 66, std: float = 0.02,
                         device: str | None = None) -> dict:
    """DIS's `isnet-general-use.pth` names and shapes for an `ISNetConfig`:
    REBNCONVs with BatchNorm running statistics (mean 0, variance 1)."""
    st = SyntheticState(seed, std, device)

    def rebn(pre, c_in, c_out):
        st.conv(pre + "conv_s1.", c_in, c_out, 3)
        st.norm(pre + "bn_s1.", c_out)
        st.const(pre + "bn_s1.running_mean", 0.0, c_out)
        st.const(pre + "bn_s1.running_var", 1.0, c_out)

    def rsu(pre, c_in, spec):
        kind, mid, out = spec
        n = 4 if kind == "4F" else int(kind)
        rebn(pre + "rebnconvin.", c_in, out)
        rebn(pre + "rebnconv1.", out, mid)
        for i in range(2, n + 1):
            rebn(pre + f"rebnconv{i}.", mid, mid)
        for i in range(n - 1, 1, -1):
            rebn(pre + f"rebnconv{i}d.", 2 * mid, mid)
        rebn(pre + "rebnconv1d.", 2 * mid, out)

    st.conv("conv_in.", 3, cfg.conv_in, 3)
    c, enc_out = cfg.conv_in, []
    for i, spec in enumerate(cfg.enc):
        rsu(f"stage{i + 1}.", c, spec)
        c = spec[2]
        enc_out.append(c)
    for j, spec in enumerate(cfg.dec):
        rsu(f"stage{len(cfg.dec) - j}d.", c + enc_out[len(cfg.enc) - 2 - j], spec)
        c = spec[2]
    for i, ch in enumerate([s[2] for s in cfg.dec][::-1] + [enc_out[-1]]):
        st.conv(f"side{i + 1}.", ch, 1, 3)
    return st


def released_noise_predictor_state(cfg, seed: int = 67, std: float = 0.02,
                                   device: str | None = None) -> dict:
    """InvSR's `noise_predictor_sd_turbo_v5.pth` names (`encoder.*`) and
    shapes for a `NoisePredictorConfig`."""
    st = SyntheticState(seed, std, device)
    ws, temb = list(cfg.widths), cfg.temb_channels
    st.conv("encoder.conv_in.", cfg.in_channels, ws[0], 3)
    st.linear("encoder.time_embedding.linear_1.", max(128, ws[0]), temb)
    st.linear("encoder.time_embedding.linear_2.", temb, temb)
    c = ws[0]
    for i, w in enumerate(ws):
        for j in range(cfg.layers_per_block[i]):
            _sd_resnet_state(st, f"encoder.down_blocks.{i}.resnets.{j}.", c, w, temb)
            c = w
            _sd_attn_state(st, f"encoder.down_blocks.{i}.attentions.{j}.", c)
        if i != len(ws) - 1:
            st.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.", c, w, 3)
    _sd_resnet_state(st, "encoder.mid_block.resnets.0.", c, c, temb)
    _sd_attn_state(st, "encoder.mid_block.attentions.0.", c)
    _sd_resnet_state(st, "encoder.mid_block.resnets.1.", c, c, temb)
    st.norm("encoder.conv_norm_out.", c)
    st.conv("encoder.conv_out.", c, 2 * cfg.latent_channels, 3)
    return st


# The card against the CPU at the tiny SD configs in float32 (TF32 off on
# both): the UNet's and the VAE's outputs, relative L2. Their sums run in
# another order, nothing else differs; a wrong padding, norm or skip moves
# them by 1e-2 or more.
SD_REL_TOL = 1e-4
# The same for the 8-bit images out of a completion and a Zero123 view: a
# float32 difference of 1e-6 flips a pixel's truncation to 8 bits now and
# then, one level each; a few hundred such flips at 64 px give 1e-3.
SD_IMAGE_REL_TOL = 5e-3
# The same samplers' float images (the VAE's decode, before the clamp and
# the 8-bit truncation). DDIM and the guidance carry the UNet's 1e-6 through
# 20 and 50 steps; on the CPU a relative 1e-6 change of the UNet's weights
# moves these images by 3.8e-6 (completion) and 3.0e-6 (view), and one in
# 10^4 8-bit values by a level, so an 8-bit difference of 0 is no sign of a
# flat image. A wrong padding, norm or skip moves them by 1e-2 or more.
SD_SAMPLE_REL_TOL = 1e-3
# The card's 8-bit images must have content (at least this standard
# deviation in levels, at most this share of pixels at 0 or 255): a clamped
# or flat image agrees with the CPU's whatever the port computed.
SD_MIN_STD_LEVELS = 8.0
SD_MAX_SATURATED = 0.25
SD_IMAGES = 2              # phase 12(c): 2 images x 2 objects
SD_INSTANCES = 2
SD_CROP = 512              # the crops the route's stage 3 writes
# 12(c)'s peak when the runner kept every stage's models (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md section 5), printed beside the peak with unloading.
SD_ROUTE_PEAK_KEPT_GB = 15.2


def sd_weights(seed: int = 60) -> tuple[dict, int]:
    """Flax-layout trees of the SD-class components at the released widths
    from seeded release-layout state dicts through the port's converters:
    CLIP ViT-L/14 text and vision towers, one SD-1.5 UNet state (4 input
    channels: InvSR) whose `conv_in` is widened to 8 for the completion and
    Zero123 UNets, the VAE, Zero123's cc_projection and ISNet
    general-use. Returns the trees and the parameters made."""
    import dataclasses

    from labelany3d_tpu_torch.models.clip import (
        CLIPTextConfig,
        CLIPVisionConfig,
        convert_clip_text,
    )
    from labelany3d_tpu_torch.models.diffusion.convert import convert_sd_unet, convert_zero123
    from labelany3d_tpu_torch.models.diffusion.unet import UNetConfig
    from labelany3d_tpu_torch.models.diffusion.vae import VAEConfig
    from labelany3d_tpu_torch.models.saliency import ISNetConfig, convert_isnet

    ucfg, tcfg, vcfg = UNetConfig(), CLIPTextConfig.sd15(), CLIPVisionConfig.vitl14()
    vae_cfg = VAEConfig()
    dev = "cuda"
    unet4 = released_sd_unet_state(ucfg, seed, device=dev)
    vae = released_sd_vae_state(vae_cfg, seed + 2, device=dev)
    vision = released_clip_vision_state(vcfg, seed + 4, device=dev)
    cc = released_cc_state(vcfg.projection_dim, ucfg.context_dim, seed + 5, device=dev)
    text = released_clip_text_state(tcfg, seed + 3, device=dev)
    isnet = released_isnet_state(ISNetConfig.general_use(), seed + 6, device=dev)
    n = sum(v.size for st in (unet4, vae, vision, cc, text, isnet) for v in st.values())
    zero123 = convert_zero123(with_conv_in(unet4, 8, seed + 1), vae, vision, cc,
                              unet_cfg=dataclasses.replace(ucfg, in_channels=8),
                              vae_cfg=vae_cfg, vision_cfg=vcfg)
    trees = {"unet4": convert_sd_unet(unet4, ucfg), "zero123": zero123,
             "unet8": zero123["unet"], "vae": zero123["vae"],
             "text": convert_clip_text(text, tcfg),
             "isnet": convert_isnet(isnet, ISNetConfig.general_use())}
    return trees, n


def device_ms_by_op(prof) -> dict:
    """Device ms of a traced pass by the host op that launched it: the
    plain attention (batched matmuls and softmax), the other GEMMs, the
    convolutions, the norms, and the rest; K1, K2 and K3 (launched through
    ctypes, under no aten op) by kernel name."""
    import torch

    groups = {"attention": ("aten::bmm", "aten::_softmax", "aten::baddbmm"),
              "gemm": ("aten::addmm", "aten::mm"),
              "conv": ("convolution",),
              "norm": ("aten::native_group_norm", "aten::native_layer_norm")}
    out = {k: 0.0 for k in (*groups, "other")}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA or not e.self_device_time_total:
            continue
        ms = e.self_device_time_total / 1e3
        for g, names in groups.items():
            if any(n in e.key for n in names):
                out[g] += ms
                break
        else:
            out["other"] += ms
    for k in ("k1", "k2", "k3"):
        out[k] = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and PROFILE_NAMES[k] in e.key)
    return out


def run_sd_components(trees: dict) -> dict:
    """Phase 12(b): the SD-class components at the released widths on the
    card with seeded released-layout weights (held in bf16 where they
    compute in bf16), each call cold (its first) and warm, between CUDA
    syncs: the text encoder, the VAE at 256^2, one UNet forward (the
    completion's batch of 3 at 32^2 latents), InvSR on a 512^2 image, the
    completion of one 512^2 crop with ISNet at 1024^2, one Zero123 view
    and the elevation estimate (4 views, 4 tiny-matcher forwards); then a
    traced warm pass of InvSR, the completion and the estimate."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.diffusion import AmodalCompletion, InvSREnhance
    from labelany3d_tpu_torch.models.saliency import RembgSegmenter
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn
    from labelany3d_tpu_torch.pipeline.backends import make_elevation

    counters, plains = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    enh = InvSREnhance(device="cuda").set_params(
        {"unet": trees["unet4"], "vae": trees["vae"], "text": trees["text"]})
    comp = AmodalCompletion(segmenter=RembgSegmenter(params=trees["isnet"], device="cuda"),
                            device="cuda").set_params(
        {"unet": trees["unet8"], "vae": trees["vae"], "text": trees["text"]})
    est = make_elevation("zero123", device="cuda")
    nv = est.novel_views
    nv.set_params(trees["zero123"])
    for p in (enh, comp, nv):
        p.init_params()
    comp.segmenter._ensure()
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0, "cold_s": {}, "warm_s": {}}
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    crop = trellis_crop(12, SD_CROP)
    x256 = torch.tensor(rng.uniform(-1, 1, (1, 256, 256, 3)), dtype=torch.float32,
                        device="cuda")
    lat = torch.randn(3, 32, 32, 8, device="cuda")
    tt = torch.full((3,), 0.5, device="cuda")
    outs = {}

    def timed(name, fn, cold_arg=None, warm_arg=None):
        for phase, arg in (("cold_s", cold_arg), ("warm_s", warm_arg)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.inference_mode():
                outs[name] = fn() if arg is None else fn(arg)
            torch.cuda.synchronize()
            res[phase][name] = time.perf_counter() - t

    timed("text_embed", comp.text.embed, "a chair", "a table")
    ctx = comp.text.embed("a chair").expand(3, -1, -1)
    timed("vae_encode", lambda: enh.vae.encode(x256))
    timed("vae_decode", lambda: enh.vae.decode(outs["vae_encode"]))
    timed("unet_forward", lambda: comp.unet(lat, tt, ctx))
    timed("enhance", lambda: enh.enhance(img))
    timed("complete", lambda: comp.complete(crop, "chair"))
    timed("generate", lambda: nv.generate(crop, 10.0, 0.0, seed=0))
    for k in (*counters.values(), *plains.values()):
        k.reset()
    rnn.LAUNCHES_BY_SHAPE.clear()
    timed("estimate", lambda: est.estimate(outs["complete"]))
    res["launches"] = {k: v.count for k, v in counters.items()}
    res["plain_calls"] = {k: v.count for k, v in plains.items()}
    res["k3_by_shape"] = dict(rnn.LAUNCHES_BY_SHAPE)
    # The cold and warm estimates: 4 tiny-matcher forwards each.
    res["want"] = {**matcher_launches(est.pair_matcher.matcher.cfg, 8), "k4": 0}
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["shapes"] = {k: list(v.shape) for k, v in outs.items() if hasattr(v, "shape")}
    res["elevation"] = outs["estimate"]

    def warm():
        with torch.inference_mode():
            return enh.enhance(img), comp.complete(crop, "chair"), est.estimate(outs["complete"])

    t = time.perf_counter()
    warm()
    torch.cuda.synchronize()
    res["pass_s"] = time.perf_counter() - t
    # The pass traced on the device only (host-op tracing of its ~10^5
    # eager ops takes minutes); one warm UNet forward traced with its host
    # ops, for the device time by the op that launched it.
    prof = profile_pass(warm, host=False)
    res["profile"] = {k: prof[k] for k in ("device_ms", "wall_ms", "top_device", "k1_ms",
                                            "k2_ms", "k3_ms")}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as unet_prof, torch.inference_mode():
        comp.unet(lat, tt, ctx)
        torch.cuda.synchronize()
    res["profile"]["unet_forward_by_op_ms"] = device_ms_by_op(unet_prof)
    dev = prof["device_ms"]
    res["idle_share"] = 1.0 - dev / (res["pass_s"] * 1e3) if dev > 0 else "not measured"
    unet_out = outs["unet_forward"]
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and k3_launches(res["k3_by_shape"], 1, ELEVATION_STARTS) == res["want"]["k3"]
                 and bool(torch.isfinite(unet_out).all())
                 and res["shapes"]["enhance"] == [2048, 2048, 3]
                 and res["shapes"]["complete"] == [SD_CROP, SD_CROP, 4]
                 and res["shapes"]["generate"] == [256, 256, 3]
                 and -80.0 <= res["elevation"] <= 80.0)
    del enh, comp, est, nv, outs
    torch.cuda.empty_cache()
    return res


def check_sd_route_outputs(save_dir: str, loader) -> dict:
    """Every scene of the reference route has its 4x enhanced image, and
    each object its completed 512-px RGBA crop and a finite elevation on
    the estimator's grid."""
    import numpy as np

    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.utils.png import read_png

    sizes, objects, bad = set(), 0, []
    for info in loader.images:
        sd = SceneDir(os.path.join(save_dir, "val", scene_dir_name(info["file_name"])))
        sizes.add(png_size(sd.enhanced_image) if sd.enhanced_image.exists() else None)
        for obj_id in sd.list_crop_ids():
            objects += 1
            rgba = read_png(sd.crop_completed(obj_id)) if sd.crop_completed(obj_id).exists() \
                else None
            elev = float(np.load(sd.elevation(obj_id))) if sd.elevation(obj_id).exists() \
                else float("nan")
            if (rgba is None or rgba.shape != (SD_CROP, SD_CROP, 4) or rgba.dtype != np.uint8
                    or not -80.0 <= elev <= 80.0):
                bad.append(f"{info['id']}:{obj_id}")
    want = (ENHANCE_FACTOR * IMAGE_HW[0], ENHANCE_FACTOR * IMAGE_HW[1])
    return {"enhanced_hw": sorted(map(str, sizes)), "objects": objects, "bad": bad,
            "ok": sizes == {want} and objects == SD_IMAGES * SD_INSTANCES and not bad}


def run_reference_route(tmp: str) -> dict:
    """Phase 12(c): `run_stages("all", ...)`
    at the reference's configuration, run.enhance=invsr,
    run.amodal_completion=our, run.elevation=zero123 and run.obj_rec=trellis,
    over 2 synthetic images with 2 objects each; every generative backend
    from the registry's factories at its released widths with its default
    (random) initialisation, whose zero-initialised UNet and flow output
    layers (as the JAX package's) make DDIM only rescale its noise and
    TRELLIS's meshes empty; the layout stage then skips them, so no scene
    has boxes. Depth at the `large` preset, the layout's matcher
    `MatcherConfig()`; the elevation estimator runs its own tiny matcher
    (K1 and K2 at head dim 32, K3)."""
    import torch

    from labelany3d_tpu_torch.data.meshio import load_glb
    from labelany3d_tpu_torch.pipeline.backends import TorchMatcherBackend, default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource

    cfg = PipelineConfig(bbox_method="minarea_pallas")
    loader = SyntheticLoader(SD_IMAGES, IMAGE_HW, seed=11, min_inst=SD_INSTANCES,
                             max_inst=SD_INSTANCES)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    matcher = TorchMatcherBackend(tiny=False, seed=cfg.seed, device="cuda")
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    counters, plains = kernel_counters()
    for k in (*counters.values(), *plains.values()):
        k.reset()
    rnn.LAUNCHES_BY_SHAPE.clear()
    torch.cuda.reset_peak_memory_stats()
    def keep(name, stage):
        """What the phase reads of a finished stage; the rest (and the models
        the runner built) is freed between stages."""
        if name == "elevation":
            m = stage.backend.pair_matcher.matcher
            return SimpleNamespace(forwards=m.forwards, matcher_cfg=m.cfg)
        if name == "reconstruction":
            return SimpleNamespace(cfg=stage.backend.cfg)
        return stage if name == "layout" else None

    out_dir, stages, timer = os.path.join(tmp, "reference_all"), StageKeep(keep), peak_timer()
    t0 = time.perf_counter()
    run_stages("all", cfg, loader, ArrayImageSource(loader.pixels), out_dir, "val", 0,
               SD_IMAGES, backend=backend, matcher=matcher,
               run_options={"enhance": "invsr", "amodal_completion": "our",
                            "elevation": "zero123", "obj_rec": "trellis"},
               device="cuda", timer=timer, stages=stages)
    torch.cuda.synchronize()
    stages.close()
    est = stages["elevation"]
    res = {"s": time.perf_counter() - t0,
           "stage_s": {k: timer.stats[k].total_seconds for k in ALL_STAGES},
           "launches": {k: v.count for k, v in counters.items()},
           "plain_calls": {k: v.count for k, v in plains.items()},
           "failures": list(stages["layout"].failures), "forwards": matcher.forwards,
           "elevation_forwards": est.forwards,
           "k3_by_shape": dict(rnn.LAUNCHES_BY_SHAPE),
           "max_memory_gb": max(timer.peaks_gb.values()), "stage_peak_gb": timer.peaks_gb,
           "allocated_after_gb": torch.cuda.memory_allocated() / 1e9}
    glbs, with_boxes, depths = [], set(), 0
    for info in loader.images:
        name = scene_dir_name(info["file_name"])
        sd = SceneDir(os.path.join(out_dir, "val", name))
        glbs += [load_glb(sd.object_mesh(i)) for i in sd.list_crop_ids()
                 if sd.object_mesh(i).exists()]
        depths += sd.depth_map.exists()
        if sd.bbox3d.exists() and sd.read_bbox3d():
            with_boxes.add(name)
    res["glbs"], res["empty_glbs"] = len(glbs), sum(m.is_empty for m in glbs)
    with open(os.path.join(out_dir, "COCO3D_val.json")) as f:
        listed = {os.path.basename(im["file_path"]).rsplit(".", 1)[0]
                  for im in json.load(f)["images"]}
    res["scenes_with_boxes"], res["coco3d_images"] = sorted(with_boxes), sorted(listed)
    res["stages_2_to_5"] = check_sd_route_outputs(out_dir, loader)
    k1, k2 = trellis_launches(stages["reconstruction"].cfg)
    n = res["glbs"]
    elev = matcher_launches(est.matcher_cfg, res["elevation_forwards"])
    layout = matcher_launches(matcher.cfg, res["forwards"])
    depth_k1 = (-(-SD_IMAGES // cfg.batch_size)
                * (backend.moge_cfg.backbone.depth + backend.dp_cfg.backbone.depth))
    res["want"] = {"k1": depth_k1 + k1 * n + elev["k1"] + layout["k1"],
                   "k2": k2 * n + elev["k2"] + layout["k2"],
                   "k3": elev["k3"] + layout["k3"], "k4": 0}
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and not res["failures"] and n == SD_IMAGES * SD_INSTANCES
                 and res["elevation_forwards"] == 4 * n
                 and k3_launches(res["k3_by_shape"], 1, ELEVATION_STARTS) == elev["k3"]
                 and depths == SD_IMAGES and with_boxes == listed
                 and res["stages_2_to_5"]["ok"])
    del stages, backend, matcher, est
    torch.cuda.empty_cache()
    return res


def sd_card_vs_cpu(seed: int = 70) -> dict:
    """Phase 12(d): the tiny SD configs in float32 with seeded
    released-layout weights (through the converters) on the card and on the
    CPU, from the same inputs and draws: a UNet forward (8 input channels),
    a VAE encode and decode, one amodal completion and one Zero123 view at
    the tiny factories' 64 px. Relative L2 of each, of the two samplers'
    float images before their 8-bit truncation, the largest 8-bit
    difference, and the card's images' spread and saturated share."""
    import dataclasses

    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.clip import CLIPVisionConfig, convert_clip_text
    from labelany3d_tpu_torch.models.diffusion import (
        AmodalCompletion,
        TextConditioner,
        UNet2D,
        UNetConfig,
        Zero123NovelView,
    )
    from labelany3d_tpu_torch.models.diffusion.convert import (
        convert_sd_unet,
        convert_sd_vae,
        convert_zero123,
    )
    from labelany3d_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
    from labelany3d_tpu_torch.models.weights import flax_to_state_dict

    f32 = torch.float32
    ucfg = UNetConfig.tiny_test(dtype=f32, in_channels=8)
    vcfg = VAEConfig.tiny_test(dtype=f32)
    state4 = released_sd_unet_state(dataclasses.replace(ucfg, in_channels=4), seed, std=0.1)
    unet = convert_sd_unet(with_conv_in(state4, 8, seed + 1), ucfg)
    vae = convert_sd_vae(released_sd_vae_state(vcfg, seed + 2, std=0.1), vcfg)
    tcfg = TextConditioner.for_context_dim(ucfg.context_dim, device="cpu").cfg
    text = convert_clip_text(released_clip_text_state(tcfg, seed + 3, std=0.1), tcfg)
    viscfg = CLIPVisionConfig.tiny_test()
    z = convert_zero123(None, vision_state=released_clip_vision_state(viscfg, seed + 4, std=0.1),
                        cc_state=released_cc_state(viscfg.projection_dim, ucfg.context_dim,
                                                   seed + 5, std=0.1), vision_cfg=viscfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 8)).astype(np.float32))
    t = torch.tensor([0.3, 0.9])
    ctx = torch.from_numpy(rng.standard_normal((2, 5, ucfg.context_dim)).astype(np.float32))
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    crop = trellis_crop(seed, 96)
    noise = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    out = {}

    def recording_decode(pipe, key):
        """`pipe` with its VAE decode recording the float image it returns,
        before the pipeline clamps it and truncates it to 8 bits."""
        pipe.init_params()
        dec = pipe.vae.decode

        def decode(z):
            y = dec(z)
            out[d][key] = y.float().cpu()
            return y

        pipe.vae.decode = decode
        return pipe

    for d in ("cpu", "cuda"):
        with torch.device(d):
            um, vm = UNet2D(ucfg), AutoencoderKL(vcfg)
        um.load_state_dict(flax_to_state_dict(unet, um))
        vm.load_state_dict(flax_to_state_dict(vae, vm))
        with torch.inference_mode():
            out[d] = {"unet": um(x.to(d), t.to(d), ctx.to(d)),
                      "vae": vm.decode(vm.encode(img.to(d)))}
        comp = recording_decode(AmodalCompletion(tiny=True, image_size=64, device=d, dtype=f32)
                                .set_params({"unet": unet, "vae": vae, "text": text}),
                                "complete_float")
        out[d]["complete"] = torch.from_numpy(comp.complete(crop, "chair", noise=noise))
        nv = recording_decode(Zero123NovelView(tiny=True, image_size=64, device=d, dtype=f32)
                              .set_params({"unet": unet, "vae": vae, **z}), "generate_float")
        out[d]["generate"] = torch.from_numpy(nv.generate(crop, 10.0, -10.0, noise=noise))
    res = {}
    for name in ("unet", "vae", "complete", "generate", "complete_float", "generate_float"):
        a, b = out["cuda"][name].float().cpu(), out["cpu"][name].float()
        res[name] = float((a - b).norm() / b.norm())
        if name in ("complete", "generate"):
            res[f"{name}_max_levels"] = float((a - b).abs().max())
            # The card's 8-bit RGB must have content: a clamped or flat image
            # would agree with the CPU's whatever the port computed.
            rgb = a[..., :3]
            res[f"{name}_std_levels"] = float(rgb.std())
            res[f"{name}_saturated_share"] = float(((rgb == 0) | (rgb == 255)).float().mean())
    res["ok"] = (res["unet"] <= SD_REL_TOL and res["vae"] <= SD_REL_TOL
                 and res["complete"] <= SD_IMAGE_REL_TOL and res["generate"] <= SD_IMAGE_REL_TOL
                 and res["complete_float"] <= SD_SAMPLE_REL_TOL
                 and res["generate_float"] <= SD_SAMPLE_REL_TOL
                 and all(res[f"{n}_std_levels"] >= SD_MIN_STD_LEVELS
                         and res[f"{n}_saturated_share"] <= SD_MAX_SATURATED
                         for n in ("complete", "generate")))
    return res


def run_sd(tmp: str) -> dict:
    """Phase 12: weights, (b) the components, (c) the reference route, (d)
    card against CPU; prints each part's lines ((a), the kernels at head
    dim 32, is in phases 3 and 4). Returns the three results."""
    t0 = time.perf_counter()
    trees, n_params = sd_weights()
    _say("sd:weights", s=time.perf_counter() - t0, parameters=n_params)
    comp = run_sd_components(trees)
    del trees
    _say("sd:components", init_s=comp["init_s"], cold_s=json.dumps(comp["cold_s"]),
         warm_s=json.dumps(comp["warm_s"]), launches=json.dumps(comp["launches"]),
         want=json.dumps(comp["want"]), plain_calls=json.dumps(comp["plain_calls"]),
         k3_launches_by_shape=k3_shapes_json(comp["k3_by_shape"]),
         shapes=json.dumps(comp["shapes"]), elevation=comp["elevation"],
         max_memory_gb=comp["max_memory_gb"])
    p = comp["profile"]
    _say("sd:profile", pass_s=comp["pass_s"], device_ms=p["device_ms"],
         traced_wall_ms=p["wall_ms"], k1_device_ms=p["k1_ms"], k2_device_ms=p["k2_ms"],
         k3_device_ms=p["k3_ms"], idle_share_of_warm_pass=comp["idle_share"],
         top_device=json.dumps(p["top_device"]),
         unet_forward_by_op_ms=json.dumps(p["unet_forward_by_op_ms"]))
    if not comp["ok"]:
        raise SystemExit("sd components: launches, plain calls, shapes or the elevation are "
                         "not as required (see sd:components)")
    route = run_reference_route(tmp)
    _say("sd:route", s=route["s"], stage_s=json.dumps(route["stage_s"]),
         launches=json.dumps(route["launches"]), want=json.dumps(route["want"]),
         plain_calls=json.dumps(route["plain_calls"]), failures=json.dumps(route["failures"]),
         glbs=route["glbs"], empty_glbs=route["empty_glbs"], forwards=route["forwards"],
         elevation_forwards=route["elevation_forwards"],
         k3_launches_by_shape=k3_shapes_json(route["k3_by_shape"]),
         stages_2_to_5=json.dumps(route["stages_2_to_5"]),
         scenes_with_boxes=json.dumps(route["scenes_with_boxes"]),
         coco3d_images=json.dumps(route["coco3d_images"]), max_memory_gb=route["max_memory_gb"],
         max_memory_gb_before_unloading=SD_ROUTE_PEAK_KEPT_GB,
         stage_peak_gb=json.dumps(route["stage_peak_gb"]),
         allocated_after_gb=route["allocated_after_gb"])
    if not route["ok"]:
        raise SystemExit("reference route: launches, plain calls, failures, stage 2-5 "
                         "artifacts, GLBs or COCO3D are not as required (see sd:route)")
    check = sd_card_vs_cpu()
    _say("sd:card_vs_cpu", **check, rel_tol=SD_REL_TOL, image_rel_tol=SD_IMAGE_REL_TOL,
         sample_rel_tol=SD_SAMPLE_REL_TOL, min_std_levels=SD_MIN_STD_LEVELS,
         max_saturated_share=SD_MAX_SATURATED)
    if not check["ok"]:
        raise SystemExit("sd: the card disagrees with the CPU (see sd:card_vs_cpu)")
    return {"components": comp, "route": route, "card_vs_cpu": check}


# Phase 13, Hunyuan3D (stage 6's `hunyuan3d` and `hunyuan3d_carve`): K2 at
# SVRM's shapes is in phase 4; weights in the releases' torch layouts (SVRM's
# svrm.safetensors, the mvd_std diffusers components), the components at
# full width, the `all` route with obj_rec=hunyuan3d, the card against the
# CPU.

# The card against the CPU. SVRM runs K2, which takes bf16 at head dims 32
# and 64, so its check runs a reduced SVRM with heads of 64 in bf16 on both
# (the CPU's plain attention on the same bf16 operands), as phase 11(c) does
# for TRELLIS. SVRM keeps its residual streams in bf16 (as the JAX
# package's), so each residual sum rounds to bf16 (2^-9 to 2^-8 relative) in
# another place on each side: the CPU's own bf16 against its float32 run
# differs by about 9e-3 (`bf16_floor_*`, printed beside). The limit's other
# end is read in every run from faults planted on the card's side
# (`SVRM_FAULTS`): K2 losing the last key tile of every launch that has more
# than one moves the triplanes by about 8e-2, two planes swapped by about
# 0.2, and the check fails if either stays within the limit. The mvd grid
# runs the tiny configs in float32 (plain attention on both): a float32
# difference of 1e-6 carried through 3 Euler-ancestral steps and the VAE.
HY_SVRM_REL_TOL = 2e-2
HY_MVD_REL_TOL = 1e-3
HY_IMAGES = 1              # phase 13(c): 1 image x 2 objects
HY_INSTANCES = 2
HY_VIEW = 512              # a grid tile and a crop
HY_ROUTE_PEAK_KEPT_GB = 35.25  # 13(c)'s peak without unloading (as SD_ROUTE_PEAK_KEPT_GB)


def released_svrm_state(cfg, seed: int = 80, std: float = 0.02,
                        device: str | None = None) -> dict:
    """The released `svrm.safetensors` names and shapes for an `SVRMConfig`
    (`img_encoder.model.*` dinov2 with AdaNorm, `img_to_triplane_decoder.*`,
    `render.decoder.net.*`)."""
    st = SyntheticState(seed, std, device)
    e, w, pg = "img_encoder.model.", cfg.enc_width, cfg.enc_pos_grid
    st.linear(e + "cam_embed.0.", cfg.cam_dim, w)
    st.linear(e + "cam_embed.2.", w, w)
    st.conv(e + "patch_embed.proj.", 3, w, cfg.enc_patch)
    st.rand(e + "pos_embed", 1, 1 + pg * pg, w)
    st.rand(e + "cls_token", 1, 1, w)
    for i in range(cfg.enc_depth):
        b = f"{e}blocks.{i}."
        st.linear(b + "norm1.adaLN_modulation.1.", w, 2 * w)
        st.linear(b + "attn.qkv.", w, 3 * w)
        st.linear(b + "attn.proj.", w, w)
        st.const(b + "ls1.gamma", cfg.layerscale_init, w)
        st.linear(b + "norm2.adaLN_modulation.1.", w, 2 * w)
        st.linear(b + "mlp.fc1.", w, 4 * w)
        st.linear(b + "mlp.fc2.", 4 * w, w)
        st.const(b + "ls2.gamma", cfg.layerscale_init, w)
    st.linear(e + "norm.adaLN_modulation.1.", w, 2 * w)
    d, dim = "img_to_triplane_decoder.", cfg.token_dim
    st.rand(d + "pos_emb", 1, 3 * cfg.plane_size ** 2, dim)
    for i in range(cfg.depth):
        b = f"{d}img_to_triplane_decoder.transformer_blocks.{i}."
        for n in (1, 2, 3):
            st.norm(b + f"norm{n}.", dim)
        for a, kv in (("attn1.", cfg.context_dim), ("attn2.", dim)):
            st.rand(b + a + "to_q.weight", dim, dim)
            st.rand(b + a + "to_k.weight", dim, kv)
            st.rand(b + a + "to_v.weight", dim, kv)
            st.linear(b + a + "to_out.0.", dim, dim)
        st.linear(b + "ff.net.0.proj.", dim, 8 * dim)
        st.linear(b + "ff.net.2.", 4 * dim, dim)
    st.norm(d + "img_to_triplane_decoder.norm.", dim)
    st.linear(d + "upsampler.", dim, cfg.triplane_dim * cfg.upsample_ratio ** 2)
    n_in = 3 * cfg.triplane_dim
    for i in range(cfg.field_layers - 1):
        st.linear(f"render.decoder.net.{2 * i}.", n_in, cfg.field_hidden)
        n_in = cfg.field_hidden
    st.linear(f"render.decoder.net.{2 * (cfg.field_layers - 1)}.", n_in, 4)
    return st


def _sdxl_transformer_state(st, pre: str, c: int, ctx: int, depth: int) -> None:
    """A diffusers SDXL Transformer2DModel: linear proj_in/out, `depth` blocks."""
    st.norm(pre + "norm.", c)
    st.linear(pre + "proj_in.", c, c)
    for d in range(depth):
        tb = pre + f"transformer_blocks.{d}."
        for i, kv in ((1, c), (2, ctx)):
            st.norm(tb + f"norm{i}.", c)
            st.rand(tb + f"attn{i}.to_q.weight", c, c)
            st.rand(tb + f"attn{i}.to_k.weight", c, kv)
            st.rand(tb + f"attn{i}.to_v.weight", c, kv)
            st.linear(tb + f"attn{i}.to_out.0.", c, c)
        st.norm(tb + "norm3.", c)
        st.linear(tb + "ff.net.0.proj.", c, 8 * c)
        st.linear(tb + "ff.net.2.", 4 * c, c)
    st.linear(pre + "proj_out.", c, c)


def released_mvd_unet_state(cfg, seed: int = 81, std: float = 0.02,
                            device: str | None = None) -> dict:
    """A diffusers SDXL `UNet2DConditionModel` release (Hunyuan3D's
    `weights/mvd_std/unet`) for an `MVDUNetConfig`."""
    st = SyntheticState(seed, std, device)
    ws, nrb, ctx = list(cfg.widths), cfg.num_res_blocks, cfg.context_dim
    tdim, depth = 4 * ws[0], cfg.transformer_depth
    st.conv("conv_in.", cfg.in_channels, ws[0], 3)
    st.linear("time_embedding.linear_1.", ws[0], tdim)
    st.linear("time_embedding.linear_2.", tdim, tdim)
    st.linear("add_embedding.linear_1.", cfg.pooled_dim + 6 * cfg.addition_time_embed_dim, tdim)
    st.linear("add_embedding.linear_2.", tdim, tdim)
    skips, c = [ws[0]], ws[0]
    for lvl, w in enumerate(ws):
        for i in range(nrb):
            _sd_resnet_state(st, f"down_blocks.{lvl}.resnets.{i}.", c, w, tdim)
            c = w
            if lvl in cfg.attn_levels:
                _sdxl_transformer_state(st, f"down_blocks.{lvl}.attentions.{i}.", c, ctx,
                                        depth[lvl])
            skips.append(c)
        if lvl < len(ws) - 1:
            st.conv(f"down_blocks.{lvl}.downsamplers.0.conv.", c, c, 3)
            skips.append(c)
    _sd_resnet_state(st, "mid_block.resnets.0.", c, c, tdim)
    _sdxl_transformer_state(st, "mid_block.attentions.0.", c, ctx, depth[-1])
    _sd_resnet_state(st, "mid_block.resnets.1.", c, c, tdim)
    for u in range(len(ws)):
        lvl = len(ws) - 1 - u
        for i in range(nrb + 1):
            _sd_resnet_state(st, f"up_blocks.{u}.resnets.{i}.", c + skips.pop(), ws[lvl], tdim)
            c = ws[lvl]
            if lvl in cfg.attn_levels:
                _sdxl_transformer_state(st, f"up_blocks.{u}.attentions.{i}.", c, ctx, depth[lvl])
        if lvl > 0:
            st.conv(f"up_blocks.{u}.upsamplers.0.conv.", c, c, 3)
    st.norm("conv_norm_out.", c)
    st.conv("conv_out.", c, cfg.out_channels, 3)
    return st


def install_hunyuan_weights(mv, svrm_cfg, seed: int = 80) -> tuple[dict, int]:
    """Seeded released-layout state dicts of every Hunyuan3D component,
    drawn on the card, through the port's converters: the mvd_std UNet,
    VAE, ViT-L/14 and ViT-bigG/14 towers, text embeddings and ramp,
    installed into the `MVDStdViews` `mv` one component at a time (each
    state freed before the next is made), and SVRM's tree, returned.
    Returns the SVRM tree and the parameters made."""
    std, device = 0.02, "cuda"
    import numpy as np

    from labelany3d_tpu_torch.models.diffusion.convert import convert_mvd
    from labelany3d_tpu_torch.models.svrm import convert_svrm

    n = 0
    for key, make in (
            ("unet_state", lambda: released_mvd_unet_state(mv.unet_cfg, seed + 1, std, device)),
            ("vae_state", lambda: released_sd_vae_state(mv.vae_cfg, seed + 2, std, device)),
            ("vision_state", lambda: released_clip_vision_state(mv.vision_cfgs[0], seed + 3,
                                                                std, device)),
            ("vision2_state", lambda: released_clip_vision_state(mv.vision_cfgs[1], seed + 4,
                                                                 std, device))):
        state = make()
        n += sum(v.size for v in state.values())
        mv.set_params(convert_mvd(**{key: state}, unet_cfg=mv.unet_cfg, vae_cfg=mv.vae_cfg,
                                  vision_cfg=mv.vision_cfgs[0], vision2_cfg=mv.vision_cfgs[1]))
        del state
    rng = np.random.default_rng(seed + 5)
    ctx, pooled = mv.unet_cfg.context_dim, mv.unet_cfg.pooled_dim
    mv.set_params(convert_mvd(
        uc_text_emb=rng.standard_normal((1, 77, ctx), dtype=np.float32),
        uc_text_emb_2=rng.standard_normal((1, pooled), dtype=np.float32),
        ramping_coefficients=np.linspace(0.0, 1.0, 77, dtype=np.float32)))
    state = released_svrm_state(svrm_cfg, seed, std, device)
    n += sum(v.size for v in state.values())
    return convert_svrm(state, svrm_cfg), n


def mvd_ref_count(cfg) -> int:
    """Transformer blocks of an `MVDUNet`: the tokens a write pass records."""
    d = cfg.transformer_depth
    return (sum((2 * cfg.num_res_blocks + 1) * d[lvl] for lvl in cfg.attn_levels)
            + d[-1])


def svrm_k2_launches(cfg) -> int:
    """K2 launches of one `SVRM` forward: each encoder block's
    self-attention, each LRM block's cross- and self-attention."""
    return cfg.enc_depth + 2 * cfg.depth


def run_hunyuan_components() -> dict:
    """Phase 13(b): the Hunyuan3D components at the released widths with
    seeded released-layout weights, each call cold (its first) and warm
    between CUDA syncs: `MVDStdViews.generate_views` (50 steps), one
    `MVDUNet` write forward (both reference rows at 64^2) and one read
    forward (both CFG rows of the 192x128 grid latent), `CamModViT` on the
    7 views, the triplane decoder, `SVRM.grid` at G = 96,
    `marching_cubes_mesh`, `SVRMReconstruction.reconstruct` with the
    generated views served from the pipeline's cache, and `SpaceCarveReconstruction.reconstruct`
    over Zero123 views (its factory's default init); K2 launches per
    `reconstruct`; a traced warm `reconstruct` and sampler step."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.diffusion import MVDStdViews
    from labelany3d_tpu_torch.models.svrm import SVRMConfig, SVRMReconstruction
    from labelany3d_tpu_torch.ops.marching_cubes import marching_cubes_mesh
    from labelany3d_tpu_torch.pipeline.backends import make_reconstruction

    counters, plains = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mv = MVDStdViews(device="cuda")
    svrm_cfg = SVRMConfig()
    svrm_tree, n_params = install_hunyuan_weights(mv, svrm_cfg)
    recon = SVRMReconstruction(cfg=svrm_cfg, params=svrm_tree, device="cuda")
    model = recon._ensure()
    del svrm_tree
    torch.cuda.synchronize()
    res = {"weights_s": time.perf_counter() - t0, "parameters": n_params,
           "cold_s": {}, "warm_s": {}}
    crop = trellis_crop(13, HY_VIEW)
    outs = {}

    def timed(name, fn):
        for phase in ("cold_s", "warm_s"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.inference_mode():
                outs[name] = fn()
            torch.cuda.synchronize()
            res[phase][name] = time.perf_counter() - t

    # Through `generate`, whose uncached call runs `generate_views` once:
    # each pass asks for its own seed, so neither is served from the cache,
    # and the warm one (seed 0, as `reconstruct` asks) leaves its views there.
    seeds = iter((1, 0))
    timed("generate_views", lambda: mv.generate(crop, 0.0, 0.0, seed=next(seeds)))
    views = [mv.generate(crop, 0.0, azim) for azim in range(0, 360, 60)]
    # One sampler step's two UNet passes at the path's shapes.
    lf, mcfg = mv.latent_factor, mv.cfg
    with torch.inference_mode():
        from labelany3d_tpu_torch.models.layers import resize_bicubic_8bit, white_composite

        rgb = torch.from_numpy(white_composite(crop).copy()).cuda()
        cond = resize_bicubic_8bit(rgb.permute(2, 0, 1)[None],
                                   (mcfg.cond_size,) * 2)[0].permute(1, 2, 0)
        ctx2, pooled2, tid2 = mv.condition(cond)
    ref = torch.randn(2, mcfg.cond_size // lf, mcfg.cond_size // lf, 4, device="cuda")
    lat = torch.randn(2, 3 * mcfg.tile // lf, 2 * mcfg.tile // lf, 4, device="cuda")
    tb = torch.full((2,), 0.5, device="cuda")
    timed("unet_write", lambda: mv.unet(ref, tb, ctx2, pooled2, tid2, mode="write"))
    refs = outs["unet_write"][1]
    timed("unet_read", lambda: mv.unet(lat, tb, ctx2, pooled2, tid2, mode="read", refs=refs))
    res["refs"] = len(refs)

    recon.novel_views = mv
    view_list, cams = recon.views(crop)
    x = recon.preprocess(view_list)[0]
    cams_t = torch.from_numpy(cams).cuda()
    timed("cam_mod_vit", lambda: model.encoder(x, cams_t))
    timed("triplane_decoder", lambda: model.decode(outs["cam_mod_vit"]))
    planes = outs["triplane_decoder"]
    timed("grid", lambda: model.grid(planes[0]))
    sdf, rgb_lat = outs["grid"]
    timed("marching_cubes_mesh", lambda: marching_cubes_mesh(-sdf))
    for k in (*counters.values(), *plains.values()):
        k.reset()
    timed("reconstruct", lambda: recon.reconstruct(crop))
    res["launches"] = {k: v.count for k, v in counters.items()}
    res["plain_calls"] = {k: v.count for k, v in plains.items()}
    # The cold and warm reconstructs: one SVRM forward each.
    res["want"] = {"k1": 0, "k2": 2 * svrm_k2_launches(svrm_cfg), "k3": 0, "k4": 0}
    mesh = outs["reconstruct"]
    res["mesh"] = {"vertices": len(mesh.vertices), "faces": len(mesh.faces),
                   "finite": bool(np.isfinite(mesh.vertices).all())}
    res["sdf"] = {"min": float(sdf.min()), "max": float(sdf.max()),
                  "finite": bool(torch.isfinite(sdf).all())}
    res["planes_shape"] = list(planes.shape)
    views_arr = np.stack(views)
    res["views"] = {"n": len(views), "shape": list(views_arr.shape[1:]),
                    "std_levels": float(views_arr.std())}
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # The traced warm passes: one reconstruct (views from the cache), one
    # sampler step (write pass, read pass, guidance, update).
    def step():
        with torch.inference_mode():
            _, r = mv.unet(ref, tb, ctx2, pooled2, tid2, mode="write")
            e2, _ = mv.unet(lat, tb, ctx2, pooled2, tid2, mode="read", refs=r)
            return e2[:1] + mcfg.guidance * (e2[1:] - e2[:1])

    res["profile"] = {}
    for name, fn in (("reconstruct", lambda: recon.reconstruct(crop)), ("step", step)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pass_ms = (time.perf_counter() - t) * 1e3
        prof = profile_pass(fn, host=False)
        res["profile"][name] = {"pass_ms": pass_ms, "device_ms": prof["device_ms"],
                                "k2_ms": prof["k2_ms"], "top_device": prof["top_device"],
                                "idle_share": (1.0 - prof["device_ms"] / pass_ms
                                               if prof["device_ms"] > 0 else "not measured")}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as read_prof, torch.inference_mode():
        mv.unet(lat, tb, ctx2, pooled2, tid2, mode="read", refs=refs)
        torch.cuda.synchronize()
    res["profile"]["unet_read_by_op_ms"] = device_ms_by_op(read_prof)
    want_refs = mvd_ref_count(mv.unet_cfg)
    del mv, recon, model, outs["unet_write"], outs["unet_read"], refs, planes, sdf, rgb_lat
    torch.cuda.empty_cache()

    carve = make_reconstruction("hunyuan3d_carve", device="cuda")
    timed("carve_reconstruct", lambda: carve.reconstruct(crop))
    cm = outs.pop("carve_reconstruct")
    res["carve_mesh"] = {"vertices": len(cm.vertices), "faces": len(cm.faces)}
    del carve
    torch.cuda.empty_cache()
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and res["mesh"]["finite"] and res["sdf"]["finite"]
                 and res["planes_shape"] == [1, 3, 256, 256, svrm_cfg.triplane_dim]
                 and res["views"]["n"] == 6 and res["views"]["shape"] == [HY_VIEW, HY_VIEW, 3]
                 and res["refs"] == want_refs)
    return res


def run_hunyuan_route(tmp: str) -> dict:
    """Phase 13(c): `run_stages("all", ...)` with run.obj_rec=hunyuan3d (the
    mvd_std views, the reference's view source) over 1 synthetic image with
    2 objects, stages 2, 4 and 5 at their shipping defaults; the mvd_std
    pipeline and SVRM from the factory at their released widths with their
    default (random) initialisation. Depth at the `large` preset, the
    layout's matcher `MatcherConfig()`, `bbox_method=minarea_pallas`."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.data.meshio import load_glb
    from labelany3d_tpu_torch.pipeline.backends import TorchMatcherBackend, default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource

    cfg = PipelineConfig(bbox_method="minarea_pallas")
    loader = SyntheticLoader(HY_IMAGES, IMAGE_HW, seed=13, min_inst=HY_INSTANCES,
                             max_inst=HY_INSTANCES)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    matcher = TorchMatcherBackend(tiny=False, seed=cfg.seed, device="cuda")
    counters, plains = kernel_counters()
    for k in (*counters.values(), *plains.values()):
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    def keep(name, stage):
        """What the phase reads of a finished stage (see StageKeep)."""
        if name == "reconstruction":
            return SimpleNamespace(cfg=stage.backend.cfg,
                                   view_source=type(stage.backend.novel_views).__name__)
        return stage if name == "layout" else None

    out_dir, stages, timer = os.path.join(tmp, "hunyuan_all"), StageKeep(keep), peak_timer()
    t0 = time.perf_counter()
    run_stages("all", cfg, loader, ArrayImageSource(loader.pixels), out_dir, "val", 0,
               HY_IMAGES, backend=backend, matcher=matcher,
               run_options={"obj_rec": "hunyuan3d"}, device="cuda", timer=timer,
               stages=stages)
    torch.cuda.synchronize()
    stages.close()
    recon = stages["reconstruction"]
    res = {"s": time.perf_counter() - t0,
           "stage_s": {k: timer.stats[k].total_seconds for k in ALL_STAGES},
           "launches": {k: v.count for k, v in counters.items()},
           "plain_calls": {k: v.count for k, v in plains.items()},
           "failures": list(stages["layout"].failures), "forwards": matcher.forwards,
           "view_source": recon.view_source,
           "max_memory_gb": max(timer.peaks_gb.values()), "stage_peak_gb": timer.peaks_gb,
           "allocated_after_gb": torch.cuda.memory_allocated() / 1e9}
    meshes, placed, with_boxes, bad = [], 0, set(), []
    for info in loader.images:
        name = scene_dir_name(info["file_name"])
        sd = SceneDir(os.path.join(out_dir, "val", name))
        for i in sd.list_crop_ids():
            if not sd.object_mesh(i).exists():
                bad.append(f"{name}:{i}")
                continue
            m = load_glb(sd.object_mesh(i))
            meshes.append((len(m.vertices), len(m.faces)))
            if not (np.isfinite(m.vertices).all() and (m.faces.size == 0
                    or (m.faces.min() >= 0 and m.faces.max() < len(m.vertices)))):
                bad.append(f"{name}:{i}")
        placed += (sd.root / "reconstruction" / "full_scene.glb").exists()
        if sd.bbox3d.exists() and sd.read_bbox3d():
            with_boxes.add(name)
    with open(os.path.join(out_dir, "COCO3D_val.json")) as f:
        listed = {os.path.basename(im["file_path"]).rsplit(".", 1)[0]
                  for im in json.load(f)["images"]}
    res["meshes"], res["bad_glbs"] = meshes, bad
    res["scenes_with_boxes"], res["coco3d_images"] = sorted(with_boxes), sorted(listed)
    layout = matcher_launches(matcher.cfg, res["forwards"])
    depth_k1 = (-(-HY_IMAGES // cfg.batch_size)
                * (backend.moge_cfg.backbone.depth + backend.dp_cfg.backbone.depth))
    n = len(meshes)
    res["want"] = {"k1": depth_k1 + layout["k1"],
                   "k2": svrm_k2_launches(recon.cfg) * n + layout["k2"],
                   "k3": layout["k3"], "k4": placed}
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and n == HY_IMAGES * HY_INSTANCES and not bad
                 and res["view_source"] == "MVDStdViews" and with_boxes == listed)
    del stages, backend, matcher, recon
    torch.cuda.empty_cache()
    return res


# Faults planted in the card's SVRM for phase 13(d), each read against the
# same CPU run; those marked True must break the limit. `lost_tile_last` (K2
# losing its last key tile in the last LRM self-attention alone, a fault no
# kernel bug makes by itself: both self-attentions have one shape) is read
# and not held, as the limit's blind spot.
SVRM_FAULTS = {"lost_tile_every": True, "lost_tile_last": False, "plane_swap": True}


def svrm_check_config():
    """A reduced SVRM whose attention K2 takes (heads of 64), with a 5^2
    position grid resized to the 4^2 patch grid."""
    import torch

    from labelany3d_tpu_torch.models.svrm import SVRMConfig

    return SVRMConfig(num_views=3, image_size=56, enc_width=128, enc_depth=2, enc_heads=2,
                      enc_pos_grid=5, plane_size=8, token_dim=128, depth=2, num_heads=2,
                      context_dim=128, triplane_dim=8, upsample_ratio=2, field_hidden=16,
                      grid_size=32, dtype=torch.bfloat16)


def hunyuan_card_vs_cpu(seed: int = 90) -> dict:
    """Phase 13(d): SVRM at `svrm_check_config()` in bf16 (K2 on the card,
    the plain attention on the CPU) and the tiny mvd_std pipeline in float32,
    with seeded released-layout weights through the converters, on the card
    and on the CPU from the same inputs and draws: the triplanes, the grid
    sdf, and the mvd grid's float image before its 8-bit step. Relative
    L2; K2 launches on the card; the card's grid's spread in levels; and
    SVRM's bf16 floor, the CPU's bf16 run against its float32 run."""
    import dataclasses

    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.diffusion import MVDStdViews
    from labelany3d_tpu_torch.models.diffusion.convert import convert_mvd
    import labelany3d_tpu_torch.models.svrm as svrm_mod
    from labelany3d_tpu_torch.models.svrm import SVRM, convert_svrm
    from labelany3d_tpu_torch.models.weights import build_module

    cfg = svrm_check_config()
    tree = convert_svrm(released_svrm_state(cfg, seed, std=0.05), cfg)
    rng = np.random.default_rng(seed)
    views = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_views, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    cams = torch.from_numpy(rng.standard_normal((1, cfg.num_views, cfg.cam_dim))
                            .astype(np.float32))
    counters, plains = kernel_counters()
    n_k2, tile = svrm_k2_launches(cfg), 128  # K2's keys per tile

    def svrm_run(d, c, fault=None):
        calls = []

        def planted(q, k, v, *rest):
            calls.append(None)
            cut = (k.shape[1] - 1) // tile * tile
            if (fault == "lost_tile_every" and cut) or (fault == "lost_tile_last"
                                                        and len(calls) == n_k2):
                k, v = k[:, :cut], v[:, :cut]
            return real(q, k, v, *rest)

        model = build_module(lambda: SVRM(c), torch.device(d), tree, 0)
        real, svrm_mod.flash_sdpa = svrm_mod.flash_sdpa, planted
        try:
            with torch.inference_mode():
                planes = model(views.to(d), cams.to(d))
                if fault == "plane_swap":
                    planes = planes[:, [0, 2, 1]]
                sdf, _ = model.grid(planes[0])
        finally:
            svrm_mod.flash_sdpa = real
        return {"planes": planes.float().cpu(), "sdf": sdf.float().cpu()}

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    out = {}
    for d, c in (("cpu", cfg), ("cuda", cfg), ("cpu_f32", dataclasses.replace(
            cfg, dtype=torch.float32))):
        for k in (*counters.values(), *plains.values()):
            k.reset()
        out[d] = svrm_run(d.split("_")[0], c)
        out[d]["k2"] = (counters["k2"].count, plains["k2"].count)
    res = {"k2_launches": out["cuda"]["k2"][0], "k2_plain_calls": out["cuda"]["k2"][1]}
    for name in ("planes", "sdf"):
        res[f"bf16_floor_{name}"] = rel(out["cpu"][name], out["cpu_f32"][name])
    caught = []
    for fault, held in SVRM_FAULTS.items():
        f = svrm_run("cuda", cfg, fault)
        r = {n: rel(f[n], out["cpu"][n]) for n in ("planes", "sdf")}
        res[f"fault_{fault}"] = json.dumps(r)
        if held:
            caught.append(max(r.values()) > HY_SVRM_REL_TOL)

    mvs = {d: MVDStdViews(tiny=True, device=d, dtype=torch.float32) for d in ("cpu", "cuda")}
    mv = mvs["cpu"]
    trees = convert_mvd(
        released_mvd_unet_state(mv.unet_cfg, seed + 1, std=0.1),
        released_sd_vae_state(mv.vae_cfg, seed + 2, std=0.1),
        released_clip_vision_state(mv.vision_cfgs[0], seed + 3, std=0.1),
        released_clip_vision_state(mv.vision_cfgs[1], seed + 4, std=0.1),
        uc_text_emb=rng.standard_normal((1, 77, mv.unet_cfg.context_dim)).astype(np.float32),
        uc_text_emb_2=rng.standard_normal((1, mv.unet_cfg.pooled_dim)).astype(np.float32),
        ramping_coefficients=np.linspace(0.0, 1.0, 77, dtype=np.float32),
        unet_cfg=mv.unet_cfg, vae_cfg=mv.vae_cfg, vision_cfg=mv.vision_cfgs[0],
        vision2_cfg=mv.vision_cfgs[1])
    noise = {k: rng.standard_normal(s).astype(np.float32) for k, s in mv.draw_shapes().items()}
    crop = trellis_crop(seed, 64)
    for d, p in mvs.items():
        p.set_params(trees)
        out[d]["grid"] = p.generate_grid(crop, noise=noise).float().cpu()
    for name in ("planes", "sdf", "grid"):
        res[name] = rel(out["cuda"][name], out["cpu"][name])
    res["grid_std_levels"] = float(out["cuda"]["grid"].std() * 255)
    res["k2_want"] = svrm_k2_launches(cfg)
    res["ok"] = (res["planes"] <= HY_SVRM_REL_TOL and res["sdf"] <= HY_SVRM_REL_TOL
                 and res["grid"] <= HY_MVD_REL_TOL and res["grid_std_levels"] >= SD_MIN_STD_LEVELS
                 and res["k2_launches"] == res["k2_want"] and res["k2_plain_calls"] == 0
                 and all(caught))
    return res


def run_hunyuan(tmp: str) -> dict:
    """Phase 13: (b) weights and the components, (c) the route, (d) card
    against CPU; prints each part's lines ((a), K2 at SVRM's shapes, is in
    phase 4). Returns the three results."""
    comp = run_hunyuan_components()
    _say("hunyuan:weights", s=comp["weights_s"], parameters=comp["parameters"])
    _say("hunyuan:components", cold_s=json.dumps(comp["cold_s"]),
         warm_s=json.dumps(comp["warm_s"]), launches=json.dumps(comp["launches"]),
         want=json.dumps(comp["want"]), plain_calls=json.dumps(comp["plain_calls"]),
         refs=comp["refs"], mesh=json.dumps(comp["mesh"]), sdf=json.dumps(comp["sdf"]),
         views=json.dumps(comp["views"]), carve_mesh=json.dumps(comp["carve_mesh"]),
         max_memory_gb=comp["max_memory_gb"])
    p = comp["profile"]
    _say("hunyuan:profile", reconstruct=json.dumps(p["reconstruct"]),
         step=json.dumps(p["step"]), unet_read_by_op_ms=json.dumps(p["unet_read_by_op_ms"]))
    if not comp["ok"]:
        raise SystemExit("hunyuan components: launches, plain calls, shapes or the mesh are "
                         "not as required (see hunyuan:components)")
    route = run_hunyuan_route(tmp)
    _say("hunyuan:route", s=route["s"], stage_s=json.dumps(route["stage_s"]),
         launches=json.dumps(route["launches"]), want=json.dumps(route["want"]),
         plain_calls=json.dumps(route["plain_calls"]), failures=json.dumps(route["failures"]),
         forwards=route["forwards"], view_source=route["view_source"],
         meshes=json.dumps(route["meshes"]), bad_glbs=json.dumps(route["bad_glbs"]),
         scenes_with_boxes=json.dumps(route["scenes_with_boxes"]),
         coco3d_images=json.dumps(route["coco3d_images"]), max_memory_gb=route["max_memory_gb"],
         max_memory_gb_before_unloading=HY_ROUTE_PEAK_KEPT_GB,
         stage_peak_gb=json.dumps(route["stage_peak_gb"]),
         allocated_after_gb=route["allocated_after_gb"])
    if not route["ok"]:
        raise SystemExit("hunyuan route: launches, plain calls, GLBs or COCO3D are not as "
                         "required (see hunyuan:route)")
    check = hunyuan_card_vs_cpu()
    _say("hunyuan:card_vs_cpu", **check, svrm_rel_tol=HY_SVRM_REL_TOL,
         mvd_rel_tol=HY_MVD_REL_TOL, min_std_levels=SD_MIN_STD_LEVELS)
    if not check["ok"]:
        raise SystemExit("hunyuan: the card disagrees with the CPU (see hunyuan:card_vs_cpu)")
    return {"components": comp, "route": route, "card_vs_cpu": check}


def released_sam_state(cfg, seed: int = 100, std: float = 0.02,
                       device: str | None = None) -> dict:
    """A `transformers` `SamModel` state dict's names and shapes
    (facebook/sam-vit-*) for a `SamConfig`: `vision_encoder.*` (windowed and
    global blocks with their relative-position tables), `prompt_encoder.*`,
    `mask_decoder.*`, `shared_image_embedding.*`."""
    st = SyntheticState(seed, std, device)
    ve, w, g = "vision_encoder.", cfg.width, cfg.grid
    hd, hid = cfg.width // cfg.num_heads, int(cfg.width * cfg.mlp_ratio)
    st.conv(ve + "patch_embed.projection.", 3, w, cfg.patch_size)
    st.rand(ve + "pos_embed", 1, g, g, w)
    for i in range(cfg.depth):
        b = f"{ve}layers.{i}."
        size = g if i in cfg.global_attn_indexes else cfg.window_size
        st.norm(b + "layer_norm1.", w)
        st.norm(b + "layer_norm2.", w)
        st.linear(b + "attn.qkv.", w, 3 * w)
        st.linear(b + "attn.proj.", w, w)
        st.rand(b + "attn.rel_pos_h", 2 * size - 1, hd)
        st.rand(b + "attn.rel_pos_w", 2 * size - 1, hd)
        st.linear(b + "mlp.lin1.", w, hid)
        st.linear(b + "mlp.lin2.", hid, w)
    c, pd = cfg.out_channels, cfg.prompt_dim
    st.conv(ve + "neck.conv1.", w, c, 1, bias=False)
    st.norm(ve + "neck.layer_norm1.", c)
    st.conv(ve + "neck.conv2.", c, c, 3, bias=False)
    st.norm(ve + "neck.layer_norm2.", c)
    st.rand("shared_image_embedding.positional_embedding", 2, cfg.num_pos_feats)
    for i in range(4):
        st.rand(f"prompt_encoder.point_embed.{i}.weight", 1, pd)
    st.rand("prompt_encoder.not_a_point_embed.weight", 1, pd)
    st.rand("prompt_encoder.no_mask_embed.weight", 1, pd)

    def attn(pre, inner):
        for n in ("q_proj", "k_proj", "v_proj"):
            st.linear(f"{pre}.{n}.", pd, inner)
        st.linear(f"{pre}.out_proj.", inner, pd)

    md, m = "mask_decoder.", cfg.num_multimask_outputs + 1
    inner = pd // cfg.attention_downsample_rate
    for i in range(cfg.decoder_depth):
        b = f"{md}transformer.layers.{i}"
        attn(b + ".self_attn", pd)
        attn(b + ".cross_attn_token_to_image", inner)
        attn(b + ".cross_attn_image_to_token", inner)
        for j in range(1, 5):
            st.norm(f"{b}.layer_norm{j}.", pd)
        st.linear(b + ".mlp.lin1.", pd, cfg.decoder_mlp_dim)
        st.linear(b + ".mlp.lin2.", cfg.decoder_mlp_dim, pd)
    attn(md + "transformer.final_attn_token_to_image", inner)
    st.norm(md + "transformer.layer_norm_final_attn.", pd)
    st.rand(md + "iou_token.weight", 1, pd)
    st.rand(md + "mask_tokens.weight", m, pd)
    st.deconv(md + "upscale_conv1.", c, c // 4, 2)
    st.norm(md + "upscale_layer_norm.", c // 4)
    st.deconv(md + "upscale_conv2.", c // 4, c // 8, 2)
    for i in range(m):
        h = f"{md}output_hypernetworks_mlps.{i}."
        st.linear(h + "proj_in.", pd, pd)
        st.linear(h + "layers.0.", pd, pd)
        st.linear(h + "proj_out.", pd, c // 8)
    h, ih = md + "iou_prediction_head.", cfg.iou_head_hidden_dim
    st.linear(h + "proj_in.", pd, ih)
    for i in range(cfg.iou_head_depth - 2):
        st.linear(f"{h}layers.{i}.", ih, ih)
    st.linear(h + "proj_out.", ih, m)
    return st


def released_segformer_state(cfg, seed: int = 101, std: float = 0.02,
                             device: str | None = None) -> dict:
    """A `transformers` `SegformerForSemanticSegmentation` state dict's names
    and shapes (nvidia/segformer-b*-finetuned-ade-512-512) for a
    `SegFormerConfig`, its decode head's BatchNorm at mean 0, variance 1."""
    st = SyntheticState(seed, std, device)
    enc, c_in = "segformer.encoder.", 3
    for i, c in enumerate(cfg.hidden_sizes):
        st.conv(f"{enc}patch_embeddings.{i}.proj.", c_in, c, cfg.patch_sizes[i])
        st.norm(f"{enc}patch_embeddings.{i}.layer_norm.", c)
        hid = c * cfg.mlp_ratios[i]
        for j in range(cfg.depths[i]):
            b = f"{enc}block.{i}.{j}."
            st.norm(b + "layer_norm_1.", c)
            st.norm(b + "layer_norm_2.", c)
            for n in ("query", "key", "value"):
                st.linear(f"{b}attention.self.{n}.", c, c)
            st.linear(b + "attention.output.dense.", c, c)
            if cfg.sr_ratios[i] > 1:
                st.conv(b + "attention.self.sr.", c, c, cfg.sr_ratios[i])
                st.norm(b + "attention.self.layer_norm.", c)
            st.linear(b + "mlp.dense1.", c, hid)
            st.rand(b + "mlp.dwconv.dwconv.weight", hid, 1, 3, 3)
            st.const(b + "mlp.dwconv.dwconv.bias", 0.0, hid)
            st.linear(b + "mlp.dense2.", hid, c)
        st.norm(f"{enc}layer_norm.{i}.", c)
        c_in = c
    d = cfg.decoder_hidden
    for i, c in enumerate(cfg.hidden_sizes):
        st.linear(f"decode_head.linear_c.{i}.proj.", c, d)
    st.conv("decode_head.linear_fuse.", len(cfg.hidden_sizes) * d, d, 1, bias=False)
    st.norm("decode_head.batch_norm.", d)
    st.const("decode_head.batch_norm.running_mean", 0.0, d)
    st.const("decode_head.batch_norm.running_var", 1.0, d)
    st.conv("decode_head.classifier.", d, cfg.num_labels, 1)
    return st


# Phase 14, wild mode: SAM ViT-B at 1024^2 and SegFormer-B0 at 512^2 with
# weights drawn in the released layouts at WILD_STD and converted. At the
# other phases' 0.02 SAM's largest mask logit is 0.022, so no mask passes
# the stability filter and the route would have no instance; at 0.2 it is
# 319 and 63 of 64 masks pass (scripts/wild_mode_checks.py, NVIDIA H100
# 80GB HBM3, 700 W).
WILD_STD = 0.2
WILD_POINTS = 8                 # SamSegmentation's points_per_side
WILD_PROMPTS = 64               # one decoder call: SamAutoSegmentation's prompt_chunk
WILD_SURFACE_POINTS = 4096
WILD_CLI_IMAGES = 4
# The route's source, relaxed as the JAX package's own tests relax it
# (tests/test_wild.py:85-88): random weights predict no meaningful IoU.
WILD_RELAXED = {"pred_iou_thresh": -1e9, "min_area_frac": 0.0}
# 14(d), the card against the CPU in float32 with TF32 off: relative L2,
# argmax agreement as a share of pixels. Its weights are drawn at the other
# phases' 0.02: at WILD_STD SAM's attention saturates (scores in the
# hundreds) and the float32 rounding of the two devices alone moves the
# logits by 3.2e-4, where at 0.02 it moves them by 1.7e-6
# (scripts/wild_mode_checks.py, NVIDIA H100 80GB HBM3, 700 W). The limits
# sit 6 to 12x over the readings at 0.02; the planted fault (the global
# block's rel-pos tables zeroed) reads 9.8e-4 on the mask logits.
WILD_CHECK_STD = 0.02
WILD_SAM_REL_TOL = 1e-5
WILD_SEGFORMER_REL_TOL = 1e-5
WILD_ARGMAX_MIN = 0.999
WILD_BG_REL_TOL = 1e-4


def wild_weights(device: str = "cuda") -> tuple[dict, dict]:
    """Phase 14's SAM ViT-B and SegFormer-B0 trees: released-layout state
    dicts drawn on `device` at WILD_STD, through the port's converters."""
    from labelany3d_tpu_torch.models.sam import SamConfig, convert_sam
    from labelany3d_tpu_torch.models.segformer import SegFormerConfig, convert_segformer

    sam = released_sam_state(SamConfig.vit_base(), std=WILD_STD, device=device)
    seg = released_segformer_state(SegFormerConfig.b0(), std=WILD_STD, device=device)
    n = {"sam": sum(v.size for v in sam.values()), "segformer": sum(v.size for v in seg.values())}
    return {"sam": convert_sam(sam, SamConfig.vit_base()),
            "segformer": convert_segformer(seg, SegFormerConfig.b0())}, n


def wild_surface_points(seed: int = 0, n: int = WILD_SURFACE_POINTS):
    """A room's floor and two walls, 2 m across, with 1 cm of noise: the
    background the SDF closes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    which = rng.integers(0, 3, n)
    u, v = rng.uniform(-1.0, 1.0, (2, n))
    one = np.ones(n)
    pts = np.select([which[:, None] == 0, which[:, None] == 1],
                    [np.stack([u, -one, v], -1), np.stack([u, v, one], -1)],
                    np.stack([-one, u, v], -1))
    return (pts + rng.normal(0.0, 0.01, pts.shape)).astype(np.float32)


class CountingSegmentation:
    """`SamSegmentation` at WILD_RELAXED that also counts, from the same
    forwards, the masks the shipping thresholds would keep (both capped at
    `max_instances`, as `SamSegmentation` caps them)."""

    def __init__(self, params, device: str = "cuda", max_instances: int = 16):
        import threading

        from labelany3d_tpu_torch.models.sam import SamAutoSegmentation, SamConfig

        self.relaxed = SamAutoSegmentation(SamConfig.vit_base(), params=params,
                                           points_per_side=WILD_POINTS, device=device,
                                           **WILD_RELAXED)
        self.shipping = SamAutoSegmentation(SamConfig.vit_base(), points_per_side=WILD_POINTS,
                                            device=device)  # its thresholds only
        self.max_instances = max_instances
        self.kept, self.kept_at_shipping = [], []
        self._lock = threading.Lock()

    def segment(self, image):
        import numpy as np

        logits, iou = self.relaxed.decode_grid(image)
        masks = self.relaxed.select(logits, iou, image.shape[:2])[:self.max_instances]
        shipping = min(len(self.shipping.select(logits, iou, image.shape[:2])),
                       self.max_instances)
        with self._lock:
            self.kept.append(len(masks))
            self.kept_at_shipping.append(shipping)
        return np.stack(masks) if masks else np.zeros((0,) + image.shape[:2], bool)


def run_wild_components(trees: dict) -> dict:
    """Phase 14(a): each component on the card, cold (its first call) and
    warm, between CUDA syncs; the peak memory; one warm `segment` traced
    (device ms by op, idle share); the four global blocks' attention timed
    alone by CUDA events at their path shape."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.background import BackgroundConfig, BackgroundModel
    from labelany3d_tpu_torch.models.layers import dense_attention
    from labelany3d_tpu_torch.models.sam import SamAutoSegmentation, SamConfig
    from labelany3d_tpu_torch.models.segformer import SegFormerConfig, SegformerForeground

    torch.cuda.reset_peak_memory_stats()
    cfg = SamConfig.vit_base()
    t0 = time.perf_counter()
    seg8 = SamAutoSegmentation(cfg, params=trees["sam"], points_per_side=WILD_POINTS,
                               device="cuda")
    seg8._ensure()
    seg16 = SamAutoSegmentation(cfg, points_per_side=16, device="cuda")
    seg16.model = seg8.model
    fg = SegformerForeground(SegFormerConfig.b0(), params=trees["segformer"], device="cuda")
    fg._ensure()
    torch.cuda.synchronize()
    res = {"build_s": time.perf_counter() - t0, "cold_s": {}, "warm_s": {}}
    img = synthetic_scene(np.random.default_rng(14), IMAGE_HW, 8)[0]
    x = seg8.preprocess(img)
    emb = seg8.model.vision(x)
    ar = (np.arange(WILD_POINTS) + 0.5) / WILD_POINTS * cfg.image_size
    grid = np.stack(np.meshgrid(ar, ar), -1).reshape(1, -1, 1, 2).astype(np.float32)
    pts = torch.as_tensor(grid, device="cuda")
    labs = torch.ones((1, WILD_PROMPTS, 1), dtype=torch.int32, device="cuda")
    bg = BackgroundModel(BackgroundConfig(), device="cuda")
    surface = wild_surface_points()
    outs = {}

    def timed(name, fn, grad=False):
        for phase in ("cold_s", "warm_s"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if grad:
                outs[name] = fn()
            else:
                with torch.inference_mode():
                    outs[name] = fn()
            torch.cuda.synchronize()
            res[phase][name] = time.perf_counter() - t

    timed("sam_encoder", lambda: seg8.model.vision(x))
    timed("sam_decoder_64", lambda: seg8.model.decode(emb, pts, labs))
    timed("decode_grid_8", lambda: seg8.decode_grid(img))
    timed("segment_8", lambda: seg8.segment(img))
    timed("segment_16", lambda: seg16.segment(img))
    timed("segformer_semantic", lambda: fg.semantic(img))
    timed("background_fit", lambda: bg.fit(surface), grad=True)
    timed("extract_mesh_64", lambda: bg.extract_mesh(64))
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    verts, faces = outs["extract_mesh_64"]
    m, i = outs["sam_decoder_64"]
    res["shapes"] = {"embeddings": list(emb.shape), "decoder_masks": list(m.shape),
                     "decoder_iou": list(i.shape)}
    res["masks"] = {"segment_8": len(outs["segment_8"]), "segment_16": len(outs["segment_16"])}
    res["semantic_classes"] = int(len(np.unique(outs["segformer_semantic"])))
    res["fit_loss"] = outs["background_fit"]
    res["mesh"] = {"vertices": int(len(verts)), "faces": int(len(faces))}

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        seg8.segment(img)
        torch.cuda.synchronize()
    dev = sorted(device_events(prof), reverse=True)
    device_ms = sum(r[0] for r in dev)
    by_op = device_ms_by_op(prof)
    hosts = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
                    if e.device_type != torch.autograd.DeviceType.CUDA), reverse=True)
    blocks = [getattr(seg8.model.vision, f"block{j}").attn for j in cfg.global_attn_indexes]
    g, n, hd = cfg.grid, cfg.num_heads, cfg.width // cfg.num_heads
    tok = torch.randn(1, g, g, cfg.width, device="cuda", dtype=cfg.dtype)
    q, k, v = (torch.randn(1, g * g, n, hd, device="cuda", dtype=cfg.dtype) for _ in range(3))
    bias = torch.randn(1, n, g * g, g * g, device="cuda", dtype=cfg.dtype)
    with torch.inference_mode():
        attn_ms = time_cuda(lambda: [b(tok) for b in blocks], iters=5, warmup=1)
        plain_ms = len(blocks) * time_cuda(lambda: dense_attention(q, k, v, bias=bias),
                                           iters=5, warmup=1)
    res["profile"] = {
        "device_ms": device_ms, "by_op_ms": by_op,
        "top_device": [(round(ms, 3), name[:60], n) for ms, name, n in dev[:8]],
        "top_host": [(round(ms, 3), name[:60], n) for ms, name, n in hosts[:8]],
        "idle_share_of_warm_segment": (1.0 - device_ms / (res["warm_s"]["segment_8"] * 1e3)
                                       if device_ms > 0 else "not measured"),
        "global_blocks_attention_ms": attn_ms,
        "global_blocks_plain_attention_ms": plain_ms,
        "plain_attention_share": plain_ms / device_ms if device_ms > 0 else "not measured"}
    res["ok"] = (res["shapes"]["embeddings"] == [1, g, g, cfg.out_channels]
                 and res["shapes"]["decoder_masks"] == [1, WILD_PROMPTS, 3, 4 * g, 4 * g]
                 and np.isfinite(res["fit_loss"]) and res["mesh"]["faces"] > 0
                 and np.isfinite(verts).all())
    return res


def check_wild_outputs(save_dir: str) -> dict:
    """The scenes a wild run wrote: each with boxes has finite boxes of
    shape (8, 3) beside its depth and camera; COCO3D lists exactly them."""
    import numpy as np

    from labelany3d_tpu_torch.pipeline.scene import SceneDir

    root, with_boxes, scenes, bad = os.path.join(save_dir, "val"), set(), 0, []
    for name in sorted(os.listdir(root)):
        sd = SceneDir(os.path.join(root, name))
        if not sd.bbox3d.exists():
            continue
        scenes += 1
        boxes = sd.read_bbox3d()
        if not (sd.depth_map.exists() and sd.cam_params.exists()) or any(
                np.shape(b["bbox3D_cam"]) != (8, 3) or not np.isfinite(b["bbox3D_cam"]).all()
                for b in boxes):
            bad.append(name)
        if boxes:
            with_boxes.add(name)
    with open(os.path.join(save_dir, "COCO3D_val.json")) as f:
        listed = {os.path.basename(im["file_path"]).rsplit(".", 1)[0]
                  for im in json.load(f)["images"]}
    return {"scenes_with_boxes_file": scenes, "scenes_with_boxes": len(with_boxes),
            "coco3d_images": len(listed), "bad_scenes": bad,
            "ok": not bad and listed == with_boxes}


def run_wild_route(tmp: str, trees: dict) -> dict:
    """Phase 14(b): `run_stages("fast", ..., instance_provider=...)` at the
    `large` preset over phase 6's 16 images, the source SAM ViT-B (relaxed,
    counting the shipping thresholds' masks) + the SegFormer-B0 foreground
    + the constant tagger, cold and warm."""
    import torch

    from labelany3d_tpu_torch.data.sources import WildInstanceProvider
    from labelany3d_tpu_torch.data.wild import ConstantTagger, WildInstanceSource
    from labelany3d_tpu_torch.models.segformer import SegFormerConfig, SegformerForeground
    from labelany3d_tpu_torch.pipeline.backends import default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils.profiling import StageTimer

    cfg = PipelineConfig()
    loader = SyntheticLoader(N_IMAGES, IMAGE_HW, seed=0)
    source = ArrayImageSource(loader.pixels)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    seg = CountingSegmentation(trees["sam"])
    provider = WildInstanceProvider(WildInstanceSource(
        seg, SegformerForeground(SegFormerConfig.b0(), params=trees["segformer"], device="cuda"),
        ConstantTagger(), overlap_threshold=-1.0))
    counters, plains = kernel_counters()
    for c in (*counters.values(), *plains.values()):
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_stages("fast", cfg, loader, source, os.path.join(tmp, "wild_cold"), "val", 0, N_IMAGES,
               backend=backend, device="cuda", instance_provider=provider)
    torch.cuda.synchronize()
    res = {"cold_s": time.perf_counter() - t0,
           "launches": {k: c.count for k, c in counters.items()},
           "plain_calls": {k: c.count for k, c in plains.items()},
           "want": {"k1": 2 * (backend.moge_cfg.backbone.depth + backend.dp_cfg.backbone.depth),
                    "k2": 0, "k3": 0, "k4": 0},
           "masks_relaxed": list(seg.kept), "masks_at_shipping": list(seg.kept_at_shipping)}
    res.update(check_wild_outputs(os.path.join(tmp, "wild_cold")))
    timer = StageTimer()
    t0 = time.perf_counter()
    run_stages("fast", cfg, loader, source, os.path.join(tmp, "wild_warm"), "val", 0, N_IMAGES,
               backend=backend, device="cuda", instance_provider=provider, timer=timer)
    torch.cuda.synchronize()
    res["warm_s"] = time.perf_counter() - t0
    res["images_per_s"] = N_IMAGES / res["warm_s"]
    res["stage_s"] = {k: timer.stats[k].total_seconds for k in ("fused", "crops", "export")}
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["ok"] = (res["ok"] and res["launches"] == res["want"]
                 and not any(res["plain_calls"].values())
                 and res["scenes_with_boxes"] > 0 and res["scenes_with_boxes_file"] == N_IMAGES)
    return res


def run_wild_cli(tmp: str) -> dict:
    """Phase 14(c): `runner.main(["fast", "--wild", ...])` over a folder of
    WILD_CLI_IMAGES PNGs, SAM and the SegFormer filter at their shipping
    thresholds and default (random) initialisation."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.pipeline import runner
    from labelany3d_tpu_torch.utils.png import write_png

    folder, out = os.path.join(tmp, "wild_photos"), os.path.join(tmp, "wild_cli")
    os.makedirs(folder)
    rng = np.random.default_rng(15)
    for i in range(WILD_CLI_IMAGES):
        write_png(os.path.join(folder, f"photo{i}.png"), synthetic_scene(rng, IMAGE_HW, 8)[0])
    counters, plains = kernel_counters()
    for c in (*counters.values(), *plains.values()):
        c.reset()
    t0 = time.perf_counter()
    rc = runner.main(["fast", "--wild", "--dataset_root", folder, "--save_dir", out,
                      "--end_index", str(WILD_CLI_IMAGES), "run.wild_segmentation=sam",
                      "run.wild_foreground=semantic"], device="cuda")
    torch.cuda.synchronize()
    res = {"rc": rc, "s": time.perf_counter() - t0,
           "k1_launches": counters["k1"].count, "plain_calls": plains["k1"].count}
    res.update(check_wild_outputs(out))
    res["ok"] = rc == 0 and res["ok"] and res["plain_calls"] == 0
    return res


def _sdf_init_tree(cfg, seed: int) -> dict:
    """An SDFMLP parameter tree drawn on the host: kernels N(0, 1/fan_in),
    zero biases, so the card and the CPU start from the same weights."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dims = [3 * (1 + 2 * cfg.num_freqs)] + [cfg.width] * cfg.depth + [1]
    names = [f"fc{i}" for i in range(cfg.depth)] + ["out"]
    return {n: {"kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                "bias": np.zeros(b, np.float32)}
            for n, a, b in zip(names, dims[:-1], dims[1:])}


def wild_card_vs_cpu(seed: int = 110) -> dict:
    """Phase 14(d): the card against the CPU, same weights (drawn at
    WILD_CHECK_STD) and inputs, float32 with TF32 off: SAM at ViT-B widths
    cut to depth 2 with one global block (mask logits, IoU predictions over
    8 prompt groups with
    pad labels), the full SegFormer-B0 (logits, argmax agreement),
    `BackgroundModel.fit` over 20 steps from one init with the same draws
    (losses, final parameters). Then a planted fault on the card: the
    global block's relative-position tables zeroed."""
    import dataclasses

    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.background import BackgroundConfig, BackgroundModel
    from labelany3d_tpu_torch.models.sam import SamConfig, SamCore, convert_sam, init_sam_
    from labelany3d_tpu_torch.models.segformer import (
        SegFormer,
        SegFormerConfig,
        convert_segformer,
    )
    from labelany3d_tpu_torch.models.weights import build_module
    from labelany3d_tpu_torch.utils.precision import full_f32

    def rel(a, b):
        return float((a.cpu() - b).norm() / b.norm())

    rng = np.random.default_rng(seed)
    out = {}
    cfg = SamConfig.vit_base(depth=2, global_attn_indexes=(1,), dtype=torch.float32)
    tree = convert_sam(released_sam_state(cfg, seed=seed, std=WILD_CHECK_STD), cfg)
    x = rng.normal(size=(1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    pts = rng.uniform(0, cfg.image_size, (1, 8, 2, 2)).astype(np.float32)
    labs = np.tile(np.array([[1, 0], [1, -10]], np.int32), (4, 1))[None]
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_module(lambda: SamCore(cfg), dev, tree, 0, init=init_sam_)
        with torch.inference_mode(), full_f32():
            res[dev] = [t.cpu() for t in model(*(torch.as_tensor(a, device=dev)
                                                 for a in (x, pts, labs)))]
        if dev == "cuda":
            card = model
    out["sam_masks_rel"] = rel(res["cuda"][0], res["cpu"][0])
    out["sam_iou_rel"] = rel(res["cuda"][1], res["cpu"][1])
    with torch.no_grad():
        card.vision.block1.attn.rel_pos_h.zero_()
        card.vision.block1.attn.rel_pos_w.zero_()
    with torch.inference_mode(), full_f32():
        fm, fi = card(*(torch.as_tensor(a, device="cuda") for a in (x, pts, labs)))
    out["fault_no_rel_pos_masks_rel"] = rel(fm, res["cpu"][0])
    out["fault_no_rel_pos_iou_rel"] = rel(fi, res["cpu"][1])
    del card, model

    scfg = SegFormerConfig.b0()
    stree = convert_segformer(released_segformer_state(scfg, seed=seed + 1,
                                                       std=WILD_CHECK_STD), scfg)
    xs = rng.normal(size=(1, 512, 512, 3)).astype(np.float32)
    logits = {}
    for dev in ("cuda", "cpu"):
        model = build_module(lambda: SegFormer(scfg), dev, stree, 0)
        with torch.inference_mode(), full_f32():
            logits[dev] = model(torch.as_tensor(xs, device=dev)).cpu()
    out["segformer_logits_rel"] = rel(logits["cuda"], logits["cpu"])
    out["segformer_argmax_agree"] = float(
        (logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).float().mean())

    bcfg = dataclasses.replace(BackgroundConfig(), fit_steps=20)
    init = _sdf_init_tree(bcfg, seed)
    surface = wild_surface_points(seed)
    off = torch.rand((20,) + surface.shape, generator=torch.Generator().manual_seed(seed))
    fits = {}
    for dev in ("cuda", "cpu"):
        bm = BackgroundModel(bcfg, device=dev)
        bm.fit(surface, off_points=off, params=init)
        fits[dev] = (bm.losses, torch.cat([p.detach().cpu().flatten()
                                           for p in bm.model.parameters()]))
    out["background_losses_rel"] = float(np.max(np.abs(fits["cuda"][0] - fits["cpu"][0])
                                                / np.abs(fits["cpu"][0])))
    out["background_params_rel"] = rel(fits["cuda"][1], fits["cpu"][1])
    out["ok"] = (out["sam_masks_rel"] <= WILD_SAM_REL_TOL
                 and out["sam_iou_rel"] <= WILD_SAM_REL_TOL
                 and out["fault_no_rel_pos_masks_rel"] > WILD_SAM_REL_TOL
                 and out["segformer_logits_rel"] <= WILD_SEGFORMER_REL_TOL
                 and out["segformer_argmax_agree"] >= WILD_ARGMAX_MIN
                 and out["background_losses_rel"] <= WILD_BG_REL_TOL
                 and out["background_params_rel"] <= WILD_BG_REL_TOL)
    return out


def run_wild(tmp: str) -> dict:
    """Phase 14: (a) the components, (b) the route, (c) the CLI, (d) the
    card against the CPU; one line each."""
    import torch

    t0 = time.perf_counter()
    trees, n_params = wild_weights()
    weights_s = time.perf_counter() - t0
    comp = run_wild_components(trees)
    _say("wild:components", weights_s=weights_s, parameters=json.dumps(n_params),
         build_s=comp["build_s"], cold_s=json.dumps(comp["cold_s"]),
         warm_s=json.dumps(comp["warm_s"]), shapes=json.dumps(comp["shapes"]),
         masks=json.dumps(comp["masks"]), semantic_classes=comp["semantic_classes"],
         fit_loss=comp["fit_loss"], mesh=json.dumps(comp["mesh"]),
         max_memory_gb=comp["max_memory_gb"], profile=json.dumps(comp["profile"]))
    if not comp["ok"]:
        raise SystemExit("wild components: shapes, the fit or the mesh are not as required "
                         "(see wild:components)")
    torch.cuda.empty_cache()
    route = run_wild_route(tmp, trees)
    _say("wild:route", thresholds=json.dumps(WILD_RELAXED), overlap_threshold=-1.0,
         cold_s=route["cold_s"], warm_s=route["warm_s"], images_per_s=route["images_per_s"],
         stage_s=json.dumps(route["stage_s"]), launches=json.dumps(route["launches"]),
         want=json.dumps(route["want"]), plain_calls=json.dumps(route["plain_calls"]),
         masks_relaxed=json.dumps(route["masks_relaxed"]),
         masks_at_shipping_thresholds=json.dumps(route["masks_at_shipping"]),
         scenes_with_boxes=route["scenes_with_boxes"], coco3d_images=route["coco3d_images"],
         bad_scenes=json.dumps(route["bad_scenes"]), max_memory_gb=route["max_memory_gb"])
    if not route["ok"]:
        raise SystemExit("wild route: launches, plain calls or scene artifacts are not as "
                         "required (see wild:route)")
    torch.cuda.empty_cache()
    cli = run_wild_cli(tmp)
    _say("wild:cli", **{k: (json.dumps(v) if isinstance(v, list) else v)
                        for k, v in cli.items()})
    if not cli["ok"]:
        raise SystemExit("wild CLI: exit code, plain calls or artifacts are not as required "
                         "(see wild:cli)")
    torch.cuda.empty_cache()
    check = wild_card_vs_cpu()
    _say("wild:card_vs_cpu", **check, sam_rel_tol=WILD_SAM_REL_TOL,
         segformer_rel_tol=WILD_SEGFORMER_REL_TOL, argmax_min=WILD_ARGMAX_MIN,
         background_rel_tol=WILD_BG_REL_TOL)
    if not check["ok"]:
        raise SystemExit("wild: the card disagrees with the CPU, or the planted fault passes "
                         "(see wild:card_vs_cpu)")
    return {"components": comp, "route": route, "cli": cli, "card_vs_cpu": check}


# Phase 15, the released-weight workflow: TRELLIS's six components written as
# the release's float16 safetensors and converted by the convert CLI into the
# store (`models/checkpoints.py`), read back bit for bit; the `all` route with
# obj_rec=trellis reading the store through `ckpt_dir`, the runner freeing
# the models it built between stages; COCO3D scoring on the card.

# The source files (1.71 G parameters in float16, 3.42 GB) and the store
# (the converters keep the source's dtype: 3.42 GB), with room to spare; each
# source file is deleted once converted, so the peak is lower.
CKPT_DISK_GB = 8.0
CKPT_IMAGES = 1            # phase 15(b): 1 image x 2 objects
CKPT_INSTANCES = 2
SCORE_IMAGES = 5000        # phase 15(c): a COCO val split's scale
SCORE_BOXES = 8
SCORE_CHECK_PAIRS = 256
# 15(c)'s per-pair IoUs on the card against the CPU. Both compute each grid
# point's box test in float32 (TF32 off), but the card's einsum may round
# another way, so a point within rounding of a box face can flip: one flip
# moves an IoU by 1/union, 3e-5 at a third of the 32^3 grid. The limit
# allows a few flips; a wrong axis or a lost grid row moves IoUs by 1e-2.
# The first card run (NVIDIA H100 80GB HBM3, 700.00 W) read 0.0 on the 256
# pairs: no point flipped.
SCORE_CARD_TOL = 1e-3


def synthetic_coco3d_pair(n_images: int, per_image: int, seed: int = 120):
    """Two COCO3D dicts. The first: `n_images` images of `per_image` boxes,
    seeded centres 4 to 12 m ahead, sizes 0.3 to 2 m, yaws in [-pi, pi),
    2D boxes on a 100-px grid (one object a cell). The second: every box
    moved by N(0, 0.15 m) and rotated by N(0, 0.2 rad), its 2D box shifted
    by up to 8 px, a tenth of the annotations dropped and one image in 20
    missing."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.geometry.boxfit import convert_box_vertices

    rng = np.random.default_rng(seed)
    n = n_images * per_image
    center = rng.uniform([-3.0, -1.0, 4.0], [3.0, 1.0, 12.0], (n, 3)).astype(np.float32)
    dims = rng.uniform(0.3, 2.0, (n, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    moved = center + rng.normal(0.0, 0.15, (n, 3)).astype(np.float32)
    turned = yaw + rng.normal(0.0, 0.2, n).astype(np.float32)
    shift = rng.uniform(-8.0, 8.0, (n, 2))
    keep_anno = rng.uniform(size=n) >= 0.1
    keep_image = rng.uniform(size=n_images) >= 0.05

    def corners(c, y):
        return convert_box_vertices(torch.from_numpy(c), torch.from_numpy(dims),
                                    torch.from_numpy(y)).numpy().tolist()

    files = ({"images": [], "annotations": []}, {"images": [], "annotations": []})
    for which, (cs, keep) in enumerate(((corners(center, yaw), None),
                                        (corners(moved, turned), keep_anno))):
        out = files[which]
        for i in range(n_images):
            if which and not keep_image[i]:
                continue
            iid = 1000000 + i
            out["images"].append({"id": iid, "file_path": f"images/val2017/{i + 1:012d}.jpg",
                                  "width": 640, "height": 480})
            for k in range(per_image):
                j = i * per_image + k
                if keep is not None and not keep[j]:
                    continue
                x0, y0 = 10.0 + 150.0 * (k % 4), 10.0 + 150.0 * (k // 4)
                if which:
                    x0, y0 = x0 + shift[j, 0], y0 + shift[j, 1]
                box = [x0, y0, x0 + 100.0, y0 + 100.0]
                out["annotations"].append({"id": 100000000 + j, "image_id": iid,
                                           "category_id": 1, "bbox3D_cam": cs[j],
                                           "bbox2D_tight": box, "bbox2D_trunc": box})
    return files


def run_ckpt_convert(tmp: str) -> dict:
    """Phase 15(a): each TRELLIS component at `TrellisPipelineConfig()`,
    drawn in the release's layout (`released_trellis_states`, seed 40),
    written as a float16 `.safetensors` (the release's `_fp16` files) with
    the port's codec, converted by the CLI's `trellis_*` entry into the store
    (the conditioner through `python -m` in a subprocess, the others in this
    process), then read back and held, bit for bit, to the in-memory
    conversion of the same float16 state; the source file is deleted."""
    import shutil

    import numpy as np

    from labelany3d_tpu_torch.models import convert_cli
    from labelany3d_tpu_torch.models.checkpoints import PARAMS_FILE, flatten_tree, load_params
    from labelany3d_tpu_torch.models.trellis import TrellisPipeline, TrellisPipelineConfig
    from labelany3d_tpu_torch.utils.safetensors_io import save_file

    cfg = TrellisPipelineConfig()
    free = shutil.disk_usage(tmp).free
    _say("ckpt:disk", free_gb=free / 1e9, need_gb=CKPT_DISK_GB)
    if free < CKPT_DISK_GB * 1e9:
        raise SystemExit(f"ckpt: {free / 1e9:.2f} GB free under {tmp}, the phase needs "
                         f"{CKPT_DISK_GB} GB")
    store, src = os.path.join(tmp, "ckpt_store"), os.path.join(tmp, "ckpt_src")
    os.makedirs(src, exist_ok=True)
    conv = trellis_converters(cfg)
    res = {"store": store, "entries": {}, "parameters": 0, "ok": True}
    for comp, state in released_trellis_states(cfg, 40, device="cuda"):
        name = TrellisPipeline.CKPT_NAMES[comp]
        entry = {"parameters": int(sum(v.size for v in state.values()))}
        path = os.path.join(src, f"{name}_fp16.safetensors")
        state = {k: v.astype(np.float16) for k, v in state.items()}
        t0 = time.perf_counter()
        save_file(state, path)
        entry["write_s"] = time.perf_counter() - t0
        entry["source_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        if comp == "cond":
            proc = subprocess.run(
                [sys.executable, "-m", "labelany3d_tpu_torch.models.convert_cli", name, path,
                 "--out", store], capture_output=True, text=True, timeout=600,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            if proc.returncode:
                raise SystemExit(f"ckpt: convert_cli {name} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
            entry["cli"] = proc.stdout.strip()
        else:
            convert_cli.main([name, path, "--out", store])
        entry["convert_s"] = time.perf_counter() - t0
        os.remove(path)
        entry["store_bytes"] = os.path.getsize(os.path.join(store, name, PARAMS_FILE))
        t0 = time.perf_counter()
        got = flatten_tree(load_params(store, name))
        want = flatten_tree(conv[comp](state))
        entry["load_s"] = time.perf_counter() - t0
        entry["arrays"] = len(want)
        entry["dtypes"] = sorted({str(np.asarray(v).dtype) for v in want.values()})
        entry["equal"] = (set(got) == set(want) and all(
            got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], v)
            for k, v in want.items()))
        res["ok"] &= entry["equal"]
        res["parameters"] += entry["parameters"]
        res["entries"][name] = entry
        del state, got, want
    shutil.rmtree(src)
    res["ok"] &= res["parameters"] == 1710314710
    return res


def run_ckpt_route(tmp: str, store: str) -> dict:
    """Phase 15(b): `run_stages("all", ...)` with run.obj_rec=trellis and
    `ckpt_dir=store` over 1 synthetic image with 2 objects, stages 2, 4 and 5
    at their shipping defaults, the depth backend at the `large` preset and
    the layout's `MatcherConfig()` passed in (as in 12(c)),
    `bbox_method=minarea_pallas`. TRELLIS reads the stored (non-zero)
    weights, so its meshes have faces and the layout stage registers them.
    The runner frees what it built between stages; the phase keeps only the
    layout stage (see StageKeep)."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.data.meshio import load_glb
    from labelany3d_tpu_torch.models.trellis import TrellisPipelineConfig
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn
    from labelany3d_tpu_torch.pipeline.backends import TorchMatcherBackend, default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils import logging as plog

    cfg = PipelineConfig(bbox_method="minarea_pallas")
    loader = SyntheticLoader(CKPT_IMAGES, IMAGE_HW, seed=15, min_inst=CKPT_INSTANCES,
                             max_inst=CKPT_INSTANCES)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)
    matcher = TorchMatcherBackend(tiny=False, seed=cfg.seed, device="cuda")
    counters, plains = kernel_counters()
    for k in (*counters.values(), *plains.values()):
        k.reset()
    rnn.LAUNCHES_BY_SHAPE.clear()
    random_keys = ("trellis_random", "trellis_partial_ckpt")
    for key in random_keys:  # earlier phases ran TRELLIS with random weights
        plog._seen.discard(key)
    torch.cuda.reset_peak_memory_stats()
    out_dir, timer = os.path.join(tmp, "ckpt_all"), peak_timer()
    stages = StageKeep(lambda name, stage: stage if name == "layout" else None)
    t0 = time.perf_counter()
    run_stages("all", cfg, loader, ArrayImageSource(loader.pixels), out_dir, "val", 0,
               CKPT_IMAGES, backend=backend, matcher=matcher,
               run_options={"obj_rec": "trellis"}, ckpt_dir=store, device="cuda",
               timer=timer, stages=stages)
    torch.cuda.synchronize()
    stages.close()
    caller_bytes = sum(p.numel() * p.element_size()
                       for m in (backend.moge, backend.depth_pro, matcher.model)
                       if m is not None for p in m.parameters())
    res = {"s": time.perf_counter() - t0,
           "stage_s": {k: timer.stats[k].total_seconds for k in ALL_STAGES},
           "launches": {k: v.count for k, v in counters.items()},
           "plain_calls": {k: v.count for k, v in plains.items()},
           "failures": list(stages["layout"].failures), "forwards": matcher.forwards,
           "k3_by_shape": dict(rnn.LAUNCHES_BY_SHAPE),
           "random_weight_warnings": [k for k in random_keys if k in plog._seen],
           "max_memory_gb": max(timer.peaks_gb.values()), "stage_peak_gb": timer.peaks_gb,
           "allocated_after_gb": torch.cuda.memory_allocated() / 1e9,
           "caller_models_gb": caller_bytes / 1e9}
    meshes, placed, with_boxes = [], [], set()
    for info in loader.images:
        name = scene_dir_name(info["file_name"])
        sd = SceneDir(os.path.join(out_dir, "val", name))
        for i in sd.list_crop_ids():
            if sd.object_mesh(i).exists():
                m = load_glb(sd.object_mesh(i))
                meshes.append((len(m.vertices), len(m.faces),
                               bool(np.isfinite(m.vertices).all())))
        if (sd.root / "reconstruction" / "full_scene.glb").exists():
            placed.append(str(sd.root))
        if sd.bbox3d.exists() and sd.read_bbox3d():
            with_boxes.add(name)
    with open(os.path.join(out_dir, "COCO3D_val.json")) as f:
        listed = {os.path.basename(im["file_path"]).rsplit(".", 1)[0]
                  for im in json.load(f)["images"]}
    res["meshes"], res["placed_scenes"] = meshes, placed
    res["scenes_with_boxes"], res["coco3d_images"] = sorted(with_boxes), sorted(listed)
    layout = matcher_launches(matcher.cfg, res["forwards"])
    depth_k1 = (-(-CKPT_IMAGES // cfg.batch_size)
                * (backend.moge_cfg.backbone.depth + backend.dp_cfg.backbone.depth))
    k1, k2 = trellis_launches(TrellisPipelineConfig())
    n = len(meshes)
    res["want"] = {"k1": depth_k1 + k1 * n + layout["k1"], "k2": k2 * n + layout["k2"],
                   "k3": layout["k3"], "k4": len(placed)}
    res["ok"] = (res["launches"] == res["want"] and not any(res["plain_calls"].values())
                 and n == CKPT_IMAGES * CKPT_INSTANCES
                 and all(f > 0 and fin for _, f, fin in meshes)
                 and not res["random_weight_warnings"] and with_boxes == listed)
    del stages, backend, matcher
    torch.cuda.empty_cache()
    return res


def score_card_vs_cpu(ca, cb, n: int = SCORE_CHECK_PAIRS) -> float:
    """The largest difference of the first `n` matched pairs' IoUs, card
    against CPU."""
    from labelany3d_tpu_torch.export.evaluate import pair_ious

    card = pair_ious(ca[:n], cb[:n], device="cuda").cpu()
    cpu = pair_ious(ca[:n], cb[:n], device="cpu")
    return float((card - cpu).abs().max())


def run_scoring() -> dict:
    """Phase 15(c): `compare_coco3d` on the card over a seeded COCO3D pair of
    SCORE_IMAGES x SCORE_BOXES boxes (`synthetic_coco3d_pair`): the whole
    call timed (host clock), its host matching and its card IoUs apart (the
    IoUs with CUDA events), the first pairs against the CPU, and the file
    scored against itself (mean IoU 1.0, every annotation matched)."""
    import torch

    from labelany3d_tpu_torch.export import evaluate as ev

    t0 = time.perf_counter()
    ours, theirs = synthetic_coco3d_pair(SCORE_IMAGES, SCORE_BOXES)
    res = {"make_s": time.perf_counter() - t0,
           "annotations": [len(ours["annotations"]), len(theirs["annotations"])]}
    ev.compare_coco3d(ours, theirs, device="cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["summary"] = ev.compare_coco3d(ours, theirs, device="cuda")
    res["compare_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ca, cb, _ = ev.matched_corners(ours, theirs)
    res["match_host_s"] = time.perf_counter() - t0
    res["pairs"] = len(ca)
    res["iou_device_ms"] = time_cuda(lambda: ev.pair_ious(ca, cb, device="cuda"), iters=3,
                                     warmup=1)
    res["pairs_per_s"] = res["pairs"] / res["compare_s"]
    res["card_vs_cpu"] = score_card_vs_cpu(ca, cb)
    res["self"] = ev.compare_coco3d(theirs, theirs, device="cuda")
    s = res["summary"]
    res["ok"] = (res["card_vs_cpu"] <= SCORE_CARD_TOL and s["matched_pairs"] == res["pairs"] > 0
                 and 0.0 < s["mean_iou3d"] < 1.0
                 and res["self"]["mean_iou3d"] == 1.0
                 and res["self"]["matched_pairs"] == res["self"]["annotations_theirs"])
    return res


def run_ckpt(tmp: str) -> dict:
    """Phase 15: (a) the conversion into the store, (b) the route from it,
    (c) scoring; prints each part's line."""
    conv = run_ckpt_convert(tmp)
    for name, e in conv["entries"].items():
        _say(f"ckpt:convert:{name}", **{k: json.dumps(v) if isinstance(v, list) else v
                                        for k, v in e.items()})
    _say("ckpt:convert", parameters=conv["parameters"],
         store_bytes=sum(e["store_bytes"] for e in conv["entries"].values()),
         source_bytes=sum(e["source_bytes"] for e in conv["entries"].values()),
         convert_s=sum(e["convert_s"] for e in conv["entries"].values()), ok=conv["ok"])
    if not conv["ok"]:
        raise SystemExit("ckpt: the store does not hold the in-memory conversion bit for bit, "
                         "or the parameter count is wrong (see ckpt:convert:*)")
    route = run_ckpt_route(tmp, conv["store"])
    _say("ckpt:route", s=route["s"], stage_s=json.dumps(route["stage_s"]),
         launches=json.dumps(route["launches"]), want=json.dumps(route["want"]),
         plain_calls=json.dumps(route["plain_calls"]), failures=json.dumps(route["failures"]),
         forwards=route["forwards"], meshes=json.dumps(route["meshes"]),
         k3_launches_by_shape=k3_shapes_json(route["k3_by_shape"]),
         random_weight_warnings=json.dumps(route["random_weight_warnings"]),
         scenes_with_boxes=json.dumps(route["scenes_with_boxes"]),
         coco3d_images=json.dumps(route["coco3d_images"]), max_memory_gb=route["max_memory_gb"],
         stage_peak_gb=json.dumps(route["stage_peak_gb"]),
         allocated_after_gb=route["allocated_after_gb"],
         caller_models_gb=route["caller_models_gb"])
    if not route["ok"]:
        raise SystemExit("ckpt route: launches, plain calls, meshes, warnings or COCO3D are "
                         "not as required (see ckpt:route)")
    score = run_scoring()
    _say("ckpt:score", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                          for k, v in score.items()}, card_tol=SCORE_CARD_TOL)
    if not score["ok"]:
        raise SystemExit("ckpt scoring: the card disagrees with the CPU, or the summary or the "
                         "self-score is not as required (see ckpt:score)")
    return {"convert": conv, "route": route, "score": score}


# Phase 16: DINOv2-giant's SwiGLU ViT (the TRELLIS conditioner a pipeline.json
# may name) at full width through the store, the giant on the card against the
# CPU, the trajectory video of a scene phase 15(b) wrote, and the host
# leftovers that no route calls (the auction, Procrustes, the native RLE codec,
# the profiler's trace) on the card.

GIANT = "dinov2_vitg14_reg"
GIANT_DISK_GB = 6.0        # the float16 source (2.27 GB) and the store beside it
GIANT_SIZE = 518           # the conditioner's input: 37^2 patches of 14 px
GIANT_WARM_RUNS = 5
# The giant's bf16 card against the float32 CPU at full width and token count,
# depth 2, the relative L2 of each block's attention output (K1 on the card)
# and of the prenorm tokens. One bf16 rounding is 2^-9 = 2e-3 and the card
# rounds the activations, the weights and P before the PV product; a lost
# key tile moves an attention output by tens of percent.
GIANT_REL_TOL = 2e-2
TRAJECTORY_FRAMES = 90     # render_trajectory_video's defaults: 3 segments x 30
AUCTION_PROBLEMS = 16      # 64 x 64 IoU matrices, a batch on the card
AUCTION_N = 64
AUCTION_EPS = 1e-4
PROCRUSTES_TOL = 1e-4      # a noise-free similarity, float32 with TF32 off
RLE_MASKS = 500            # COCO-scale instance masks at 480 x 640
RLE_HW = (480, 640)
TRACE_IMAGES = 8           # one `fast` batch


def giant_config(depth: int | None = None):
    """The TRELLIS conditioner's config for the giant (`cond_backbone_config`),
    optionally cut to `depth` blocks."""
    import dataclasses

    from labelany3d_tpu_torch.models.convert_trellis import cond_backbone_config

    cfg = cond_backbone_config(GIANT)
    return cfg if depth is None else dataclasses.replace(cfg, depth=depth)


def giant_state(cfg, seed: int, device: str = "cuda") -> dict:
    """The torch-hub release's names and shapes for `cfg` (`SyntheticState`,
    std 0.02), pos-embed over the cls entry and 37^2 patches."""
    st = SyntheticState(seed, device=device)
    st.vit("", cfg, n_pos=cfg.pos_grid[0] * cfg.pos_grid[1])
    return st


def giant_image(seed: int):
    """A seeded ImageNet-normalised image, (1, 518, 518, 3) float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, GIANT_SIZE, GIANT_SIZE, 3)).astype(np.float32)


def run_giant_store(tmp: str) -> dict:
    """Phase 16(b): the giant drawn in the torch-hub layout (seed 130, on the
    card), written as float16 safetensors, converted by `python -m
    labelany3d_tpu_torch.models.convert_cli trellis_cond` with a
    `pipeline.json` naming the giant, read back and held bit for bit to the
    in-memory conversion of the same float16 state; then the ViT built from
    the store in bf16 and run at 518 px, batch 1, cold and warm, its K1
    launches and plain calls counted over one warm forward."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.checkpoints import flatten_tree, load_params
    from labelany3d_tpu_torch.models.convert_trellis import convert_trellis_cond
    from labelany3d_tpu_torch.models.vit import ViT
    from labelany3d_tpu_torch.models.weights import build_module
    from labelany3d_tpu_torch.utils.safetensors_io import save_file

    free = shutil.disk_usage(tmp).free
    res = {"disk_free_gb": free / 1e9}
    if free < GIANT_DISK_GB * 1e9:
        raise SystemExit(f"giant: {free / 1e9:.2f} GB free under {tmp}, the phase needs "
                         f"{GIANT_DISK_GB} GB")
    cfg = giant_config()
    store, src = os.path.join(tmp, "giant_store"), os.path.join(tmp, "giant_src")
    os.makedirs(src, exist_ok=True)
    t0 = time.perf_counter()
    state = {k: v.astype(np.float16) for k, v in giant_state(cfg, 130).items()}
    res["draw_s"] = time.perf_counter() - t0
    path = os.path.join(src, "dinov2_vitg14_reg4_pretrain_fp16.safetensors")
    pipeline_json = os.path.join(src, "pipeline.json")
    with open(pipeline_json, "w") as f:
        json.dump({"image_cond_model": GIANT}, f)
    t0 = time.perf_counter()
    save_file(state, path)
    res["write_s"] = time.perf_counter() - t0
    res["source_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "labelany3d_tpu_torch.models.convert_cli", "trellis_cond", path,
         "--out", store, "--config", pipeline_json], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        raise SystemExit(f"giant: convert_cli exited {proc.returncode}: {proc.stderr[-2000:]}")
    res["convert_s"] = time.perf_counter() - t0
    res["cli"] = proc.stdout.strip()
    shutil.rmtree(src)
    t0 = time.perf_counter()
    tree = load_params(store, "trellis_cond")
    got, want = flatten_tree(tree), flatten_tree(convert_trellis_cond(state, name=GIANT))
    res["load_s"] = time.perf_counter() - t0
    res["store_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                             for r, _, fs in os.walk(store) for f in fs)
    res["equal"] = set(got) == set(want) and all(
        got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], v)
        for k, v in want.items())
    del state, got, want

    counters, plains = kernel_counters()
    t0 = time.perf_counter()
    model = build_module(lambda: ViT(cfg, cfg.pos_grid), "cuda", tree, 0)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    del tree
    res["parameters"] = sum(p.numel() for p in model.parameters())
    x = torch.as_tensor(giant_image(131), device="cuda")

    def forward():
        with torch.inference_mode():
            return model(x)["all_prenorm"]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    res["cold_s"] = time.perf_counter() - t0
    for k in (*counters.values(), *plains.values()):
        k.reset()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    res["warm_s"] = time.perf_counter() - t0
    res["launches"] = {k: v.count for k, v in counters.items()}
    res["plain_calls"] = {k: v.count for k, v in plains.items()}
    res["warm_ms"] = time_cuda(forward, iters=GIANT_WARM_RUNS, warmup=1)
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["tokens"] = list(out.shape)
    res["finite"] = bool(torch.isfinite(out).all())
    res["ok"] = (res["equal"] and res["launches"]["k1"] == cfg.depth
                 and not any(res["plain_calls"].values()) and res["finite"]
                 and res["tokens"] == [1, 1 + cfg.num_register_tokens + 37 * 37, cfg.width])
    del model, out
    shutil.rmtree(store)
    torch.cuda.empty_cache()
    return res


def giant_card_vs_cpu(seed: int = 140) -> dict:
    """Phase 16(c): the giant at full width and token count, cut to depth 2,
    the same weights (std 0.02, LayerScale gammas 1 so each block's branches
    weigh as much as the residual) and image: bf16 on the card (K1) against
    float32 on the CPU (the plain attention, TF32 off). Read: the relative L2
    of each block's attention output and of the prenorm tokens. Then a fault
    planted on the card: K1 called with n_real cut to the last whole key tile
    (the ragged tile of 94 keys lost in every block)."""
    import dataclasses

    import numpy as np
    import torch

    from labelany3d_tpu_torch.models import vit as vit_mod
    from labelany3d_tpu_torch.models.convert import convert_dinov2_vit
    from labelany3d_tpu_torch.models.vit import ViT
    from labelany3d_tpu_torch.models.weights import build_module

    cfg = giant_config(depth=2)
    state = giant_state(cfg, seed)
    for k in state:
        if k.endswith(("ls1.gamma", "ls2.gamma")):
            state[k] = np.ones_like(state[k])
    tree = convert_dinov2_vit(state, cfg, cfg.pos_grid)
    x = giant_image(seed + 1)
    outs = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = build_module(lambda: ViT(c, c.pos_grid), dev, tree, 0)
        if dev == "cuda":
            card = model
        outs[dev] = _giant_outputs(model, torch.as_tensor(x, device=dev))

    def rel(a, b):
        return max(float((a[k].float() - b[k]).norm() / b[k].norm()) for k in b)

    out = {"rel": rel(outs["cuda"], outs["cpu"]),
           "by_output": {k: float((outs["cuda"][k].float() - v).norm() / v.norm())
                         for k, v in outs["cpu"].items()}}
    real = vit_mod.packed_sdpa
    vit_mod.packed_sdpa = lambda qkv, h, n_real: real(qkv, h, n_real // 128 * 128)
    try:
        faulty = _giant_outputs(card, torch.as_tensor(x, device="cuda"))
    finally:
        vit_mod.packed_sdpa = real
    out["fault_lost_tile_rel"] = rel(faulty, outs["cpu"])
    out["ok"] = out["rel"] <= GIANT_REL_TOL < out["fault_lost_tile_rel"]
    del card
    torch.cuda.empty_cache()
    return out


def _giant_outputs(model, x) -> dict:
    """Each block's attention output (hooked, real rows) and the prenorm
    tokens, on the host; float32 matmuls with TF32 off."""
    import torch

    from labelany3d_tpu_torch.utils.precision import full_f32

    got, hooks = {}, []
    n_real = 1 + model.cfg.num_register_tokens + (x.shape[1] // model.cfg.patch_size) ** 2
    for i in range(model.cfg.depth):
        def hook(_, __, out, i=i):
            got[f"block{i}_attn"] = out[:, :n_real].float().cpu()
        hooks.append(getattr(model, f"block{i}").attn.register_forward_hook(hook))
    try:
        with torch.inference_mode(), full_f32():
            got["all_prenorm"] = model(x)["all_prenorm"].float().cpu()
    finally:
        for h in hooks:
            h.remove()
    return got


def run_trajectory(tmp: str, scene_root: str) -> dict:
    """Phase 16(d): `render_trajectory_video` over a scene of 15(b) (its
    placed TRELLIS meshes and boxes) at the defaults, 3 x 30 frames at the
    scene's W x H on the card; the mp4 read back with cv2."""
    import cv2

    from labelany3d_tpu_torch.pipeline.scene import SceneDir
    from labelany3d_tpu_torch.utils.trajectory import render_trajectory_video

    sd = SceneDir(scene_root)
    cam = sd.read_cam_params()
    out = os.path.join(tmp, "trajectory.mp4")
    t0 = time.perf_counter()
    render_trajectory_video(sd, out, device="cuda")
    res = {"s": time.perf_counter() - t0, "W": cam["W"], "H": cam["H"],
           "boxes": len(sd.read_bbox3d())}
    res["frames_per_s"] = TRAJECTORY_FRAMES / res["s"]
    cap = cv2.VideoCapture(out)
    frames, stds = 0, []
    shapes = set()
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames += 1
        shapes.add(frame.shape)
        stds.append(float(frame.std()))
    cap.release()
    res.update(frames=frames, shapes=sorted(map(list, shapes)), mb=os.path.getsize(out) / 1e6,
               min_frame_std=min(stds) if stds else 0.0)
    w, h = cam["W"] - cam["W"] % 2, cam["H"] - cam["H"] % 2
    res["ok"] = (frames == TRAJECTORY_FRAMES and shapes == {(h, w, 3)}
                 and res["min_frame_std"] > 0.0)
    return res


def run_auction(seed: int = 150) -> dict:
    """Phase 16(e), the auction: AUCTION_PROBLEMS IoU matrices of 64 x 64
    seeded boxes in a batch on the card, 4 to 12 padding rows and 0 to 4
    invalid columns each, against scipy's `hungarian_match` on each
    problem's valid boxes: the totals within n * eps."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.export.hungarian import (
        auction_assignment,
        hungarian_match,
        iou2d_matrix,
    )

    rng = np.random.default_rng(seed)
    n = AUCTION_N
    xy = rng.uniform(0, 600, (AUCTION_PROBLEMS, 2, n, 2))
    wh = rng.uniform(20, 160, (AUCTION_PROBLEMS, 2, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1, :n // 2] = boxes[:, 0, :n // 2] + rng.normal(0, 4, (AUCTION_PROBLEMS, n // 2, 4))
    row_valid = np.arange(n)[None] < n - rng.integers(4, 13, (AUCTION_PROBLEMS, 1))
    col_valid = np.ones((AUCTION_PROBLEMS, n), bool)
    for p in range(AUCTION_PROBLEMS):
        col_valid[p, rng.choice(n, rng.integers(0, 5), replace=False)] = False
    b = torch.as_tensor(boxes, device="cuda")
    iou = iou2d_matrix(b[:, 0], b[:, 1])
    rv, cv = (torch.as_tensor(a, device="cuda") for a in (row_valid, col_valid))
    got = auction_assignment(iou, rv, cv, eps=AUCTION_EPS)
    ms = time_cuda(lambda: auction_assignment(iou, rv, cv, eps=AUCTION_EPS), iters=3,
                   warmup=1)
    got, iou_h = got.cpu().numpy(), iou.cpu().numpy()
    gaps = []
    for p in range(AUCTION_PROBLEMS):
        total = sum(float(iou_h[p, r, c]) for r, c in enumerate(got[p]) if c >= 0)
        best = sum(v for _, _, v in hungarian_match(boxes[p, 0][row_valid[p]],
                                                    boxes[p, 1][col_valid[p]]))
        gaps.append(best - total)
    assigned_ok = all(
        (got[p][row_valid[p]] >= 0).all() and (got[p][~row_valid[p]] == -1).all()
        and col_valid[p][got[p][got[p] >= 0]].all()
        and len(set(got[p][got[p] >= 0].tolist())) == int((got[p] >= 0).sum())
        for p in range(AUCTION_PROBLEMS))
    return {"problems": AUCTION_PROBLEMS, "n": n, "ms": ms, "max_gap": max(gaps),
            "limit": n * AUCTION_EPS, "assigned_ok": assigned_ok,
            "ok": assigned_ok and max(gaps) <= n * AUCTION_EPS}


def run_procrustes(seed: int = 151) -> dict:
    """Phase 16(e), Procrustes: `kabsch` and `umeyama` on the card recovering
    a seeded similarity transform (a batch of 8, 1000 points each, uniform
    weights and seeded ones)."""
    import torch

    from labelany3d_tpu_torch.geometry.procrustes import kabsch, umeyama
    from labelany3d_tpu_torch.geometry.transforms import so3_exp

    g = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.randn(8, 1000, 3, device="cuda", generator=g)
    r = so3_exp(torch.randn(8, 3, device="cuda", generator=g))
    s = torch.rand(8, device="cuda", generator=g) * 2.0 + 0.5
    t = torch.randn(8, 3, device="cuda", generator=g)
    dst = s[:, None, None] * torch.einsum("bij,bnj->bni", r, src) + t[:, None]
    w = torch.rand(8, 1000, device="cuda", generator=g) + 0.1
    out = {}
    for name, weights in (("uniform", None), ("weighted", w)):
        sim = umeyama(src, dst, weights)
        out[f"umeyama_{name}_err"] = max(float((sim.rotation - r).abs().max()),
                                         float((sim.scale - s).abs().max()),
                                         float((sim.translation - t).abs().max()))
        rk, tk = kabsch(src, dst / s[:, None, None], weights)
        out[f"kabsch_{name}_err"] = max(float((rk - r).abs().max()),
                                        float((tk - t / s[:, None]).abs().max()))
    out["ok"] = all(v <= PROCRUSTES_TOL for v in out.values())
    return out


def rle_masks(seed: int = 152):
    """RLE_MASKS seeded instance masks of RLE_HW: 1 to 4 ellipses each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:RLE_HW[0], :RLE_HW[1]]
    out = []
    for _ in range(RLE_MASKS):
        m = np.zeros(RLE_HW, bool)
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(0, RLE_HW[0]), rng.uniform(0, RLE_HW[1])
            ry, rx = rng.uniform(3, 150), rng.uniform(3, 200)
            m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        out.append(m)
    return out


def run_rle() -> dict:
    """Phase 16(e), the native RLE codec: built with g++ on this machine,
    every mask encoded to a string and decoded back through the native path,
    then through the numpy path; the outputs equal and the masks restored.
    Both paths timed (host clock), the calls each served counted."""
    import numpy as np

    from labelany3d_tpu_torch import native
    from labelany3d_tpu_torch.data import rle
    from labelany3d_tpu_torch.utils import logging as plog

    masks = rle_masks()
    t0 = time.perf_counter()
    lib = native.load_rle()
    res = {"build_s": time.perf_counter() - t0, "library": str(native.library_path()),
           "built": lib is not None}

    def codec():
        t0 = time.perf_counter()
        enc = [rle.rle_encode(m) for m in masks]
        dec = [rle.rle_decode(e) for e in enc]
        return time.perf_counter() - t0, enc, dec

    before = dict(rle.PATHS)
    res["native_s"], enc_n, dec_n = codec()
    res["native_calls"] = rle.PATHS["native"] - before["native"]
    # The numpy pass, as where no compiler is (its one-time warning kept
    # quiet: the library was built).
    real, seen = native.load_rle, "rle_numpy" in plog._seen
    native.load_rle = lambda: None
    plog._seen.add("rle_numpy")
    try:
        res["numpy_s"], enc_p, dec_p = codec()
    finally:
        native.load_rle = real
        if not seen:
            plog._seen.discard("rle_numpy")
    res["numpy_calls"] = rle.PATHS["numpy"] - before["numpy"]
    res["equal"] = (all(a["counts"] == b["counts"] for a, b in zip(enc_n, enc_p))
                    and all(np.array_equal(a, m) and np.array_equal(b, m)
                            for a, b, m in zip(dec_n, dec_p, masks)))
    res["areas_equal"] = all(rle.rle_area(e) == int(m.sum()) for e, m in zip(enc_n, masks))
    res["masks"] = len(masks)
    res["ok"] = (res["built"] and res["equal"] and res["areas_equal"]
                 and res["native_calls"] == res["numpy_calls"] == 4 * len(masks))
    return res


def run_trace(tmp: str) -> dict:
    """Phase 16(e), `trace` and `annotate`: one warm `fast` batch (8 synthetic
    images at the `large` preset) under `trace`, inside an `annotate` range;
    the Chrome trace must exist and hold the range and K1's kernel."""
    import torch

    from labelany3d_tpu_torch.pipeline.backends import default_registry
    from labelany3d_tpu_torch.pipeline.config import PipelineConfig
    from labelany3d_tpu_torch.pipeline.runner import run_stages
    from labelany3d_tpu_torch.pipeline.stages.common import ArrayImageSource
    from labelany3d_tpu_torch.utils.profiling import annotate, trace

    cfg = PipelineConfig()
    loader = SyntheticLoader(TRACE_IMAGES, IMAGE_HW, seed=16)
    source = ArrayImageSource(loader.pixels)
    backend = default_registry().get("depth", preset="large", pin_hw=cfg.bucket_sizes()[0],
                                     device="cuda", seed=cfg.seed)

    def batch(name):
        run_stages("fast", cfg, loader, source, os.path.join(tmp, name), "val", 0,
                   TRACE_IMAGES, backend=backend, device="cuda")

    batch("trace_cold")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(os.path.join(tmp, "trace")) as prof:
        with annotate("fast_batch"):
            batch("trace_warm")
    res = {"s": time.perf_counter() - t0, "file": os.path.basename(prof.trace_path),
           "mb": os.path.getsize(prof.trace_path) / 1e6}
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    res["annotate_ranges"] = sum(e.get("name") == "fast_batch" for e in events)
    res["k1_kernels"] = sum(PROFILE_NAMES["k1"] in str(e.get("name", "")) for e in events
                            if e.get("cat") == "kernel")
    res["events"] = len(events)
    res["ok"] = res["annotate_ranges"] >= 1 and res["k1_kernels"] > 0
    del backend, prof, events
    torch.cuda.empty_cache()
    return res


def run_giant(tmp: str, scene_root: str) -> dict:
    """Phase 16: (b) the giant through the store, (c) its card against the
    CPU, (d) the trajectory video, (e) the host leftovers; prints each
    part's line. (16(a), K1 at the giant's shape, is in phase 3.)"""
    out = {}
    out["store"] = g = run_giant_store(tmp)
    _say("giant:store", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                           for k, v in g.items()})
    if not g["ok"]:
        raise SystemExit("giant: the store is not bit-equal, or the forward's launches, plain "
                         "calls or tokens are not as required (see giant:store)")
    out["check"] = c = giant_card_vs_cpu()
    _say("giant:card_vs_cpu", rel=c["rel"], by_output=json.dumps(c["by_output"]),
         fault_lost_tile_rel=c["fault_lost_tile_rel"], rel_tol=GIANT_REL_TOL)
    if not c["ok"]:
        raise SystemExit("giant: the card disagrees with the CPU, or the planted fault stays "
                         "under the limit (see giant:card_vs_cpu)")
    out["trajectory"] = t = run_trajectory(tmp, scene_root)
    _say("giant:trajectory", **{k: json.dumps(v) if isinstance(v, list) else v
                                for k, v in t.items()})
    if not t["ok"]:
        raise SystemExit("trajectory: the mp4 does not hold 90 frames of W x H with content")
    for name, fn in (("auction", run_auction), ("procrustes", run_procrustes),
                     ("rle", run_rle), ("trace", lambda: run_trace(tmp))):
        out[name] = r = fn()
        _say(f"giant:{name}", **r)
        if not r["ok"]:
            raise SystemExit(f"host leftovers: {name} is not as required (see giant:{name})")
    return out


# Phase 17, the fine-tuning step (`parallel/train.py`): MoGe ViT-L with the
# checkpoint head trained at 518 px, K1 in its forward and K1's plain
# backward; the multi-device code around it at one rank.

TRAIN_BATCH = 8            # the production batch of the depth stage
TRAIN_SIZE = 518           # 37^2 patches of 14 px: 1 + 1369 tokens, padded to 1408
TRAIN_WARM_STEPS = 5
TRAIN_INVALID = 0.1        # share of target pixels marked invalid
TRAIN_SHAPE = dict(b=TRAIN_BATCH, n_pad=1408, n_real=1370, heads=16, d=64)
# K1's d`qkv` on the card (kernel forward, plain fp32 backward rounded to
# bf16) against the fp32 plain version's autograd gradient from the same
# bf16 qkv and a bf16-exact cotangent: the result's bf16 rounding puts the
# relative L2 near 1e-3; the largest error is held to a share of the
# largest gradient. A gradient cut off at the attention output is 1.0.
K1_GRAD_REL_TOL = 5e-3
K1_GRAD_MAX_ABS_TOL = 1e-2
# The step through make_mesh(1, 1) against the step without a mesh: the
# same program plus collectives over one rank. The step repeats bit for bit
# (the MoGe head's resize and edge pads have no atomics in their backward),
# so anything above rounding is a fault of the mesh path.
TRAIN_MESH_REL_TOL = 1e-6
# The card's bf16 loss and gradients at depth 2 against the CPU's f32 ones
# (relative L2 per tensor, key bias left out as above), from the same
# weights with LayerScale gammas 1 and the same batch. Set from the CPU's
# own bf16 against its f32 at this size: loss 9.8e-4, gradients 2.3e-2 at
# the median tensor and 8.6e-2 at the worst (`backbone.pos_embed`, a sum
# over every token). A gradient cut off at the attention output gives 1.0
# on every qkv weight.
TRAIN_CPU_LOSS_TOL = 1e-2
TRAIN_CPU_REL_TOL = 0.2


def train_batch(seed: int = 170, b: int = TRAIN_BATCH, size: int = TRAIN_SIZE):
    """`b` synthetic scenes at `size` px (`synthetic_scene`): images in [0,
    1], a target depth of a receding floor (2 to 6) with each rectangle at
    a depth of its own (1 to 3), and about `TRAIN_INVALID` of the pixels
    invalid. Numpy float32, float32, bool."""
    import numpy as np

    from labelany3d_tpu_torch.data.rle import rle_decode

    rng = np.random.default_rng(seed)
    images = np.empty((b, size, size, 3), np.float32)
    depth = np.empty((b, size, size), np.float32)
    rows = np.linspace(6.0, 2.0, size, dtype=np.float32)[:, None]
    for i in range(b):
        img, annos = synthetic_scene(rng, (size, size), int(rng.integers(2, 9)))
        images[i] = img / np.float32(255.0)
        depth[i] = rows
        for a in annos:
            depth[i][rle_decode(a["segmentation"])] = rng.uniform(1.0, 3.0)
    valid = rng.uniform(size=(b, size, size)) >= TRAIN_INVALID
    return images, depth, valid


def train_config(depth: int | None = None, dtype=None):
    """`MoGeConfig.vitl()`, optionally cut to `depth` blocks (every block
    an output) and with every compute dtype set to `dtype`."""
    import dataclasses

    from labelany3d_tpu_torch.models.moge import MoGeConfig

    cfg = MoGeConfig.vitl()
    bb = cfg.backbone
    if depth is not None:
        bb = dataclasses.replace(bb, depth=depth, out_indices=tuple(range(depth)))
    if dtype is not None:
        bb = dataclasses.replace(bb, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return dataclasses.replace(cfg, backbone=bb)


def check_attention_grad(shape: dict, seed: int, nan_pad_v: bool = False,
                         timed: bool = False) -> dict:
    """K1's autograd on the card at one shape: d`qkv` of the kernel forward
    and plain backward against the gradient of the plain version under
    autograd in fp32, for a bf16-exact cotangent on every row. With
    `nan_pad_v` the pad rows of V hold NaN. With `timed`, the plain
    backward's time and SDPA's forward and backward times (a yardstick,
    with a key mask), and the backward's bound."""
    import torch
    import torch.nn.functional as F

    from labelany3d_tpu_torch.ops import attention as att

    b, n_pad, n_real, heads, d = (shape[k] for k in ("b", "n_pad", "n_real", "heads", "d"))
    w = heads * d
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(b, n_pad, 3 * w, device="cuda", generator=g).bfloat16()
    if nan_pad_v:
        base[:, n_real:, 2 * w:] = float("nan")
    cot = torch.randn(b, n_pad, w, device="cuda", generator=g).bfloat16()
    qkv = base.clone().requires_grad_()
    out = att.packed_sdpa(qkv, heads, n_real)
    out.backward(cot)
    ref = base.float().requires_grad_()
    att.packed_sdpa_reference(ref, heads, n_real).backward(cot.float())
    got, want = qkv.grad.float(), ref.grad
    torch.cuda.synchronize()
    res = {"has_grad_fn": out.grad_fn is not None,
           "finite": bool(torch.isfinite(got).all()),
           "max_abs_err": float((got - want).abs().max()),
           "max_abs_grad": float(want.abs().max()),
           "rel_err": float((got - want).norm() / want.norm())}
    res["ok"] = (res["has_grad_fn"] and res["finite"] and res["rel_err"] <= K1_GRAD_REL_TOL
                 and res["max_abs_err"] <= K1_GRAD_MAX_ABS_TOL * res["max_abs_grad"])
    del qkv, ref, out, got, want
    if timed:
        res["backward_ms"] = time_cuda(
            lambda: att.packed_sdpa_backward(base, cot, heads, n_real), iters=5, warmup=1)
        q, k, v = (base[..., i * w:(i + 1) * w].view(b, n_pad, heads, d).transpose(1, 2)
                   .detach().requires_grad_() for i in range(3))
        mask = (torch.arange(n_pad, device="cuda") < n_real).view(1, 1, 1, n_pad)
        sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        go = cot.view(b, n_pad, heads, d).transpose(1, 2)
        res["library_backward_ms"] = time_cuda(
            lambda: torch.autograd.grad(sdpa, (q, k, v), go, retain_graph=True))
        # The backward's least time: qkv and the cotangent read, d`qkv`
        # written (bf16); QK^T recomputed, then dV, dP, dQ and dK, five
        # products over the real keys on the bf16 tensor cores.
        res["backward_bound_ms"], res["backward_bound_by"] = bound(
            2 * (3 * b * n_pad * w + b * n_pad * w + 3 * b * n_pad * w),
            10 * b * heads * n_pad * n_real * d)
    torch.cuda.empty_cache()
    return res


def run_train_step() -> dict:
    """Phase 17(b): `MoGeModel(MoGeConfig.vitl())` at 518 px built on the
    card (Flax's initialisers, seed 171, f32 master weights, bf16 compute),
    `init_train_state` and `make_train_step` without a mesh on one batch of
    8 (`train_batch`): one cold step, then `TRAIN_WARM_STEPS` warm ones,
    each timed by CUDA events; K1 launches, plain calls and backward calls
    counted over those steps; the peak; one more step traced for the idle
    share. Then the same start through `make_mesh(1, 1)` under NCCL at
    world size 1 (`launch.process_group`) for 2 steps, against the first 2
    steps without a mesh."""
    import numpy as np
    import torch

    from labelany3d_tpu_torch.models.moge import MoGeModel
    from labelany3d_tpu_torch.ops import attention as att
    from labelany3d_tpu_torch.parallel.launch import process_group
    from labelany3d_tpu_torch.parallel.mesh import make_mesh
    from labelany3d_tpu_torch.parallel.train import (
        init_train_state,
        make_train_step,
        prepare_batch,
    )

    cfg = train_config()
    hw = (TRAIN_SIZE, TRAIN_SIZE)
    batch = [torch.as_tensor(a, device="cuda") for a in train_batch()]
    with torch.device("cuda"):
        model = MoGeModel(cfg, hw)
    state, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(171))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res = {"parameters": sum(p.numel() for p in model.parameters()),
           "param_dtypes": sorted({str(p.dtype) for p in model.parameters()})}
    step = make_train_step(model, opt)
    counts = (att.KERNEL_LAUNCHES, att.PLAIN_CALLS, att.BACKWARD_CALLS)
    for c in counts:
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    losses = [float(loss)]
    res["cold_s"] = time.perf_counter() - t0
    step_ms = []
    after2 = None
    for i in range(TRAIN_WARM_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, *batch)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
        if i == 0:
            after2 = {k: p.detach().clone() for k, p in model.named_parameters()}
    steps = 1 + TRAIN_WARM_STEPS
    res.update(losses=losses, steps=steps, step_ms=step_ms,
               warm_ms=float(np.mean(step_ms)), max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               k1_launches=counts[0].count, k1_plain_calls=counts[1].count,
               k1_backward_calls=counts[2].count)
    res["images_per_s"] = TRAIN_BATCH / (res["warm_ms"] / 1e3)
    prof = profile_pass(lambda: step(state, *batch), host=False)
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "k1_ms", "k1_events",
                                           "top_device")}
    res["idle_share"] = (1.0 - prof["device_ms"] / res["warm_ms"] if prof["device_ms"] > 0
                         else "not measured")
    depth = cfg.backbone.depth
    res["ok"] = (bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
                 and res["k1_launches"] == depth * steps and res["k1_plain_calls"] == 0
                 and res["k1_backward_calls"] == depth * steps and res["param_dtypes"] ==
                 ["torch.float32"])
    del state, opt, step, model
    torch.cuda.empty_cache()

    # The same start and batch through make_mesh(1, 1) under NCCL.
    with torch.device("cuda"):
        model = MoGeModel(cfg, hw)
    model.load_state_dict(start)
    del start
    with process_group(device="cuda"):
        mesh = make_mesh(1, 1, device="cuda")
        state, opt = init_train_state(model, mesh=mesh)
        local = prepare_batch(mesh, *batch)
        step = make_train_step(model, opt)
        mesh_losses = []
        for _ in range(2):
            state, loss = step(state, *local)
            mesh_losses.append(float(loss))
    got = dict(model.named_parameters())
    num = sum(float((got[k].detach() - after2[k]).norm()) ** 2 for k in got) ** 0.5
    res["mesh"] = {"losses": mesh_losses,
                   "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses[:2])),
                   "param_rel": num / sum(float(p.norm()) ** 2 for p in after2.values()) ** 0.5}
    res["mesh"]["ok"] = (res["mesh"]["loss_rel"] <= TRAIN_MESH_REL_TOL
                         and res["mesh"]["param_rel"] <= TRAIN_MESH_REL_TOL)
    del model, state, opt, step, after2, got
    torch.cuda.empty_cache()
    return res


def train_grads(model, batch) -> tuple[float, dict]:
    """One forward and backward of the scale-invariant loss: the loss and
    each parameter's gradient (float32, on the host; zeros where none)."""
    import torch

    from labelany3d_tpu_torch.parallel.train import depth_loss
    from labelany3d_tpu_torch.utils.precision import full_f32

    model.zero_grad(set_to_none=True)
    with torch.enable_grad(), full_f32():
        loss = depth_loss(model(batch[0])["points"][..., 2], batch[1], batch[2])
        loss.backward()
    return float(loss.detach()), {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                         .float().cpu() for k, p in model.named_parameters()}


def grad_rel(got: dict, want: dict) -> dict:
    """Relative L2 of each gradient tensor, the key bias left out of each
    `qkv.bias` (its gradient is zero in exact arithmetic)."""
    import torch

    out = {}
    for k, w in want.items():
        g = got[k]
        if k.endswith("attn.qkv.bias"):
            n = w.shape[0] // 3
            keep = torch.ones_like(w, dtype=torch.bool)
            keep[n:2 * n] = False
            g, w = g[keep], w[keep]
        out[k] = float((g - w).norm() / max(float(w.norm()), 1e-30))
    return out


def train_card_vs_cpu(seed: int = 172) -> dict:
    """Phase 17(c): MoGe ViT-L at full width cut to depth 2 (both blocks
    feed the head), 518 px, batch 1, the same weights (Flax's initialisers
    from a seed, LayerScale gammas 1 so the attention branch weighs as much
    as the residual) and the same batch: the card's bf16 compute (K1
    forward, plain backward) against the CPU's f32, the loss and every
    parameter's gradient. Then a fault planted on the card: the attention
    output cut from the graph (K1's kernel called without its autograd
    function, as the port did before its backward existed)."""
    import torch

    from labelany3d_tpu_torch.models import vit as vit_mod
    from labelany3d_tpu_torch.models.moge import MoGeModel
    from labelany3d_tpu_torch.models.weights import init_params_
    from labelany3d_tpu_torch.ops import attention as att

    hw = (TRAIN_SIZE, TRAIN_SIZE)
    cpu = MoGeModel(train_config(depth=2, dtype=torch.float32), hw)
    init_params_(cpu, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(1.0)
    with torch.device("cuda"):
        card = MoGeModel(train_config(depth=2), hw)
    card.load_state_dict(cpu.state_dict())
    batch = train_batch(seed + 1, b=1)
    loss_cpu, g_cpu = train_grads(cpu, [torch.as_tensor(a) for a in batch])
    on_card = [torch.as_tensor(a, device="cuda") for a in batch]
    loss_card, g_card = train_grads(card, on_card)
    rel = grad_rel(g_card, g_cpu)
    worst = max(rel, key=rel.get)
    res = {"loss_cpu": loss_cpu, "loss_card": loss_card,
           "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "grad_rel_max": rel[worst], "grad_rel_worst": worst,
           "grad_rel_median": sorted(rel.values())[len(rel) // 2], "tensors": len(rel)}
    real = vit_mod.packed_sdpa
    vit_mod.packed_sdpa = att.packed_sdpa_kernel
    try:
        _, g_fault = train_grads(card, on_card)
    finally:
        vit_mod.packed_sdpa = real
    fault = grad_rel(g_fault, g_cpu)
    qkv = [k for k in fault if k.endswith("attn.qkv.weight")]
    res["fault_detached_qkv_weight_rel"] = [fault[k] for k in qkv]
    res["ok"] = (res["loss_rel"] <= TRAIN_CPU_LOSS_TOL and res["grad_rel_max"] <= TRAIN_CPU_REL_TOL
                 and len(qkv) == 2 and all(fault[k] > TRAIN_CPU_REL_TOL for k in qkv))
    del card, cpu
    torch.cuda.empty_cache()
    return res


def run_multichip() -> dict:
    """Phase 17(d): `entry()` on the card (the full-width forward at 518 px),
    and `dryrun_multichip(1)`: one rank spawned under NCCL, the tiny train
    step twice, the production shard shapes and data splits. (Sequence
    parallelism's ring mode needs two ranks, which NCCL does not put on one
    device: it is held on the CPU only, tests/test_torch_sp_attention.py.)"""
    import torch

    from labelany3d_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    fn, args = entry(device="cuda")
    t0 = time.perf_counter()
    points = fn(*args)
    torch.cuda.synchronize()
    res = {"entry_s": time.perf_counter() - t0, "entry_shape": list(points.shape),
           "entry_finite": bool(torch.isfinite(points).all())}
    del fn, args, points
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (rank,) = dryrun_multichip(1, device="cuda")
    res["dryrun_s"] = time.perf_counter() - t0
    res["dryrun"] = {k: rank[k] for k in ("coordinate", "losses", "step", "production_shards",
                                          "production_split", "labeling_rows", "forbidden")}
    res["ok"] = (res["entry_shape"] == [1, TRAIN_SIZE, TRAIN_SIZE, 3] and res["entry_finite"]
                 and rank["step"] == 2 and not rank["forbidden"])
    return res


def run_train() -> dict:
    """Phase 17: (a) K1's autograd at the train shape, (b) the full-width
    train step, (c) the card against the CPU with a planted fault, (d) the
    entry forward and the dry run; prints each part's line."""
    out = {"k1": check_attention(TRAIN_SHAPE, seed=170)}
    _say("train:K1", **out["k1"], max_abs_tol=K1_MAX_ABS_TOL, rel_tol=K1_REL_TOL)
    out["grad"] = check_attention_grad(TRAIN_SHAPE, seed=173, timed=True)
    out["grad_nan_v"] = check_attention_grad(TRAIN_SHAPE, seed=174, nan_pad_v=True)
    for name in ("grad", "grad_nan_v"):
        _say(f"train:K1_{name}", **out[name], rel_tol=K1_GRAD_REL_TOL,
             max_abs_tol_of_max_grad=K1_GRAD_MAX_ABS_TOL)
    k1 = out["k1"]
    if (not k1["finite"] or k1["max_abs_err"] > K1_MAX_ABS_TOL or k1["rel_err"] > K1_REL_TOL
            or not out["grad"]["ok"] or not out["grad_nan_v"]["ok"]):
        raise SystemExit("train: K1's forward or gradient disagrees with its plain version at "
                         "the train shape (see train:K1*)")
    out["step"] = s = run_train_step()
    _say("train:step", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                          for k, v in s.items() if k != "mesh"})
    _say("train:mesh", **{k: json.dumps(v) if isinstance(v, list) else v
                          for k, v in s["mesh"].items()}, rel_tol=TRAIN_MESH_REL_TOL)
    if not s["ok"] or not s["mesh"]["ok"]:
        raise SystemExit("train: the step's loss, launches, plain or backward calls, or the "
                         "mesh run's agreement are not as required (see train:step, train:mesh)")
    out["check"] = c = train_card_vs_cpu()
    _say("train:card_vs_cpu", **{k: json.dumps(v) if isinstance(v, list) else v
                                 for k, v in c.items()}, loss_tol=TRAIN_CPU_LOSS_TOL,
         rel_tol=TRAIN_CPU_REL_TOL)
    if not c["ok"]:
        raise SystemExit("train: the card's gradients disagree with the CPU's, or the planted "
                         "fault stays under the limit (see train:card_vs_cpu)")
    out["multichip"] = m = run_multichip()
    _say("train:multichip", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                               for k, v in m.items()},
         sp_ring="held on the CPU only (two ranks; NCCL puts one rank on a device)")
    if not m["ok"]:
        raise SystemExit("train: the entry forward or the dry run is not as required "
                         "(see train:multichip)")
    return out


def module_version(name: str) -> str:
    """An optional module's version, or "missing" (the overlay needs OpenCV)."""
    try:
        return getattr(__import__(name), "__version__", "present")
    except ImportError:
        return "missing"


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
         torch=torch.__version__, cuda=torch.version.cuda,
         opencv=module_version("cv2"), pillow=module_version("PIL"))
    print(smi[0] if smi else "nvidia-smi: unavailable", flush=True)

    # 2. Kernel build: one nvcc per source, all started together.
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                           if any(w in ln for w in ("registers", "spill", "wgmma", "arning")))
        _say(f"build:{name}", ptxas=json.dumps(ptxas))
    _say("build", s=build_s, kernels=len(logs))
    tool = cuobjdump()
    sass = {}
    for k in ("k1", "k2", "k3"):
        if tool is None:
            sass[k] = "not measured (no cuobjdump)"
            continue
        sass[k] = sass_opcodes(build.library_path(KERNEL_NAMES[k]), tool)
        if not all(sass[k][op] for op in SASS_REQUIRED):
            raise SystemExit(f"{KERNEL_NAMES[k]}: SASS lacks {SASS_REQUIRED}: {sass[k]}")
    _say("sass", cuobjdump=tool, **{k: json.dumps(v) for k, v in sass.items()})

    # 3. K1 against its plain version at its path shapes (MoGe, DepthPro, the
    # matcher encoder over 4 references + 32 views, DepthPro35's encoders),
    # and with NaN pads.
    # The reference chain adds DepthPro35's patch encoder (35 patches x 8
    # images, 24x24 tokens + cls at 384^2) and its image and FoV encoders.
    shapes = {"moge": dict(b=8, n_pad=1408, n_real=1297, heads=16, d=64),
              "depth_pro": dict(b=40, n_pad=384, n_real=325, heads=16, d=64),
              "matcher": dict(b=36, n_pad=1408, n_real=1297, heads=16, d=64),
              "depth_pro35_patch": dict(b=280, n_pad=640, n_real=577, heads=16, d=64),
              "depth_pro35_image": dict(b=8, n_pad=640, n_real=577, heads=16, d=64),
              # TRELLIS's DINOv2 ViT-L/14 with 4 registers at 518^2: 1 + 4 +
              # 37^2 tokens, one object at a time.
              "trellis_cond": dict(b=1, n_pad=1408, n_real=1374, heads=16, d=64),
              # Stage 5's elevation matcher (tiny: width 64, 2 heads of 32)
              # over a pair of 256^2 Zero123 views: 1 + 32^2 tokens.
              "elevation_matcher": dict(b=2, n_pad=1152, n_real=1025, heads=2, d=32),
              # DINOv2-giant (phase 16): width 1536, 24 heads of 64, the
              # same 1 + 4 + 37^2 tokens at 518^2, one image at a time.
              "giant": dict(b=1, n_pad=1408, n_real=1374, heads=24, d=64)}
    k1 = {}
    for i, (name, shape) in enumerate(shapes.items()):
        k1[name] = check_attention(shape, seed=i, graph=name == "elevation_matcher")
        _say(f"K1:{name}", **k1[name], max_abs_tol=K1_MAX_ABS_TOL, rel_tol=K1_REL_TOL)
    nan = check_attention(shapes["moge"], seed=7, nan_pad=True)
    _say("K1:nan_pad", **nan, max_abs_tol=K1_MAX_ABS_TOL, rel_tol=K1_REL_TOL)
    failures = [n for n, r in {**k1, "nan_pad": nan}.items()
                if not r["finite"] or r["max_abs_err"] > K1_MAX_ABS_TOL
                or r["rel_err"] > K1_REL_TOL]
    if failures:
        raise SystemExit(f"K1 disagrees with its plain version: {failures}")

    # 4. K2, K3, K4 against their plain versions.
    kc = kernel_checks()

    # 5. Fused labeling program on the card against the CPU.
    lab = check_labeling("cuda")
    _say("labeling", **lab, tol=BOX_TOL)
    if not lab["ok_equal"] or lab["box_err"] > BOX_TOL or lab["depth_rel_err"] > 1e-4:
        raise SystemExit("fused labeling on the card disagrees with the CPU")

    # 6. The fast route at the large preset: 16 images, two batches of 8.
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
        with_boxes, listed, _ = check_scene_outputs(cold, loader)
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

        prof = profile_pass(lambda: run_stages(
            "fast", cfg, loader, source, os.path.join(tmp, "prof"), "val", 0, N_IMAGES,
            backend=backend, device="cuda"))
        # The profiler slows the host several-fold but not the device, so
        # the idle share sets the traced pass's device time against the
        # untraced warm pass's wall time. No device time: not measured.
        idle = (1.0 - prof["device_ms"] / (warm_s * 1e3) if prof["device_ms"] > 0
                else "not measured")
        _say("fast:profile", traced_wall_ms=prof["wall_ms"],
             device_ms=prof["device_ms"], k1_device_ms=prof["k1_ms"],
             k1_device_events=prof["k1_events"],
             idle_share_of_warm_pass=idle, top_device=json.dumps(prof["top_device"]),
             top_host=json.dumps(prof["top_host"]))
        del backend
        torch.cuda.empty_cache()

        # 7. The registration chain: depth -> crops -> reconstruction ->
        # layout -> export at the large preset, full-width matcher, K4 box fit.
        # Its traced pass records the device only, as phase 10's does.
        reg = run_registration({}, tmp, trace_host=False)
        _say("registration:cold", s=reg["cold_s"], forwards=reg["forwards"],
             launches=json.dumps(reg["launches"]), want=json.dumps(reg["want"]),
             plain_calls=json.dumps(reg["plain_calls"]), failures=json.dumps(reg["failures"]),
             k3_launches_by_shape=k3_shapes_json(reg["k3_by_shape"]),
             scenes_with_boxes=reg["scenes_with_boxes"], coco3d_images=reg["coco3d_images"],
             f16_overflow_boxes=reg["f16_overflow_boxes"])
        p = reg["profile"]
        _say("registration:warm", s=reg["warm_s"], images_per_s=reg["images_per_s"],
             stage_s=json.dumps(reg["stage_s"]), max_memory_gb=reg["max_memory_gb"])
        _say("registration:profile", traced_wall_ms=p["wall_ms"], device_ms=p["device_ms"],
             **{f"{k}_device_ms": p[f"{k}_ms"] for k in PROFILE_NAMES},
             **{f"{k}_device_events": p[f"{k}_events"] for k in PROFILE_NAMES},
             idle_share_of_warm_pass=reg["idle_share"],
             top_device=json.dumps(p["top_device"]), top_host=json.dumps(p["top_host"]))
        if not reg["ok"]:
            raise SystemExit("registration chain: launches, plain calls, failures or scene "
                             "artifacts are not as required (see registration:cold)")
        torch.cuda.empty_cache()

        # 8. The registration chain at the checkpoint-faithful models, with
        # released-checkpoint-shaped weights through the port's converters.
        from labelany3d_tpu_torch.models.matcher import MatcherConfig

        t0 = time.perf_counter()
        weights, n_params = reference_weights()
        _say("reference:weights", s=time.perf_counter() - t0,
             parameters=json.dumps(n_params))
        mp = weights.pop("matcher")
        # Its traced pass records the device only, as phases 7 and 10 do:
        # host-op tracing of a chain pass costs minutes (phase 6 lists host ops).
        ref = run_registration({}, tmp, name="ref",
                               depth_kw={"preset": "vitl_reference", **weights},
                               matcher_cfg=MatcherConfig.mast3r_vitl(), matcher_params=mp,
                               trace_host=False)
        del weights, mp
        _say("reference:cold", s=ref["cold_s"], forwards=ref["forwards"],
             launches=json.dumps(ref["launches"]), want=json.dumps(ref["want"]),
             plain_calls=json.dumps(ref["plain_calls"]), failures=json.dumps(ref["failures"]),
             k3_launches_by_shape=k3_shapes_json(ref["k3_by_shape"]),
             scenes_with_boxes=ref["scenes_with_boxes"], coco3d_images=ref["coco3d_images"],
             f16_overflow_boxes=ref["f16_overflow_boxes"])
        p8 = ref["profile"]
        _say("reference:warm", s=ref["warm_s"], images_per_s=ref["images_per_s"])
        _say("reference:stage_s", **ref["stage_s"])
        _say("reference:device_ms", traced_pass=p8["device_ms"],
             traced_wall_ms=p8["wall_ms"],
             **{f"{k}_device_ms": p8[f"{k}_ms"] for k in PROFILE_NAMES},
             **{f"{k}_device_events": p8[f"{k}_events"] for k in PROFILE_NAMES},
             top_device=json.dumps(p8["top_device"]))
        _say("reference:idle_share", of_warm_pass=ref["idle_share"])
        # DepthPro35's head alone holds 8 x 1536^2 x 128 bf16 after its
        # transposed convolution.
        _say("reference:max_memory_gb", measured=ref["max_memory_gb"],
             head_deconv_estimate=8 * 1536 ** 2 * 128 * 2 / 1e9)
        if not ref["ok"]:
            raise SystemExit("reference chain: launches, plain calls, failures or scene "
                             "artifacts are not as required (see reference:cold)")
        torch.cuda.empty_cache()

        # 9. The boxes route: depth with the scene PLYs -> boxes (K4) ->
        # export, at the large preset over phase 6's 16 images.
        box = run_boxes_route(tmp)
        _say("boxes:cold", s=box["cold_s"], launches=json.dumps(box["launches"]),
             want=json.dumps(box["want"]), plain_calls=json.dumps(box["plain_calls"]),
             scenes_with_plys=box["scenes_with_plys"],
             scenes_with_boxes=box["scenes_with_boxes"], coco3d_images=box["coco3d_images"])
        _say("boxes:check", **box["check"], box_tol=BOX_TOL, mesh_face_tol=MESH_FACE_TOL)
        _say("boxes:warm", s=box["warm_s"], images_per_s=box["images_per_s"],
             stage_s=json.dumps(box["stage_s"]))
        if not box["ok"]:
            raise SystemExit("boxes route: launches, plain calls, PLYs, scene artifacts or "
                             "the card/CPU checks are not as required (see boxes:*)")
        torch.cuda.empty_cache()

        # 10. The all route at its shipping defaults over phase 7's images.
        # Its traced pass records the device only: host-op tracing makes a
        # chain's traced pass several times longer (phase 7 lists host ops).
        allr = run_registration({}, tmp, name="all", route="all", trace_host=False)
        p10 = allr["profile"]
        _say("all:cold", s=allr["cold_s"], forwards=allr["forwards"],
             launches=json.dumps(allr["launches"]), want=json.dumps(allr["want"]),
             plain_calls=json.dumps(allr["plain_calls"]), failures=json.dumps(allr["failures"]),
             scenes_with_boxes=allr["scenes_with_boxes"], coco3d_images=allr["coco3d_images"],
             f16_overflow_boxes=allr["f16_overflow_boxes"],
             stages_2_to_5=json.dumps(allr["stages_2_to_5"]))
        _say("all:warm", s=allr["warm_s"], images_per_s=allr["images_per_s"],
             stage_s=json.dumps(allr["stage_s"]), max_memory_gb=allr["max_memory_gb"])
        _say("all:profile", traced_wall_ms=p10["wall_ms"], device_ms=p10["device_ms"],
             **{f"{k}_device_ms": p10[f"{k}_ms"] for k in PROFILE_NAMES},
             idle_share_of_warm_pass=allr["idle_share"],
             top_device=json.dumps(p10["top_device"]), top_host=json.dumps(p10["top_host"]))
        if not allr["ok"]:
            raise SystemExit("all route: launches, plain calls, failures, enhanced images, "
                             "crops or scene artifacts are not as required (see all:cold)")
        torch.cuda.empty_cache()

        # 11. TRELLIS, stage 6's obj_rec=trellis: the components at full
        # width on one object, the card against the CPU.
        trel = run_trellis(tmp)
        tcomp = trel["components"]
        torch.cuda.empty_cache()

        # 12. The SD-class stack (stages 2, 4 and 5 at invsr, our, zero123):
        # the components at full width, the all route at the reference's
        # configuration (with obj_rec=trellis), the card against the CPU.
        sd = run_sd(tmp)
        scomp, sroute = sd["components"], sd["route"]
        torch.cuda.empty_cache()

        # 13. Hunyuan3D (stage 6's hunyuan3d and hunyuan3d_carve): the
        # components at full width, the all route with obj_rec=hunyuan3d,
        # the card against the CPU.
        hy = run_hunyuan(tmp)
        hcomp, hroute = hy["components"], hy["route"]
        torch.cuda.empty_cache()

        # 14. Wild mode: SAM ViT-B and SegFormer-B0 components, the fast
        # route with the wild provider, the --wild CLI, the card against
        # the CPU.
        wild = run_wild(tmp)
        torch.cuda.empty_cache()

        # 15. The released-weight workflow: TRELLIS converted into the store
        # at full width, the all route reading it, scoring on the card.
        ckpt = run_ckpt(tmp)
        croute = ckpt["route"]
        shutil.rmtree(ckpt["convert"]["store"])  # 3.42 GB phase 16 has no use for

        # 16. DINOv2-giant through the store, its card against the CPU, the
        # trajectory video of a scene 15(b) placed objects in, and the host
        # leftovers (auction, Procrustes, the native RLE codec, the trace).
        if not croute["placed_scenes"]:
            raise SystemExit("ckpt route: no scene holds a placed mesh for the trajectory")
        giant = run_giant(tmp, croute["placed_scenes"][0])
        torch.cuda.empty_cache()

        # 17. The fine-tuning step: K1's autograd at the train shape, MoGe
        # ViT-L trained at 518 px (and through a one-rank mesh), its
        # gradients on the card against the CPU, the dry run.
        trn = run_train()

    def row(name, source, replaces, launches, r, max_abs_err, **extra):
        return {"name": name, "route": "cuda", "source": f"labelany3d_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                **extra}

    k3_timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ratio_to_library",
                "share_of_bound")
    timed = (*k3_timed, "graph_ms", "library_graph_ms")
    design = ("attention_sm90.cuh: 192-query blocks of three consumer warpgroups and a "
              "TMA producer warpgroup (setmaxnreg 160/24), 128-key K/V tiles in a 4-stage "
              "mbarrier ring, wgmma m64n128k16 QK^T and m64n{d}k16 PV with P from "
              "registers, online softmax in fp32, TMA store; head dim d = 64 (128-byte "
              "swizzle) or 32 (64-byte swizzle) as a template parameter")

    k2, k3, k4 = kc["k2"], kc["k3"], kc["k4"]
    table = {"kernels": [
        row("packed_attention", "packed_attention.cu", "labelany3d_tpu/ops/attention.py:133",
            launches, k1["moge"], max(r["max_abs_err"] for r in k1.values()),
            launches_registration=reg["launches"]["k1"],
            launches_reference_chain=ref["launches"]["k1"],
            launches_boxes_route=box["launches"]["k1"],
            launches_all_route=allr["launches"]["k1"],
            launches_trellis_object=tcomp["launches"]["k1"],
            launches_reference_route=sroute["launches"]["k1"],
            launches_elevation_estimates=scomp["launches"]["k1"],
            launches_wild_route=wild["route"]["launches"]["k1"],
            launches_wild_cli=wild["cli"]["k1_launches"],
            launches_ckpt_route=croute["launches"]["k1"],
            launches_giant_forward=giant["store"]["launches"]["k1"],
            launches_train_step=trn["step"]["k1_launches"],
            backward_calls_train_step=trn["step"]["k1_backward_calls"],
            train={"shape": "B=8 Npad=1408 n_real=1370 H=16 d=64 (MoGe ViT-L at 518 px)",
                   **{k: trn["k1"][k] for k in timed if k in trn["k1"]},
                   "max_abs_err": trn["k1"]["max_abs_err"],
                   "grad_rel_err": trn["grad"]["rel_err"],
                   **{k: trn["grad"][k] for k in ("backward_ms", "library_backward_ms",
                                                  "backward_bound_ms", "backward_bound_by")}},
            shape="MoGe B=8 Npad=1408 n_real=1297 H=16 d=64", design=design,
            ratio_to_library=k1["moge"]["ratio_to_library"],
            share_of_bound=k1["moge"]["share_of_bound"], sass=sass["k1"],
            **{name: {k: k1[name][k] for k in timed if k in k1[name]}
               for name in ("depth_pro", "matcher", "depth_pro35_patch",
                            "depth_pro35_image", "trellis_cond", "elevation_matcher",
                            "giant")}),
        row("flash_attention", "flash_attention.cu", "labelany3d_tpu/ops/attention.py:42",
            reg["launches"]["k2"], k2["path"], max(r["max_abs_err"] for r in k2.values()),
            launches_reference_chain=ref["launches"]["k2"],
            launches_all_route=allr["launches"]["k2"],
            launches_trellis_object=tcomp["launches"]["k2"],
            launches_reference_route=sroute["launches"]["k2"],
            launches_elevation_estimates=scomp["launches"]["k2"],
            launches_svrm_reconstructs=hcomp["launches"]["k2"],
            launches_hunyuan_route=hroute["launches"]["k2"],
            launches_ckpt_route=croute["launches"]["k2"],
            shape="q, k, v (32, 1296, 12, 64) bf16", design=design,
            ratio_to_library=k2["path"]["ratio_to_library"],
            share_of_bound=k2["path"]["share_of_bound"], sass=sass["k2"],
            **{name: {k: k2[name][k] for k in timed if k in k2[name]}
               for name in ("rope_encoder", "rope_encoder_stage_b", "decoder_1024",
                            "stage_b_1024", "trellis_ss_self", "trellis_ss_cross",
                            "trellis_slat_self", "trellis_slat_cross",
                            "trellis_slat_self_unmasked", "elevation_decoder",
                            "svrm_encoder", "svrm_lrm_self", "svrm_lrm_cross")}),
        row("nn_argmax", "nn_argmax.cu", "labelany3d_tpu/ops/reciprocal_nn.py:29",
            reg["launches"]["k3"], k3["path_bf16"], max(r["max_abs_err"] for r in k3.values()),
            launches_reference_chain=ref["launches"]["k3"],
            launches_all_route=allr["launches"]["k3"],
            launches_reference_route=sroute["launches"]["k3"],
            launches_elevation_estimates=scomp["launches"]["k3"],
            launches_ckpt_route=croute["launches"]["k3"],
            shape="query (32, 4096, 24) x bank (32, 262144, 24), bf16 operands",
            design=NN_DESIGN, sass=sass["k3"], share_of_bound=k3["path_bf16"]["share_of_bound"],
            library="none at 32 x 4096 (a 68 GB score matrix); see compact and one_pair",
            # Launches counted by the wrapper in the registration run: at
            # this row's shape, and by (pairs x queries x chunks precision).
            launches_at_shape=k3_launches(reg["k3_by_shape"], STAGE_A_PAIRS, 4096),
            launches_by_shape=json.loads(k3_shapes_json(reg["k3_by_shape"])),
            **{name: {"launches_at_shape": k3_launches(reg["k3_by_shape"], *at),
                      **{k: k3[key].get(k) for k in k3_timed}}
               for name, key, at in (
                   ("compact", "compact_bf16", (STAGE_A_PAIRS, 1024)),
                   ("bf16x3", "path_bf16x3", (STAGE_A_PAIRS, 4096, "bf16x3")),
                   ("stage_b_path", "stage_b_path_bf16", (4, 4096)),
                   ("stage_b_compact", "stage_b_compact_bf16", (4, 1024)),
                   ("one_pair", "one_pair_bf16", (1, 4096)),
                   ("one_pair_bf16x3", "one_pair_bf16x3", (1, 4096, "bf16x3")))},
            # Stage 5's elevation matcher: launches at this shape in the
            # reference route (12(c)) and the components' estimates (12(b)).
            elevation={"launches_reference_route": k3_launches(
                           sroute["k3_by_shape"], 1, ELEVATION_STARTS),
                       "launches_elevation_estimates": k3_launches(
                           scomp["k3_by_shape"], 1, ELEVATION_STARTS),
                       "shape": f"query (1, {ELEVATION_STARTS}, {ELEVATION_DESC}) x bank "
                                f"(1, {ELEVATION_VIEW ** 2}, {ELEVATION_DESC}), bf16 operands",
                       "max_abs_err": k3["elevation_bf16"]["max_abs_err"],
                       **{k: k3["elevation_bf16"][k] for k in timed}}),
        row("yaw_minarea", "yaw_minarea.cu", "labelany3d_tpu/ops/boxfit_pallas.py:54",
            reg["launches"]["k4"], k4["layout"], max(r["max_abs_err"] for r in k4.values()),
            launches_reference_chain=ref["launches"]["k4"],
            shape="points (16, 500, 2), 512 angles", design=YAW_DESIGN,
            timing="device time from CUDA-graph replays; eager_ms is the eager call's",
            eager_ms=k4["layout"]["eager_ms"],
            launches_all_route=allr["launches"]["k4"],
            launches_boxes_route=box["launches"]["k4"],
            launches_ckpt_route=croute["launches"]["k4"],
            fast={"launches_boxes_route": box["launches"]["k4"],
                  **{k: k4["fast"][k]
                     for k in ("ms", "plain_ms", "eager_ms", "bound_ms", "bound_by")}}),
    ]}
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
