#!/usr/bin/env python3
"""Where the time of the two flash-attention kernels (K1, K2) goes, on the card.

    python3 scripts/attention_ablation.py

builds K1 (`csrc/packed_attention.cu`) and K2 (`csrc/flash_attention.cu`)
several times, each from a copy of `csrc/` whose shared main loop
(`attention_sm90.cuh`) has one piece taken out or one setting changed, and
times every build at the path shapes in turns (two rounds), beside the
PyTorch yardstick (`scaled_dot_product_attention`, with the key mask for
K1). Only the `base` build computes the right function: the others measure
what the removed piece costs, or what another setting would give.

Variants:
  base            the kernels as they are
  no_exp          ex2 replaced by the identity (the exponential units' share)
  no_softmax      no softmax at all (loads and products only)
  no_products     no QK^T or PV in the loop (loads and softmax only)
  two_warpgroups  128-query blocks of two consumer warpgroups
  stages_2/3/6    a K/V ring of 2, 3 or 6 stages instead of 4

Builds go to `build/ablation/` (git-ignored); needs nvcc and one GPU.
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HEADER = "attention_sm90.cuh"
VARIANTS = {
    "base": [],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x;")],
    "no_softmax": [("    softmax_tile(kt);\n", ""), ("  softmax_tile(n_tiles - 1);\n", "")],
    "no_products": [("    issue_pv(kt);\n    issue_qk(sc, dq, sw128_desc(sk0 + kTileBytes * "
                     "(nx % kStages)));\n", "")],
    "two_warpgroups": [
        ("constexpr int kConsumerWGs = 3;", "constexpr int kConsumerWGs = 2;"),
        ("constexpr int kConsumerRegs = 160;", "constexpr int kConsumerRegs = 208;")],
    **{f"stages_{n}": [("constexpr int kStages = 4;", f"constexpr int kStages = {n};")]
       for n in (2, 3, 6)},
}
# (name, batch, rows, real keys) of K1 and (name, pairs, Sq = Sk) of K2, as
# the main path launches them; 16 heads of 64 for K1, 12 for K2.
K1_SHAPES = [("k1_moge", 8, 1408, 1297), ("k1_depth_pro", 40, 384, 325),
             ("k1_matcher", 36, 1408, 1297)]
K2_SHAPES = [("k2_decoder", 32, 1296)]


def build_variant(name: str, out: Path) -> dict:
    """Copy csrc/ with the variant's edits into out/name and build K1, K2."""
    from labelany3d_tpu_torch.ops import build

    d = out / name
    shutil.copytree(build.CSRC, d)
    header = (d / HEADER).read_text()
    for old, new in VARIANTS[name]:
        if old not in header:
            raise RuntimeError(f"variant {name}: {old!r} not found in {HEADER}")
        header = header.replace(old, new)
    (d / HEADER).write_text(header)
    logs = {}
    for src in ("packed_attention", "flash_attention"):
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
        logs[src] = " | ".join(ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                               if "registers" in ln or "spill" in ln or "C75" in ln)
    return logs


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import time_cuda

    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "ablation"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        logs = dict(zip(VARIANTS, pool.map(lambda n: build_variant(n, out), VARIANTS)))
    build_s = time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    calls, yardsticks = {}, {}
    for name, b, n_pad, n_real in K1_SHAPES:
        qkv = torch.randn(b, n_pad, 3 * 1024, device="cuda", generator=g).bfloat16()
        o = torch.empty(b, n_pad, 1024, device="cuda", dtype=torch.bfloat16)
        calls[name] = (qkv, o, (b, n_pad, 16, 64, n_real, 0.125, stream))
        q, k, v = (qkv[..., i * 1024:(i + 1) * 1024].view(b, n_pad, 16, 64).transpose(1, 2)
                   for i in range(3))
        mask = (torch.arange(n_pad, device="cuda") < n_real).view(1, 1, 1, n_pad)
        yardsticks[name] = time_cuda(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                              attn_mask=mask))
    for name, p, s in K2_SHAPES:
        q, k, v = (torch.randn(p, s, 12, 64, device="cuda", generator=g).bfloat16()
                   for _ in range(3))
        o = torch.empty_like(q)
        calls[name] = ((q, k, v), o, (None, p, s, s, 12, 64, *q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3], 0.125, stream))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        yardsticks[name] = time_cuda(lambda: F.scaled_dot_product_attention(qt, kt, vt))

    def runner(variant: str, shape: str):
        d = out / variant
        if shape.startswith("k1"):
            fn = ctypes.CDLL(str(d / "libpacked_attention.so")).packed_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
            qkv, o, args = calls[shape]
            return lambda: fn(qkv.data_ptr(), o.data_ptr(), *args)
        fn = ctypes.CDLL(str(d / "libflash_attention.so")).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        (q, k, v), o, args = calls[shape]
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *args)

    ms = {v: {s: [] for s in calls} for v in VARIANTS}
    for _ in range(2):
        for variant in VARIANTS:
            for shape in calls:
                ms[variant][shape].append(time_cuda(runner(variant, shape)))
    for variant in VARIANTS:
        print(json.dumps({"variant": variant, "ms": ms[variant],
                          "ratio_to_library": {s: min(t) / yardsticks[s]
                                               for s, t in ms[variant].items()},
                          "ptxas": logs[variant]}), flush=True)
    print(json.dumps({"library_ms": yardsticks, "build_s": build_s}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
