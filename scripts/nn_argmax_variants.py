#!/usr/bin/env python3
"""K3 (`csrc/nn_argmax.cu`) in other shapes of its design, timed on the card.

    python3 scripts/nn_argmax_variants.py

builds the reciprocal-NN argmax kernel several times, each from a copy of
`csrc/` with one setting changed, checks every build against the plain
version at a small shape, and times every build at the registration path's
shapes in turns (two rounds), in bf16: the full round of a stage-A matcher
forward (32 pairs x 4096 queries x 262144 bank rows), its compacted rounds
(32 x 1024), the same two rounds of a stage-B forward (4 pairs) and one
pair.

Variants (no_fold and no_products take a piece out and compute the wrong
function; they measure what the piece costs):
  base         the kernel as it is
  no_fold      no argmax epilogue (loads and products only)
  no_products  no wgmma (loads and epilogue only)
  stages_4     a bank ring of 4 stages instead of 8
  no_split     the bank never split over blocks (one chunk at every shape)

Builds go to `build/nn_variants/` (git-ignored); needs nvcc and one GPU.
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = "nn_argmax.cu"
FOLD = "    fold_sub<decltype(masked)::value>(acc, col0, n_real, best, bidx);"
ISSUE = "    issue_sub<kX3>(acc, qh, ql, addr);\n"
VARIANTS = {
    "base": [],
    "no_fold": [(FOLD, "    best[0] = fmaxf(best[0], acc[0]);")],
    "no_products": [(ISSUE, "")],
    "stages_4": [("constexpr int kStages = 8;", "constexpr int kStages = 4;")],
    "no_split": [("constexpr int kMaxSplit = 16;", "constexpr int kMaxSplit = 1;")],
}
# (name, pairs, queries) at 512 x 512 banks, as the registration path runs them.
SHAPES = [("full", 32, 4096), ("compact", 32, 1024), ("stage_b_path", 4, 4096),
          ("stage_b_compact", 4, 1024), ("one_pair", 1, 4096)]
N = 512 * 512


def build_variant(name: str, out: Path) -> str:
    """Copy csrc/ with the variant's edits into out/name and build K3."""
    from labelany3d_tpu_torch.ops import build

    d = out / name
    shutil.copytree(build.CSRC, d)
    src = (d / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not found in {SOURCE}")
        src = src.replace(old, new)
    (d / SOURCE).write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(d / "libnn_argmax.so"), str(d / SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return " | ".join(ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                      if "registers" in ln or "spill" in ln or "C75" in ln)


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import time_cuda
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    if not torch.cuda.is_available():
        print("nn_argmax_variants: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "nn_variants"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        logs = dict(zip(VARIANTS, pool.map(lambda n: build_variant(n, out), VARIANTS)))
    build_s = time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(0)

    def operands(pairs, s, n):
        q = F.normalize(torch.randn(pairs, s, 24, device="cuda", generator=g), dim=-1)
        bank = F.normalize(torch.randn(pairs, n, 24, device="cuda", generator=g), dim=-1)
        prep, _ = rnn.prepare_bank_for_nn(bank)
        return F.pad(q, (0, 8)).contiguous(), prep, bank

    inputs = {name: operands(p, s, N) for name, p, s in SHAPES}
    small = operands(2, 300, 5000)

    def runner(variant: str, q, prep, n_real):
        lib = ctypes.CDLL(str(out / variant / "libnn_argmax.so"))
        lib.nn_argmax_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.nn_argmax_chunks.argtypes = [ctypes.c_int] * 3
        p, s, _ = q.shape
        chunks = lib.nn_argmax_chunks(p, s, n_real)
        idx = torch.empty(p, s, dtype=torch.int32, device="cuda")
        best = torch.empty(p, s, device="cuda")
        pi = torch.empty(chunks, p, s, dtype=torch.int32, device="cuda")
        pb = torch.empty(chunks, p, s, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.nn_argmax_fwd(q.data_ptr(), prep.data_ptr(), idx.data_ptr(), best.data_ptr(),
                                    pi.data_ptr(), pb.data_ptr(), p, s, prep.shape[1], n_real, 32,
                                    0, stream)
            if err:
                raise RuntimeError(f"{variant}: CUDA error {err}")
            return idx, best
        call.chunks = chunks
        return call

    checks = {}
    for variant in VARIANTS:
        q, prep, bank = small
        idx, best = runner(variant, q, prep, 4963)()
        ref_idx, ref_best = rnn.nn_argmax_reference(q, F.pad(bank, (0, 8)), 4963)
        torch.cuda.synchronize()
        checks[variant] = {"max_abs_err": float((best - ref_best).abs().max()),
                           "idx_differ": int((idx != ref_idx).sum())}
    ms = {v: {s: [] for s, _, _ in SHAPES} for v in VARIANTS}
    chunks = {v: {} for v in VARIANTS}
    for _ in range(2):
        for variant in VARIANTS:
            for name, _, _ in SHAPES:
                q, prep, _ = inputs[name]
                call = runner(variant, q, prep, N)
                chunks[variant][name] = call.chunks
                ms[variant][name].append(time_cuda(call))
    for variant in VARIANTS:
        print(json.dumps({"variant": variant, "ms": ms[variant], "chunks": chunks[variant],
                          "check": checks[variant], "ptxas": logs[variant]}), flush=True)
    print(json.dumps({"build_s": build_s}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
