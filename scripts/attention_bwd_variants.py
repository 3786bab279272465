#!/usr/bin/env python3
"""Where the time of the attention backward kernels goes, on the card.

    python3 scripts/attention_bwd_variants.py

builds K1 (`csrc/packed_attention.cu`) and K2 (`csrc/flash_attention.cu`)
once for each variant below, each from a copy of `csrc/` whose backward
(`attention_bwd_sm90.cuh`: the dQ and the dK/dV kernel) has one setting
changed or one piece taken out, and times one whole backward call (both
kernels) of every build at the path shapes in turns (two rounds), with
each kernel's device time from a trace, beside SDPA's backward (the
yardstick). Every variant but `no_exp` computes the same function, and
the script checks that each gives the repository build's gradients bit for
bit; `no_exp` measures what the exponentials cost.

Variants:
  base        the kernels as they are
  no_turns    the two consumer warpgroups issue their products without
              taking turns (no ping-pong barriers)
  kv_regs     dK/dV: K and V held as A fragments in registers (ldmatrix once),
              so S^T and dP^T read only Q and dO from shared memory
  stages_2/4  a ring of 2 or 4 stages instead of 3
  no_exp      exp2 replaced by the identity

Builds go to `build/bwd_variants/` (git-ignored); needs nvcc and one GPU.
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

HEADER = "attention_bwd_sm90.cuh"
_ARRIVE = ("namespace attn_bwd {\n",
           "namespace attn_bwd {\n__device__ __forceinline__ void named_arrive(int id, int n) {\n"
           "  asm volatile(\"bar.arrive %0, %1;\\n\" ::\"r\"(id), \"r\"(n) : \"memory\");\n}\n")
# dK/dV: K and V as A fragments in registers (ldmatrix from the swizzled
# tiles once), so S^T and dP^T read only Q and dO from shared memory.
_KV_REGS = [
    ("// ------------------------------------------------------------- kernels ---\n",
     """__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], uint32_t tile, int warp,
                                             int lane) {
  const int mi = lane >> 3;
  const int row = 16 * warp + (lane & 7) + 8 * (mi & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(a[kk], tile + row * (D * 2) + (Tiles<D>::chunk(2 * kk + (mi >> 1), row & 7) << 4));
  }
}
template <bool First>
__device__ __forceinline__ void wgmma_m64n64k16_rk(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (First) {
    asm volatile(
      "{\\n .reg .pred p;\\n setp.ne.b32 p, %37, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  } else {
    asm volatile(
      "{\\n .reg .pred p;\\n setp.ne.b32 p, %37, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
template <int D>
__device__ __forceinline__ void issue_nt64r(float (&acc)[32], const uint32_t (&a)[D / 16][4],
                                            uint64_t db) {
  wgmma_m64n64k16_rk<true>(acc, a[0], db);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_m64n64k16_rk<false>(acc, a[kk], db + 2 * kk);
}

// ------------------------------------------------------------- kernels ---
"""),
    ("    issue_nt64<D>(st, dk_desc, T::desc(sq0 + S::kQBytes * s));\n"
     "    issue_nt64<D>(dpt, dv_desc, T::desc(sdo0 + S::kQBytes * s));\n",
     "    issue_nt64r<D>(st, kf, T::desc(sq0 + S::kQBytes * s));\n"
     "    issue_nt64r<D>(dpt, vf, T::desc(sdo0 + S::kQBytes * s));\n"),
    ("  uint32_t pa[16], dsa[16];",
     "  uint32_t kf[D / 16][4], vf[D / 16][4];\n  uint32_t pa[16], dsa[16];"),
    ("  mbar_wait(kv_full, 0);\n  arrive(0);\n",
     "  mbar_wait(kv_full, 0);\n"
     "  load_a_frags<D>(kf, sk_wg, t >> 5, lane);\n  load_a_frags<D>(vf, sv_wg, t >> 5, lane);\n"
     "  arrive(0);\n"),
]
VARIANTS = {
    "base": [],
    "no_turns": [
        ("  auto my_turn = [&]() { named_sync(kTurn + wg, kConsumers); };\n"
         "  auto pass_turn = [&]() { named_arrive(kTurn + 1 - wg, kConsumers); };\n",
         "  auto my_turn = [&]() {};\n  auto pass_turn = [&]() {};\n"),
        ("  const bool turns = active == kConsumerWGs;\n", "  const bool turns = false;\n")],
    "kv_regs": _KV_REGS,
    **{f"stages_{n}": [("constexpr int kStages = 3;", f"constexpr int kStages = {n};")]
       for n in (2, 4)},
    "no_exp": [("const float p = ex2(fmaf(", "const float p = (fmaf(")],
}
# (name, kind, shape): K1's backward at the train step, K2's at the rope
# encoder, the TRELLIS SLat torso (1024 keys masked) and the SS cross.
SHAPES = [("train", "k1", (8, 1408, 1370, 16)), ("rope", "k2", (36, 1024, 1024, 16, 0)),
          ("torso", "k2", (2, 8192, 8192, 16, 1024)), ("ss_cross", "k2", (2, 4096, 1374, 16, 0))]


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
                               if "spill" in ln or "arning" in ln)[:400]
    return logs


def main() -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import PROFILE_NAMES, profile_pass, time_cuda
    from labelany3d_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        print("attention_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "bwd_variants"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        logs = dict(zip(VARIANTS, pool.map(lambda n: build_variant(n, out), VARIANTS)))
    build_s = time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    calls, yardsticks, wants = {}, {}, {}
    for name, kind, shape in SHAPES:
        if kind == "k1":
            b, n_pad, n_real, h = shape
            w = 64 * h
            qkv = torch.randn(b, n_pad, 3 * w, device="cuda", generator=g).bfloat16()
            out_, lse = att.packed_sdpa_kernel(qkv, h, n_real, lse=True)
            cot = torch.randn(b, n_pad, w, device="cuda", generator=g).bfloat16()
            rows = att._row_scratch(b, h, n_pad, "cuda")
            dqkv = torch.empty_like(qkv)
            calls[name] = ("k1", (qkv, out_, cot, lse, rows[0], rows[1], dqkv),
                           (b, n_pad, h, 64, n_real, 0.125, stream))
            wants[name] = att.packed_sdpa_backward_kernel(qkv, out_, cot, lse, h, n_real)
            q, k, v = (qkv[..., i * w:(i + 1) * w].view(b, n_pad, h, 64).transpose(1, 2)
                       .detach().requires_grad_() for i in range(3))
            mask = (torch.arange(n_pad, device="cuda") < n_real).view(1, 1, 1, n_pad)
            go = cot.view(b, n_pad, h, 64).transpose(1, 2)
        else:
            b, sq, sk, h, pad = shape
            q, k, v = (torch.randn(b, s, h, 64, device="cuda", generator=g).bfloat16()
                       for s in (sq, sk, sk))
            seg = None
            if pad:
                seg = torch.zeros(b, sk, dtype=torch.int32, device="cuda")
                seg[:, sk - pad:] = 1
            ids = None if seg is None else seg.contiguous()
            out_, lse = att.flash_sdpa_kernel(q, k, v, seg, lse=True)
            cot = torch.randn(b, sq, h, 64, device="cuda", generator=g).bfloat16()
            rows = att._row_scratch(b, h, sq, "cuda")
            grads = [torch.empty((b, s, h, 64), device="cuda", dtype=torch.bfloat16)
                     for s in (sq, sk, sk)]
            calls[name] = ("k2", (q, k, v, out_, cot, lse, rows[0], rows[1], ids, *grads),
                           (b, sq, sk, h, 64, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                            *out_.stride()[:3], *cot.stride()[:3], 0.125, stream))
            wants[name] = torch.cat([t.flatten() for t in att.flash_sdpa_backward_kernel(
                q, k, v, out_, lse, cot, seg)])
            mask = None if seg is None else (seg == 0)[:, None, None, :]
            q, k, v = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            go = cot.transpose(1, 2)
        sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        yardsticks[name] = time_cuda(
            lambda: torch.autograd.grad(sdpa, (q, k, v), go, retain_graph=True))
        del sdpa

    def runner(variant: str, shape: str):
        kind, tensors, args = calls[shape]
        lib = ctypes.CDLL(str(out / variant / ("libpacked_attention.so" if kind == "k1"
                                               else "libflash_attention.so")))
        if kind == "k1":
            fn = lib.packed_attention_bwd
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
        else:
            fn = lib.flash_attention_bwd
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 15 + [ctypes.c_float, ctypes.c_void_p])
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        return lambda: fn(*ptrs, *args)

    def result(shape):
        kind, tensors, _ = calls[shape]
        if kind == "k1":
            return tensors[-1]
        return torch.cat([t.flatten() for t in tensors[-3:]])

    ms = {v: {s: [] for s in calls} for v in VARIANTS}
    kernels, same = {v: {} for v in VARIANTS}, {v: {} for v in VARIANTS}
    for rnd in range(2):
        for variant in VARIANTS:
            for shape in calls:
                run = runner(variant, shape)
                ms[variant][shape].append(time_cuda(run))
                if rnd == 0:
                    torch.cuda.synchronize()
                    same[variant][shape] = bool(torch.equal(result(shape), wants[shape]))
                    p = profile_pass(lambda: [run() for _ in range(10)], host=False)
                    kernels[variant][shape] = {
                        k: p[f"bwd_{k}_ms"] / max(1, p[f"bwd_{k}_events"]) for k in ("dq", "dkdv")}
    for variant in VARIANTS:
        print(json.dumps({"variant": variant, "ms": {s: min(t) for s, t in ms[variant].items()},
                          "kernel_ms": kernels[variant],
                          "ratio_to_library": {s: min(t) / yardsticks[s]
                                               for s, t in ms[variant].items()},
                          "equal_to_base_build": same[variant], "ptxas": logs[variant]}),
              flush=True)
    print(json.dumps({"library_ms": yardsticks, "build_s": build_s,
                      "profile_names": [PROFILE_NAMES["bwd_dq"], PROFILE_NAMES["bwd_dkdv"]]}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
