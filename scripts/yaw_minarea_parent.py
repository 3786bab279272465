#!/usr/bin/env python3
"""K4 (`csrc/yaw_minarea.cu`) against another version of its source, on one timer.

    python3 scripts/yaw_minarea_parent.py OTHER_TREE

builds `OTHER_TREE/labelany3d_tpu_torch/csrc/yaw_minarea.cu` (for example
the parent commit, unpacked by `git archive` into a git-ignored directory
such as `build/parent`) and this tree's source with the same nvcc flags,
checks both against the plain version, and times both through the same
wrapper (`ops/boxfit_yaw.py::yaw_minarea`) at the layout stage's shape
(16, 500, 2) and the `fast` check's (128, 512, 2), 512 angles, in the order
other, this, this, other. Two timers, as `chip_smoke.py` uses them: device
time from the replay of a CUDA graph of 20 calls (`time_cuda_graph`), and
CUDA events around 20 eager calls (`time_cuda`), which also holds the
host's work per call. The C entry points must agree (`yaw_minarea_fwd`).

Builds go to `build/yaw_parent/` (git-ignored); needs nvcc and one GPU.
Prints one JSON line per build and round, then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = Path("labelany3d_tpu_torch") / "csrc" / "yaw_minarea.cu"
SHAPES = {"layout": (16, 500), "fast": (128, 512)}
NUM_ANGLES = 512


def build(name: str, source: Path, out: Path):
    """nvcc `source` into out/name and bind its entry point."""
    from labelany3d_tpu_torch.ops import build as kbuild

    lib_path = out / name / "libyaw_minarea.so"
    lib_path.parent.mkdir(parents=True)
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib_path), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).yaw_minarea_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    from chip_smoke import time_cuda, time_cuda_graph
    from labelany3d_tpu_torch.ops import boxfit_yaw as by

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]) / SOURCE
    if not other.exists():
        print(f"yaw_minarea_parent: {other} not found", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("yaw_minarea_parent: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "yaw_parent"
    shutil.rmtree(out, ignore_errors=True)
    libs = {"other": build("other", other, out), "this": build("this", ROOT / SOURCE, out)}

    g = torch.Generator(device="cuda").manual_seed(31)
    inputs = {}
    for name, (i, n) in SHAPES.items():
        pts = torch.randn(i, n, 2, device="cuda", generator=g) * torch.tensor([2.0, 0.5],
                                                                              device="cuda")
        valid = torch.rand(i, n, device="cuda", generator=g) > 0.3
        valid[0] = False
        inputs[name] = (pts, valid, by.yaw_minarea_reference(pts, valid, NUM_ANGLES))

    for round_, which in enumerate(("other", "this", "this", "other")):
        by._lib = lambda fn=libs[which]: fn  # the wrapper launches this build
        res = {"build": which, "round": round_}
        for name, (pts, valid, ref) in inputs.items():
            yaw = by.yaw_minarea(pts, valid, NUM_ANGLES)
            vm = valid.to(torch.uint8)
            res[name] = {
                "yaw_equal": bool(torch.equal(yaw, ref)),
                "graph_ms": time_cuda_graph(lambda: by.yaw_minarea(pts, vm, NUM_ANGLES)),
                "eager_ms": time_cuda(lambda: by.yaw_minarea(pts, valid, NUM_ANGLES)),
            }
        print(json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
