#!/usr/bin/env python3
"""Does the MoGe ViT-L train step repeat bit for bit on the card?

    python3 scripts/train_repeatability.py

Builds `MoGeModel(MoGeConfig.vitl())` at 518 px on the card, then runs two
train steps (`parallel.train`, batch 8, `chip_smoke.train_batch`) twice
from the same start, and prints the losses and the relative L2 between the
two runs' parameters, for the head as it is (the JAX package's tap-matrix
resize and an edge pad from concatenated slices) and for the head's former
form (`F.interpolate` and `F.pad(mode="replicate")`, whose CUDA backward
adds with atomics), patched in for the second variant. A step that does not
repeat cannot be held to another one (phase 17's mesh check) more tightly
than its own spread. Builds the kernels first (needs nvcc and one GPU).
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def interpolate_pad(x, out_hw, pad=1):
    """The head's former resize: bilinear `F.interpolate`, then a replicate
    pad."""
    import torch.nn.functional as F

    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)
    return F.pad(x, (pad,) * 4, mode="replicate")


def conv3_replicate(self, x):
    """`Conv3Replicate.forward` with `F.pad(mode="replicate")`."""
    import torch.nn.functional as F

    from labelany3d_tpu_torch.models.layers import Conv

    return Conv.forward(self, F.pad(x, (1, 1, 1, 1), mode="replicate"))


def two_runs(model, start, batch) -> dict:
    import torch

    from labelany3d_tpu_torch.parallel.train import init_train_state, make_train_step

    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        state, opt = init_train_state(model)
        step = make_train_step(model, opt)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, loss = step(state, *batch)
            losses.append(float(loss))
        torch.cuda.synchronize()
        runs.append((losses, {k: p.detach().clone() for k, p in model.named_parameters()},
                     time.perf_counter() - t0))
    (l0, p0, s0), (l1, p1, s1) = runs
    num = sum(float((p0[k] - p1[k]).norm()) ** 2 for k in p0) ** 0.5
    den = sum(float(p.norm()) ** 2 for p in p0.values()) ** 0.5
    return {"losses": [l0, l1], "param_rel": num / den, "two_steps_s": [s0, s1]}


def main() -> None:
    import torch

    import chip_smoke as cs
    from labelany3d_tpu_torch.models import layers, moge
    from labelany3d_tpu_torch.ops import build
    from labelany3d_tpu_torch.parallel.train import init_train_state

    build.build_all()
    hw = (cs.TRAIN_SIZE, cs.TRAIN_SIZE)
    batch = [torch.as_tensor(a, device="cuda") for a in cs.train_batch()]
    with torch.device("cuda"):
        model = moge.MoGeModel(cs.train_config(), hw)
    init_train_state(model, torch.Generator(device="cuda").manual_seed(171))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    x = torch.randn(8, 130, 296, 296, device="cuda").bfloat16()
    a, b = interpolate_pad(x, hw).float(), moge._resize_bilinear_pad(x, hw).float()
    print(json.dumps({"resize_bf16_rel": float((a - b).norm() / a.norm())}), flush=True)
    print(json.dumps({"variant": "head as it is", **two_runs(model, start, batch)}), flush=True)
    moge._resize_bilinear_pad, layers.Conv3Replicate.forward = interpolate_pad, conv3_replicate
    print(json.dumps({"variant": "F.interpolate and F.pad(replicate)",
                      **two_runs(model, start, batch)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
