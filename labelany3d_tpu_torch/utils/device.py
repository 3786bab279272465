"""Device resolution: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for and absent: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "labelany3d_tpu_torch needs a CUDA device (pass device='cpu' to "
            "run the plain PyTorch path on the CPU)")
    return dev
