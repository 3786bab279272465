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


def tensors_on(*xs, device: str | torch.device | None = None,
               dtype: torch.dtype | None = torch.float32) -> list:
    """Each of `xs` as a `dtype` tensor on one device: `device` when given,
    else the first tensor's among `xs`, else CUDA (`resolve_device`). So a
    function given tensors computes where they live, and one given numpy
    arrays computes on the card unless the caller asks for the CPU. `None`
    stays `None`; `dtype=None` keeps each input's dtype."""
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = resolve_device(device)
    return [None if x is None else torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]
