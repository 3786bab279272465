"""Model FLOPs of a forward pass, counted from the configuration's shapes.

The plain reference model is built on the meta device and run once under
`torch.utils.flop_counter.FlopCounterMode`, which counts every product
(linear layers, convolutions, transposed convolutions, the attention's
two products over the real tokens) from its shapes: two operations a
multiply-add, nothing computed.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(model, *inputs) -> float:
    """FLOPs of `model(*inputs)` on meta tensors of the given shapes."""
    args = [torch.empty(shape, device="meta") for shape in inputs]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(*args)
    return float(fc.get_total_flops())
