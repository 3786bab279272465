"""Full-float32 matmul/convolution control for the geometric core.

Counterpart of `labelany3d_tpu/utils/precision.py::f32_precision`. On the
GPU a float32 matmul may run in TF32 (`torch.backends.cuda.matmul.allow_tf32`)
and a float32 convolution does by default (`torch.backends.cudnn.allow_tf32`).
TF32 keeps about three decimal digits, which is ruinous for pose and box
geometry, so geometry entry points run with both switched off.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for matmuls and cuDNN convolutions, then restore."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def f32_precision(fn):
    """Decorator: run `fn` under `full_f32()`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    return wrapper
