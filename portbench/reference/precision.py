"""Precision switches of the frozen reference.

`full_f32()` turns TF32 off for matmuls and cuDNN convolutions (a copy of
the port's `utils/precision.py`). `lower(kind)` selects the control: the
same reference computed one step below the precision that the
configuration states. With `"fp8"` every operand of a product (a Dense, a
convolution, the two attention products) is rounded to float8 e4m3 under a
per-tensor scale before the float32 product, as an fp8 path would feed the
tensor cores; with `"tf32"` the float32 products that `full_f32()` pins run
in TF32 instead.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_LOWER: list[str] = []   # the active control's kind, innermost last
FP8_MAX = 448.0          # largest finite float8 e4m3fn


@contextlib.contextmanager
def lower(kind: str):
    """Run the reference as the control: `kind` is "fp8" or "tf32"."""
    if kind not in ("fp8", "tf32"):
        raise ValueError(f"unknown control precision {kind!r}")
    _LOWER.append(kind)
    try:
        yield
    finally:
        _LOWER.pop()


def active() -> str | None:
    return _LOWER[-1] if _LOWER else None


def operand(t: torch.Tensor) -> torch.Tensor:
    """A product's operand as the active precision holds it: unchanged, or
    rounded through float8 e4m3 under a per-tensor scale (float32 out)."""
    if active() != "fp8" or not t.is_floating_point():
        return t
    x = t.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    # The rounded value forward; the gradient passes to x unchanged.
    return x + (q - x).detach() if x.requires_grad else q


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for matmuls and cuDNN convolutions, then restore; on
    under the "tf32" control."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = active() == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
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


def tensors_on(*xs, device=None, dtype: torch.dtype | None = torch.float32) -> list:
    """Each of `xs` as a `dtype` tensor on one device: `device` when given,
    else the first tensor's, else the CPU. `None` stays `None`."""
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)), "cpu")
    return [None if x is None else torch.as_tensor(x, dtype=dtype, device=device) for x in xs]
