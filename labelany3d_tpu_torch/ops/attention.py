"""Self-attention straight from the packed (B, Npad, 3W) qkv tensor.

Counterpart of `labelany3d_tpu/ops/attention.py::packed_flash_sdpa`. On a
CUDA tensor `packed_sdpa` launches the hand-written Hopper kernel
`csrc/packed_attention.cu`; on a CPU tensor it runs the plain PyTorch
version `packed_sdpa_reference`. There is no other fallback: a CUDA tensor
the kernel does not take raises.

Semantics: q, k and v are the column ranges [0, W), [W, 2W), [2W, 3W);
keys at index >= n_real are masked; scale 1/sqrt(d); fp32 softmax. Pad
V rows never reach a real output, whatever they hold.
"""

from __future__ import annotations

import ctypes

import torch


class LaunchCounter:
    """A plain count of kernel launches (or plain-version calls)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


# Launches of the CUDA kernel, and calls of the plain version; a run reads
# them to show which path the model went through.
KERNEL_LAUNCHES = LaunchCounter()
PLAIN_CALLS = LaunchCounter()

_SOURCE = "packed_attention"
_KERNEL_HEAD_DIM = 64


def packed_sdpa_reference(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """Plain PyTorch version: split -> heads -> masked softmax attention in
    fp32 -> merge. Returns `qkv.dtype`."""
    PLAIN_CALLS.count += 1
    b, n_pad, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    x = qkv.float()

    def heads(t):  # (B, N, W) -> (B, H, N, d)
        return t.reshape(b, n_pad, num_heads, d).transpose(1, 2)

    q, k, v = heads(x[..., :w]), heads(x[..., w:2 * w]), heads(x[..., 2 * w:])
    if n_real < n_pad:
        # Zero the pad keys' values: p = 0 times a NaN would still be NaN.
        v = v.clone()
        v[:, :, n_real:] = 0.0
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / float(d) ** 0.5)
    if n_real < n_pad:
        s[..., n_real:] = float("-inf")
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v)
    return out.transpose(1, 2).reshape(b, n_pad, w).to(qkv.dtype)


def _lib():
    from labelany3d_tpu_torch.ops import build

    lib = build.load(_SOURCE)
    fn = lib.packed_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def packed_sdpa_kernel(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if qkv.device.type != "cuda":
        raise ValueError(f"packed attention kernel needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"packed attention kernel takes bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, Npad, 3W), got {tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    b, n_pad, w3 = qkv.shape
    w = w3 // 3
    if w % num_heads:
        raise ValueError(f"width {w} is not divisible by {num_heads} heads")
    d = w // num_heads
    if d != _KERNEL_HEAD_DIM:
        raise ValueError(f"packed attention kernel is built for head dim "
                         f"{_KERNEL_HEAD_DIM}, got {d}")
    if n_pad % 64 or not 1 <= n_real <= n_pad:
        raise ValueError(f"need Npad % 64 == 0 and 1 <= n_real <= Npad, got "
                         f"Npad={n_pad}, n_real={n_real}")
    out = torch.empty((b, n_pad, w), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(qkv.data_ptr(), out.data_ptr(), b, n_pad, num_heads, d,
                     n_real, 1.0 / float(d) ** 0.5, stream)
    if err:
        raise RuntimeError(f"packed attention kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.count += 1
    return out


def packed_sdpa(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """(B, Npad, 3W) packed qkv -> (B, Npad, W) attention output.

    CPU tensors take the plain version; CUDA tensors the kernel (or raise).
    """
    if qkv.device.type == "cpu":
        return packed_sdpa_reference(qkv, num_heads, n_real)
    return packed_sdpa_kernel(qkv, num_heads, n_real)
