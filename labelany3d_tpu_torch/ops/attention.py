"""Attention: packed self-attention (K1) and (B, S, H, D) attention (K2).

Counterparts of `labelany3d_tpu/ops/attention.py`:

  packed_sdpa  <- packed_flash_sdpa: self-attention straight from the packed
                  (B, Npad, 3W) qkv tensor; q, k and v are the column ranges
                  [0, W), [W, 2W), [2W, 3W); keys >= n_real are masked.
                  Kernel `csrc/packed_attention.cu`.
  flash_sdpa   <- flash_sdpa: q (B, Sq, H, D) against k, v (B, Sk, H, D),
                  Sq and Sk free to differ; optional segment ids mask keys.
                  Kernel `csrc/flash_attention.cu`.

Both scale by 1/sqrt(d) and take the softmax in fp32. On a CUDA tensor each
launches its hand-written Hopper kernel; on a CPU tensor it runs its plain
PyTorch version. There is no other fallback: a CUDA tensor a kernel does
not take raises. Masked (pad) V rows never reach an output, whatever they
hold.
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


# K2: launches of csrc/flash_attention.cu and calls of its plain version.
FLASH_LAUNCHES = LaunchCounter()
FLASH_PLAIN_CALLS = LaunchCounter()


def _key_mask(segment_ids: torch.Tensor | None, q: torch.Tensor, k: torch.Tensor):
    """(B, Sk) bool of the real keys, or None. Segment ids mask keys only
    (0 = real), and only for self-attention (Sq == Sk), as the JAX
    package's non-TPU path does."""
    if segment_ids is None:
        return None
    if q.shape[1] != k.shape[1]:
        raise ValueError("segment_ids need Sq == Sk (they mask the keys of a "
                         f"self-attention), got Sq={q.shape[1]}, Sk={k.shape[1]}")
    if tuple(segment_ids.shape) != (k.shape[0], k.shape[1]):
        raise ValueError(f"segment_ids must be (B, S) = {(k.shape[0], k.shape[1])}, "
                         f"got {tuple(segment_ids.shape)}")
    return segment_ids == 0


def flash_sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `flash_sdpa`: masked softmax attention in
    fp32 over the (B, S, H, D) layout. Returns `q.dtype`."""
    FLASH_PLAIN_CALLS.count += 1
    keep = _key_mask(segment_ids, q, k)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    if keep is not None:
        # Zero the masked keys' values: p = 0 times a NaN would still be NaN.
        vf = torch.where(keep[:, None, :, None], vf, torch.zeros_like(vf))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / float(q.shape[-1]) ** 0.5)
    if keep is not None:
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    out = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def _flash_lib():
    from labelany3d_tpu_torch.ops import build

    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_sdpa_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. q, k and v are
    read in place through their strides; the head dim must be contiguous."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention kernel needs CUDA tensors, got {name} on "
                             f"{t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash attention kernel takes bfloat16, got {name} {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"{name} needs a contiguous head dim, 16-byte alignment and "
                             f"strides that are multiples of 8, got {t.stride()}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d != _KERNEL_HEAD_DIM:
        raise ValueError(f"flash attention kernel is built for head dim {_KERNEL_HEAD_DIM}, "
                         f"got {d}")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Sk, H, D) = {(b, sk, h, d)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    keep = _key_mask(segment_ids, q, k)
    ids = None if keep is None else (~keep).to(torch.int32).contiguous()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _flash_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           None if ids is None else ids.data_ptr(), b, sq, sk, h, d,
                           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           1.0 / float(d) ** 0.5, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    FLASH_LAUNCHES.count += 1
    return out


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Sq, H, D) q against (B, Sk, H, D) k, v -> (B, Sq, H, D).

    `segment_ids` (B, S) int, 0 = real token: masks keys of a
    self-attention. CPU tensors take the plain version; CUDA tensors the
    kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, segment_ids)
    return flash_sdpa_kernel(q, k, v, segment_ids)
