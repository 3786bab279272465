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

Both are differentiable on every device. On the card the backward is K2's
backward, the Pallas library's custom VJP (`_flash_attention_bwd_dkv` and
`_flash_attention_bwd_dq`) as two hand-written kernels
(`csrc/attention_bwd_sm90.cuh`: `flash_sdpa_backward_kernel` and
`packed_sdpa_backward_kernel`), from the row log-sum-exp that the forward
kernel writes when a gradient is wanted. On the CPU `flash_sdpa` is its
plain version under autograd, and `packed_sdpa`'s backward
(`packed_sdpa_backward`) recomputes the attention in fp32 from the saved
qkv, as the JAX package's `_packed_bwd_rule` takes the VJP of its XLA
reference. `flash_sdpa_backward_reference` is the plain version of the two
backward kernels, step by step.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable


class LaunchCounter:
    """A plain count of kernel launches (or plain-version calls)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


# Launches of the CUDA kernel, and calls of the plain version; a run reads
# them to show which path the model went through. K1's plain backward (the
# CPU's) has a count of its own, so that PLAIN_CALLS still counts only
# forwards that left the kernel; PACKED_BACKWARD_LAUNCHES counts the
# backward kernels' launches (the dQ and the dK/dV kernel, one pair a call).
KERNEL_LAUNCHES = LaunchCounter()
PLAIN_CALLS = LaunchCounter()
BACKWARD_CALLS = LaunchCounter()
PACKED_BACKWARD_LAUNCHES = LaunchCounter()

_SOURCE = "packed_attention"
# The head dims the kernels are built for (`attention_sm90.cuh`'s Tiles<D>):
# 64 for MoGe, DepthPro, the full matcher and DINOv2; 32 for the elevation
# matcher's tiny ViT and decoder.
KERNEL_HEAD_DIMS = (32, 64)


def _check_head_dim(d: int, kernel: str) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel is built for head dims {KERNEL_HEAD_DIMS}, got {d}")


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
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    from labelany3d_tpu_torch.ops import build

    fn = build.load(_SOURCE).packed_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def packed_sdpa_kernel(qkv: torch.Tensor, num_heads: int, n_real: int, lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream. The head dim is
    checked first, so a call the kernel cannot take raises on any device.
    With `lse`, also returns each row's log-sum-exp, (B, H, Npad) fp32
    (`packed_sdpa_lse_reference`), for the backward."""
    if qkv.dim() == 3 and qkv.shape[2] % (3 * num_heads) == 0:
        _check_head_dim(qkv.shape[2] // 3 // num_heads, "packed attention")
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
    if n_pad % 64 or not 1 <= n_real <= n_pad:
        raise ValueError(f"need Npad % 64 == 0 and 1 <= n_real <= Npad, got "
                         f"Npad={n_pad}, n_real={n_real}")
    out = torch.empty((b, n_pad, w), dtype=qkv.dtype, device=qkv.device)
    rows = torch.empty((b, num_heads, n_pad), dtype=torch.float32,
                       device=qkv.device) if lse else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(qkv.data_ptr(), out.data_ptr(), None if rows is None else rows.data_ptr(),
                     b, n_pad, num_heads, d, n_real, 1.0 / float(d) ** 0.5, stream)
    if err:
        raise RuntimeError(f"packed attention kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.count += 1
    return (out, rows) if lse else out


def packed_sdpa_lse_reference(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """Plain version of the row log-sum-exp that `packed_sdpa_kernel(...,
    lse=True)` writes: (B, H, Npad) fp32, keys >= n_real masked."""
    b, n_pad, w3 = qkv.shape
    q, k, _ = qkv.view(b, n_pad, 3, num_heads, w3 // 3 // num_heads).unbind(2)
    ids = (torch.arange(n_pad, device=qkv.device) >= n_real).to(torch.int32).expand(b, n_pad)
    return flash_sdpa_lse_reference(q, k, ids if n_real < n_pad else None)


def _row_scratch(b: int, heads: int, rows: int, device) -> torch.Tensor:
    """The backward kernels' per-row scratch, (2, B, H, rows rounded up to
    64) fp32: the dQ kernel writes each row's LSE (log2 units; +inf for a
    row whose cotangent is zero, which then takes no part, so NaN in such a
    row reaches no gradient) and D = rowsum(grad_out * out) (the library's
    `di`), and the dK/dV kernel reads them."""
    return torch.empty((2, b, heads, -(-rows // 64) * 64), dtype=torch.float32, device=device)


def _readable(t: torch.Tensor) -> bool:
    """Whether the K2 kernels read `t` in place: a contiguous head dim,
    16-byte alignment and strides that are multiples of 8."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in t.stride()[:-1])


def packed_sdpa_backward_kernel(qkv: torch.Tensor, out: torch.Tensor, grad_out: torch.Tensor,
                                lse: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """d`qkv` (B, Npad, 3W) of `packed_sdpa` on the card: the dQ and dK/dV
    kernels (`csrc/attention_bwd_sm90.cuh`, K2's backward) over the packed
    columns, from `qkv`, the forward's `out` and `lse` (`packed_sdpa_kernel(...,
    lse=True)`) and the cotangent `grad_out` (B, Npad, W). The dQ kernel
    computes the row terms (D and the dead-row rule) itself, so the call is
    the two kernels and nothing else on the card. P and dS are rounded to
    bf16 before their products, as the JAX package's VJP rounds them on bf16
    operands. The head dim is checked first, so a call the kernels cannot
    take raises on any device."""
    if qkv.dim() == 3 and qkv.shape[2] % (3 * num_heads) == 0:
        _check_head_dim(qkv.shape[2] // 3 // num_heads, "packed attention backward")
    for name, t in (("qkv", qkv), ("out", out), ("grad_out", grad_out), ("lse", lse)):
        if t.device.type != "cuda":
            raise ValueError(f"packed attention backward kernel needs CUDA tensors, got {name} "
                             f"on {t.device}")
    for name, t in (("qkv", qkv), ("out", out), ("grad_out", grad_out)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"packed attention backward kernel takes bfloat16, got {name} "
                             f"{t.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, Npad, 3W), got {tuple(qkv.shape)}")
    b, n_pad, w3 = qkv.shape
    w = w3 // 3
    if w % num_heads:
        raise ValueError(f"width {w} is not divisible by {num_heads} heads")
    d = w // num_heads
    if tuple(out.shape) != (b, n_pad, w) or tuple(grad_out.shape) != (b, n_pad, w):
        raise ValueError(f"out and grad_out must be (B, Npad, W) = {(b, n_pad, w)}, got "
                         f"{tuple(out.shape)} and {tuple(grad_out.shape)}")
    if tuple(lse.shape) != (b, num_heads, n_pad) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 (B, H, Npad) = {(b, num_heads, n_pad)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if not 1 <= n_real <= n_pad:
        raise ValueError(f"need 1 <= n_real <= Npad, got Npad={n_pad}, n_real={n_real}")
    grad_out, out, lse = (t.contiguous() for t in (grad_out, out, lse))
    grad_out, out = (t.clone() if t.data_ptr() % 16 else t for t in (grad_out, out))
    rows = _row_scratch(b, num_heads, n_pad, qkv.device)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib()(qkv.data_ptr(), out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
                         rows[0].data_ptr(), rows[1].data_ptr(), dqkv.data_ptr(), b, n_pad,
                         num_heads, d, n_real, 1.0 / float(d) ** 0.5, stream)
    if err:
        raise RuntimeError(f"packed attention backward kernel launch failed: CUDA error {err}")
    PACKED_BACKWARD_LAUNCHES.count += 1
    return dqkv


def packed_sdpa_backward(qkv: torch.Tensor, grad_out: torch.Tensor, num_heads: int,
                         n_real: int) -> torch.Tensor:
    """d`qkv` of `packed_sdpa` for the cotangent `grad_out` (B, Npad, W):
    the attention recomputed in fp32 from `qkv`, with the forward's masking
    (keys >= n_real masked, their K and V rows zeroed), and the standard
    softmax-attention VJP. Returns `qkv.dtype`.

    A pad query row (>= n_real) whose cotangent is zero contributes nothing
    to any gradient, so it is dropped before the products: NaN pad rows of
    `qkv` then reach no gradient, as they reach no real output forward."""
    BACKWARD_CALLS.count += 1
    b, n_pad, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    scale = 1.0 / float(d) ** 0.5
    x = qkv.float()

    def heads(t):  # (B, N, W) -> (B, H, N, d)
        return t.reshape(b, n_pad, num_heads, d).transpose(1, 2)

    q, k, v = heads(x[..., :w]), heads(x[..., w:2 * w]), heads(x[..., 2 * w:])
    g = heads(grad_out.float())
    if n_real < n_pad:
        pad = torch.arange(n_pad, device=qkv.device) >= n_real
        live = ~pad[:, None] | (g != 0).any(-1, keepdim=True)      # (B, H, N, 1)
        q = torch.where(live, q, torch.zeros((), device=q.device))
        g = torch.where(live, g, torch.zeros((), device=g.device))
        k = k.masked_fill(pad[:, None], 0.0)
        v = v.masked_fill(pad[:, None], 0.0)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if n_real < n_pad:
        s[..., n_real:] = float("-inf")
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.matmul(p, v)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    # dS = P * (dP - rowsum(dO * O)), the softmax's VJP.
    ds = p.mul_(dp.sub_((g * out).sum(-1, keepdim=True)))
    del dp
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale

    def merge(t):  # (B, H, N, d) -> (B, N, W)
        return t.transpose(1, 2).reshape(b, n_pad, w)

    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(qkv.dtype)


class _PackedSdpa(torch.autograd.Function):
    """K1 with its backward. On the CPU: the plain forward, and
    `packed_sdpa_backward` from the saved `qkv` (the residual the JAX
    package's `_packed_fwd_rule` keeps). On the card: the kernel forward,
    which also writes the row log-sum-exp, and the backward kernels from
    the saved `qkv`, output and LSE (the output is saved by the projection
    that reads it anyway)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, n_real):
        ctx.num_heads, ctx.n_real = num_heads, n_real
        ctx.on_cpu = qkv.device.type == "cpu"
        if ctx.on_cpu:
            ctx.save_for_backward(qkv)
            return packed_sdpa_reference(qkv, num_heads, n_real)
        out, lse = packed_sdpa_kernel(qkv, num_heads, n_real, lse=True)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.on_cpu:
            (qkv,) = ctx.saved_tensors
            return packed_sdpa_backward(qkv, grad_out, ctx.num_heads, ctx.n_real), None, None
        return _packed_kernel_backward(ctx, grad_out), None, None


@once_differentiable
def _packed_kernel_backward(ctx, grad_out):
    """The card's backward of `_PackedSdpa`: the kernels' gradient has no
    graph of its own, so a double backward through it raises."""
    qkv, out, lse = ctx.saved_tensors
    return packed_sdpa_backward_kernel(qkv, out, grad_out.to(qkv.dtype), lse, ctx.num_heads,
                                       ctx.n_real)


def packed_sdpa(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """(B, Npad, 3W) packed qkv -> (B, Npad, W) attention output.

    CPU tensors take the plain version; CUDA tensors the kernel (or raise).
    Differentiable on both: with grad enabled and `qkv` requiring grad it
    goes through `_PackedSdpa` (the backward kernels on the card), else
    straight to the forward.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedSdpa.apply(qkv, num_heads, n_real)
    if qkv.device.type == "cpu":
        return packed_sdpa_reference(qkv, num_heads, n_real)
    return packed_sdpa_kernel(qkv, num_heads, n_real)


# K2: launches of csrc/flash_attention.cu and calls of its plain version;
# launches of its backward kernels (the dQ and the dK/dV kernel, one pair a
# call).
FLASH_LAUNCHES = LaunchCounter()
FLASH_PLAIN_CALLS = LaunchCounter()
FLASH_BACKWARD_LAUNCHES = LaunchCounter()
# Score elements of one chunk of heads in the plain backward and LSE
# (1 GB in fp32), so that a long sequence's scores fit on the card.
_SCORE_CHUNK_ELEMENTS = 1 << 28


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


def _head_chunks(b: int, sq: int, sk: int, heads: int):
    """Slices of heads whose (B, h, Sq, Sk) fp32 scores stay within
    `_SCORE_CHUNK_ELEMENTS`."""
    step = max(1, _SCORE_CHUNK_ELEMENTS // max(1, b * sq * sk))
    return [slice(h0, min(h0 + step, heads)) for h0 in range(0, heads, step)]


def flash_sdpa_lse_reference(q: torch.Tensor, k: torch.Tensor,
                             segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the row log-sum-exp the forward kernels write for
    the backward: (B, H, Sq) fp32, log(sum_k exp(q.k / sqrt(d))) over the
    unmasked keys in natural-log units (the Pallas library's m + log(l));
    +inf for a row whose keys are all masked."""
    keep = _key_mask(segment_ids, q, k)
    b, sq, heads, d = q.shape
    out = torch.empty((b, heads, sq), dtype=torch.float32, device=q.device)
    for hs in _head_chunks(b, sq, k.shape[1], heads):
        qf, kf = (t[:, :, hs].float().transpose(1, 2) for t in (q, k))
        s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / float(d) ** 0.5)
        if keep is not None:
            s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        out[:, hs] = lse.masked_fill(lse == float("-inf"), float("inf"))
    return out


def flash_sdpa_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, lse: torch.Tensor,
                                  grad_out: torch.Tensor,
                                  segment_ids: torch.Tensor | None = None):
    """Plain version of K2's two backward kernels: (dq, dk, dv) in the
    inputs' dtypes from q (B, Sq, H, D), k, v (B, Sk, H, D), the forward's
    `out` and `lse` (B, H, Sq) and the cotangent `grad_out`, step by step
    in the arithmetic of the Pallas library's `mha_reference_bwd` in fp32:
    P = exp(S - LSE), dV = P^T dO, dP = dO V^T, D = rowsum(O o dO),
    dS = (dP - D) o P, dK = dS^T Q, dQ = dS K (both times the scale).
    Masked keys are zeroed in K and V and their P is 0 (so NaN in a masked
    V row reaches nothing); a query row whose cotangent is zero takes no
    part (the dQ kernel's dead-row rule). Chunked over heads so long
    sequences fit."""
    keep = _key_mask(segment_ids, q, k)
    b, sq, heads, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / float(d) ** 0.5
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for hs in _head_chunks(b, sq, sk, heads):
        qf, kf, vf, of, gf = (t[:, :, hs].float().transpose(1, 2)  # (B, h, S, D)
                              for t in (q, k, v, out, grad_out))
        live = (gf != 0).any(-1, keepdim=True)                    # (B, h, Sq, 1)
        zero = torch.zeros((), device=q.device)
        qf = torch.where(live, qf, zero)
        rows = torch.where(live, lse[:, hs, :, None], torch.full((), float("inf"),
                                                                 device=q.device))
        if keep is not None:
            kk = keep[:, None, :, None]
            kf, vf = torch.where(kk, kf, zero), torch.where(kk, vf, zero)
        p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - rows)
        if keep is not None:
            p = torch.where(keep[:, None, None, :], p, zero)
        dv_h = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        di = torch.where(live, (of * gf).sum(-1, keepdim=True), zero)
        ds = (dp - di) * p
        del dp, p
        dk[:, :, hs] = (torch.matmul(ds.transpose(-1, -2), qf) * scale).transpose(1, 2).to(k.dtype)
        dq[:, :, hs] = (torch.matmul(ds, kf) * scale).transpose(1, 2).to(q.dtype)
        dv[:, :, hs] = dv_h.transpose(1, 2).to(v.dtype)
    return dq, dk, dv


def _flash_lib():
    from labelany3d_tpu_torch.ops import build

    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_bwd_lib():
    from labelany3d_tpu_torch.ops import build

    fn = build.load("flash_attention").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 15
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_strided(named, kernel: str) -> None:
    """The layout the K2 kernels read through strides: CUDA, bf16, 4-D, a
    contiguous head dim, 16-byte alignment, strides that are multiples of 8."""
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{kernel} kernel takes bfloat16, got {name} {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
        if not _readable(t):
            raise ValueError(f"{name} needs a contiguous head dim, 16-byte alignment and "
                             f"strides that are multiples of 8, got {t.stride()}")


def _key_ids(segment_ids, q, k):
    keep = _key_mask(segment_ids, q, k)
    return None if keep is None else (~keep).to(torch.int32).contiguous()


def flash_sdpa_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor | None = None, lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream. q, k and v are
    read in place through their strides; the head dim must be contiguous
    (and is checked first, so a call the kernel cannot take raises on any
    device). With `lse`, also returns each row's log-sum-exp, (B, H, Sq)
    fp32 (`flash_sdpa_lse_reference`), for the backward."""
    _check_head_dim(q.shape[-1], "flash attention")
    _check_strided((("q", q), ("k", k), ("v", v)), "flash attention")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Sk, H, D) = {(b, sk, h, d)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    ids = _key_ids(segment_ids, q, k)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    rows = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _flash_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           None if ids is None else ids.data_ptr(),
                           None if rows is None else rows.data_ptr(), b, sq, sk, h, d,
                           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           1.0 / float(d) ** 0.5, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    FLASH_LAUNCHES.count += 1
    return (out, rows) if lse else out


def flash_sdpa_backward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, grad_out: torch.Tensor,
                               segment_ids: torch.Tensor | None = None):
    """(dq, dk, dv) of `flash_sdpa` on the card: the dQ and dK/dV kernels
    (`csrc/attention_bwd_sm90.cuh`), the Pallas library's
    `_flash_attention_bwd_dq` and `_flash_attention_bwd_dkv`. q, k, v, `out`
    and `grad_out` are read through their strides (as the forward reads q,
    k and v: column views and broadcast operands included); `out` and `lse`
    are the forward's (`flash_sdpa_kernel(..., lse=True)`). The dQ kernel
    computes the row terms (D and the dead-row rule) itself. Returns fresh
    contiguous gradients of q's, k's and v's shapes (autograd sums those
    of broadcast operands). The head dim is checked first, so a call the
    kernels cannot take raises on any device."""
    _check_head_dim(q.shape[-1], "flash attention backward")
    _check_strided((("q", q), ("k", k), ("v", v), ("out", out), ("grad_out", grad_out)),
                   "flash attention backward")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Sk, H, D) = {(b, sk, h, d)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if out.shape != q.shape or grad_out.shape != q.shape:
        raise ValueError(f"out and grad_out must be (B, Sq, H, D) = {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(grad_out.shape)}")
    if tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 (B, H, Sq) = {(b, h, sq)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    ids = _key_ids(segment_ids, q, k)
    lse = lse.contiguous()
    rows = _row_scratch(b, h, sq, q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _flash_bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               grad_out.data_ptr(), lse.data_ptr(), rows[0].data_ptr(),
                               rows[1].data_ptr(), None if ids is None else ids.data_ptr(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d,
                               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                               *out.stride()[:3], *grad_out.stride()[:3],
                               1.0 / float(d) ** 0.5, stream)
    if err:
        raise RuntimeError(f"flash attention backward kernel launch failed: CUDA error {err}")
    FLASH_BACKWARD_LAUNCHES.count += 1
    return dq, dk, dv


class _FlashSdpa(torch.autograd.Function):
    """K2 on the card with its backward kernels. The forward asks the
    kernel for the row log-sum-exp only when a gradient is wanted, and then
    saves q, k, v, the output and the LSE (the residuals the library's
    `_flash_attention_fwd` keeps, less its m and l, which the LSE
    replaces)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids):
        if not any(ctx.needs_input_grad[:3]):
            return flash_sdpa_kernel(q, k, v, segment_ids)
        out, lse = flash_sdpa_kernel(q, k, v, segment_ids, lse=True)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        g = grad_out.to(q.dtype)
        if not _readable(g):
            g = g.contiguous()
        dq, dk, dv = flash_sdpa_backward_kernel(q, k, v, out, lse, g, segment_ids)
        return dq, dk, dv, None


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Sq, H, D) q against (B, Sk, H, D) k, v -> (B, Sq, H, D).

    `segment_ids` (B, S) int, 0 = real token: masks keys of a
    self-attention. CPU tensors take the plain version (differentiable by
    autograd); CUDA tensors the kernel (or raise), and with grad enabled
    and an input that requires grad, `_FlashSdpa` (the backward kernels)."""
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, segment_ids)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashSdpa.apply(q, k, v, segment_ids)
    return flash_sdpa_kernel(q, k, v, segment_ids)


# Sparse-voxel attention patterns (TRELLIS serialized and shifted-window
# attention). The JAX package runs both through `jax.nn.dot_product_attention`,
# not Pallas, so they are plain PyTorch: gather into windows, masked softmax
# attention, scatter back.

_LARGE_NEGATIVE = -0.7 * torch.finfo(torch.float32).max  # XLA attention's mask value
_WINDOW_SCORE_ELEMENTS = 1 << 26  # score elements per chunk of windows (256 MB f32)


def _window_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(W, S, H, D) windows, (W, S, S) bool mask [query, key] -> (W, S, H, D)
    in `q.dtype`. Softmax in fp32 with masked scores at XLA's large negative
    value, so a fully masked row averages V as XLA's attention does. Chunked
    over windows so the scores never exceed `_WINDOW_SCORE_ELEMENTS`."""
    nw, s, h, d = q.shape
    out = torch.empty_like(q)
    chunk = max(1, _WINDOW_SCORE_ELEMENTS // (h * s * s))
    for c0 in range(0, nw, chunk):
        sl = slice(c0, c0 + chunk)
        qf, kf, vf = (t[sl].float().transpose(1, 2) for t in (q, k, v))  # (c, H, S, D)
        sc = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / float(d) ** 0.5)
        sc = sc.masked_fill(~mask[sl, None], _LARGE_NEGATIVE)
        out[sl] = torch.matmul(torch.softmax(sc, dim=-1), vf).transpose(1, 2).to(q.dtype)
    return out


def serialized_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         coords: torch.Tensor, valid: torch.Tensor, window_size: int = 512,
                         shift: int = 0, curve: str = "z_order") -> torch.Tensor:
    """Space-filling-curve windowed attention over sparse voxels.

    q, k, v (N, H, D) per-voxel heads; coords (N, 3); valid (N,). Voxels are
    ordered along the curve (pad slots last), rolled by `shift`, cut into
    windows of `window_size` tokens; valid queries attend valid keys of
    their window. Returns (N, H, D) in the original slot order."""
    from labelany3d_tpu_torch.ops.morton import hilbert_encode_3d, morton_encode_3d

    n, h, d = q.shape
    code = morton_encode_3d(coords) if curve == "z_order" else hilbert_encode_3d(coords)
    order = torch.argsort(torch.where(valid, code, torch.full_like(code, 2 ** 30)), stable=True)
    pad = (-n) % window_size

    def window(t):
        t = t[order]
        if shift:
            t = torch.roll(t, -shift, dims=0)
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
        return t.reshape(-1, window_size, *t.shape[1:])

    vm = window(valid)
    out = _window_sdpa(window(q), window(k), window(v), vm[:, :, None] & vm[:, None, :])
    out = out.reshape(-1, h, d)[:n]
    if shift:
        out = torch.roll(out, shift, dims=0)
    return out[torch.argsort(order)]


def windowed_attention_3d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          coords: torch.Tensor, valid: torch.Tensor, grid_size: int,
                          window_size: int = 8, shift: int = 0,
                          max_per_window: int = 512) -> torch.Tensor:
    """Shifted 3D spatial window attention over sparse voxels.

    Voxels attend within their window_size^3 cell (the grid shifted by
    `shift` along each axis). Each cell holds at most `max_per_window`
    voxels, in slot order; overflow voxels pass v through. Only occupied
    windows are computed, each padded to the fullest one's count: empty
    slots are masked keys and their rows are never read, so the real rows
    are those of the JAX package's dense `max_per_window` buffer."""
    n, h, d = q.shape
    dev = q.device
    wcoord = torch.div(coords.long() + shift, window_size, rounding_mode="floor")
    wpa = (grid_size + window_size - 1) // window_size + (1 if shift else 0)
    num_windows = wpa ** 3
    wid = (wcoord[:, 0] * wpa + wcoord[:, 1]) * wpa + wcoord[:, 2]
    wid = torch.where(valid, wid, torch.full_like(wid, num_windows))  # pad slots -> overflow bin
    order = torch.argsort(wid, stable=True)
    swid = wid[order]
    rank = torch.arange(n, device=dev) - torch.searchsorted(swid, swid, side="left")
    in_slot = (rank < max_per_window) & (swid < num_windows)
    occupied, wslot = torch.unique(torch.where(in_slot, swid, num_windows), return_inverse=True)
    n_occ = int((occupied < num_windows).sum())
    out_sorted = v[order].clone()  # overflow voxels keep v
    if n_occ == 0:
        return out_sorted[torch.argsort(order)]
    s = int(rank[in_slot].max()) + 1
    slot = (wslot * s + rank)[in_slot]

    def scatter(t):
        buf = t.new_zeros((n_occ * s, *t.shape[1:]))
        buf[slot] = t[order][in_slot]
        return buf.reshape(n_occ, s, *t.shape[1:])

    occ = scatter(torch.ones(n, dtype=torch.bool, device=dev))
    # Empty windows' rows would have no key: open the diagonal, as JAX does.
    eye = torch.eye(s, dtype=torch.bool, device=dev)
    out_w = _window_sdpa(scatter(q), scatter(k), scatter(v),
                         (occ[:, :, None] & occ[:, None, :]) | eye)
    out_sorted[in_slot] = out_w.reshape(n_occ * s, h, d)[slot]
    return out_sorted[torch.argsort(order)]
