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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def packed_sdpa_kernel(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. The head dim is
    checked first, so a call the kernel cannot take raises on any device."""
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
    read in place through their strides; the head dim must be contiguous
    (and is checked first, so a call the kernel cannot take raises on any
    device)."""
    _check_head_dim(q.shape[-1], "flash attention")
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
