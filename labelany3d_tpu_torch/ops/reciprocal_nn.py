"""Reciprocal nearest-neighbour descriptor matching, batched over pairs.

Counterpart of `labelany3d_tpu/ops/reciprocal_nn.py`:

  nn_argmax            <- nn_argmax_tiled: per query row, the best bank row
                          by dot similarity (index, value), first maximum on
                          ties, bank rows >= n_real ignored; 'bf16' or
                          'bf16x3' operands. Kernel `csrc/nn_argmax.cu`.
  pad_bank_for_nn      <- pad_bank_for_nn: pad the descriptor width to the
                          kernel's MMA depth (32) once per bank.
  reciprocal_nn_match  <- reciprocal_nn_match, for (P, H, W, C) maps: the
                          same rounds for every pair, each NN call one
                          launch over all P pairs.

As in the JAX package, the CPU path of the matcher scores in float32
(`_argmax_nn`) and the card scores in the kernel's bf16. `nn_argmax` on a
CPU tensor runs its plain version, which rounds as the kernel does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from labelany3d_tpu_torch.ops.attention import LaunchCounter
from labelany3d_tpu_torch.utils.precision import full_f32

# K3: launches of csrc/nn_argmax.cu and calls of its plain version.
KERNEL_LAUNCHES = LaunchCounter()
PLAIN_CALLS = LaunchCounter()

NN_WIDTH = 32            # the kernel's padded descriptor width (MMA depth)
_PRECISIONS = {"bf16": 0, "bf16x3": 1}
_PLAIN_BLOCK = 1 << 28     # score elements per block of the plain version (1 GiB f32)


class MatchResult(NamedTuple):
    xy0: torch.Tensor     # (..., S, 2) pixel coords in image 0
    xy1: torch.Tensor     # (..., S, 2) pixel coords in image 1
    valid: torch.Tensor   # (..., S) cycle-consistent flags
    score: torch.Tensor   # (..., S) dot similarity of the final pair


def pad_bank_for_nn(bank: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(..., N, C) -> ((..., N, 32) zero-padded, N), C <= 32. Zero columns
    leave every dot product unchanged; callers that query a bank many
    times pad it once."""
    c = bank.shape[-1]
    if c > NN_WIDTH:
        raise ValueError(f"descriptor width {c} exceeds the kernel's {NN_WIDTH}")
    return torch.nn.functional.pad(bank.float(), (0, NN_WIDTH - c)), bank.shape[-2]


def _split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def nn_argmax_reference(query: torch.Tensor, bank: torch.Tensor, n_real: int | None = None,
                        precision: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `nn_argmax`, on the kernel's rounding:
    (P, S, C) against (P, N, C') -> (P, S) int32 indices, (P, S) values.
    Scores are formed per pair in blocks of query rows to bound memory."""
    PLAIN_CALLS.count += 1
    n = bank.shape[-2] if n_real is None else n_real
    c = query.shape[-1]
    rows = max(1, _PLAIN_BLOCK // n)
    idx = torch.empty(query.shape[:-1], dtype=torch.int32, device=query.device)
    best = torch.empty(query.shape[:-1], dtype=torch.float32, device=query.device)
    with full_f32():
        for p in range(query.shape[0]):
            bh, bl = _split_bf16(bank[p, :n, :c].float())
            for r0 in range(0, query.shape[1], rows):
                qh, ql = _split_bf16(query[p, r0:r0 + rows].float())
                sim = qh @ bh.T
                if precision == "bf16x3":
                    sim += qh @ bl.T + ql @ bh.T
                best[p, r0:r0 + rows], i = sim.max(dim=-1)
                idx[p, r0:r0 + rows] = i.to(torch.int32)
    return idx, best


def _lib():
    from labelany3d_tpu_torch.ops import build

    fn = build.load("nn_argmax").nn_argmax_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nn_argmax_kernel(query: torch.Tensor, bank: torch.Tensor, n_real: int | None = None,
                     precision: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if query.device.type != "cuda" or bank.device != query.device:
        raise ValueError(f"nn_argmax kernel needs CUDA tensors on one device, got "
                         f"{query.device} and {bank.device}")
    if query.dim() != 3 or bank.dim() != 3 or bank.shape[0] != query.shape[0]:
        raise ValueError(f"need query (P, S, C) and bank (P, N, C), got "
                         f"{tuple(query.shape)} and {tuple(bank.shape)}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")
    if bank.shape[-1] != NN_WIDTH or bank.dtype != torch.float32 or not bank.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous float32 bank padded to width "
                         f"{NN_WIDTH} (pad_bank_for_nn), got {tuple(bank.shape)} {bank.dtype}")
    p, s, c = query.shape
    n_bank = bank.shape[1]
    n = n_bank if n_real is None else n_real
    if not 1 <= n <= n_bank:
        raise ValueError(f"need 1 <= n_real <= {n_bank}, got {n}")
    if c != NN_WIDTH:
        query = torch.nn.functional.pad(query, (0, NN_WIDTH - c))
    query = query.float().contiguous()
    idx = torch.empty((p, s), dtype=torch.int32, device=query.device)
    best = torch.empty((p, s), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(query.data_ptr(), bank.data_ptr(), idx.data_ptr(), best.data_ptr(),
                     p, s, n_bank, n, NN_WIDTH, _PRECISIONS[precision], stream)
    if err:
        raise RuntimeError(f"nn_argmax kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.count += 1
    return idx, best


def nn_argmax(query: torch.Tensor, bank: torch.Tensor, n_real: int | None = None,
              precision: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """Per query row of (P, S, C), the best row of bank (P, N, C') by dot
    similarity: (P, S) int32 indices and (P, S) float32 values. `n_real`
    marks rows at and beyond it as padding (never read). CPU tensors take the
    plain version; CUDA tensors the kernel (or raise)."""
    if query.device.type == "cpu":
        return nn_argmax_reference(query, bank, n_real, precision)
    if bank.shape[-1] != NN_WIDTH:
        bank, n_real = pad_bank_for_nn(bank[..., :n_real, :] if n_real else bank)
    return nn_argmax_kernel(query, bank.contiguous(), n_real, precision)


def _argmax_nn(query: torch.Tensor, bank: torch.Tensor,
               n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest row of a padded bank per query row; (P, S), (P, S). The card
    runs the kernel in bf16; the CPU scores in float32, as the JAX
    package's non-TPU path does."""
    if query.device.type != "cpu":
        return nn_argmax(query, bank, n_real=n_real)
    with full_f32():
        sim = query.float() @ bank[:, :n_real, :query.shape[-1]].float().transpose(-1, -2)
    best, idx = sim.max(dim=-1)
    return idx.to(torch.int32), best


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (P, N[, C]) at (P, S) indices."""
    if t.dim() == 2:
        return t.gather(1, idx.long())
    return t.gather(1, idx.long()[..., None].expand(*idx.shape, t.shape[-1]))


def reciprocal_nn_match(desc0: torch.Tensor, desc1: torch.Tensor, subsample: int = 8,
                        iterations: int = 6, border: int = 3,
                        compact: int = 1024) -> MatchResult:
    """Cycle-consistent matches between (P, H0, W0, C) and (P, H1, W1, C)
    descriptor maps (or one unbatched (H, W, C) pair).

    From every `subsample`-strided pixel of image 0, ping-pong 0 -> 1 -> 0
    for `iterations` rounds and keep the fixed points; matches within
    `border` pixels of an edge are invalid. Round 1 queries every start
    point; later rounds query the first `compact` points in (stable) order
    of not-yet-converged first, as the JAX package does.
    """
    if desc0.dim() == 3:
        res = reciprocal_nn_match(desc0[None], desc1[None], subsample, iterations, border,
                                  compact)
        return MatchResult(*(t[0] for t in res))
    p, h0, w0, c = desc0.shape
    _, h1, w1, _ = desc1.shape
    dev = desc0.device
    d0 = desc0.reshape(p, -1, c)
    d1 = desc1.reshape(p, -1, c)

    ys = torch.arange(subsample // 2, h0, subsample, device=dev)
    xs = torch.arange(subsample // 2, w0, subsample, device=dev)
    idx0 = (ys[:, None] * w0 + xs[None, :]).reshape(1, -1).expand(p, -1).to(torch.int32)
    s = idx0.shape[1]

    d0p, n0 = pad_bank_for_nn(d0)
    d1p, n1 = pad_bank_for_nn(d1)

    idx1, score = _argmax_nn(_take(d0, idx0), d1p, n1)
    back0, _ = _argmax_nn(_take(d1, idx1), d0p, n0)
    frozen = back0 == idx0
    cur0 = torch.where(frozen, idx0, back0)

    sub_s = s if compact <= 0 else min(compact, s)
    for _ in range(max(iterations - 1, 0)):
        sel = torch.sort(frozen.to(torch.uint8), dim=1, stable=True).indices[:, :sub_s]
        qidx = cur0.gather(1, sel)
        idx1_s, score_s = _argmax_nn(_take(d0, qidx), d1p, n1)
        back0_s, _ = _argmax_nn(_take(d1, idx1_s), d0p, n0)
        conv = back0_s == qidx
        act = ~frozen.gather(1, sel)
        cur0 = cur0.scatter(1, sel, torch.where(act & ~conv, back0_s, qidx))
        idx1 = idx1.scatter(1, sel, torch.where(act, idx1_s, idx1.gather(1, sel)))
        score = score.scatter(1, sel, torch.where(act, score_s, score.gather(1, sel)))
        frozen = frozen.scatter(1, sel, frozen.gather(1, sel) | conv)

    x0, y0 = (cur0 % w0).float(), torch.div(cur0, w0, rounding_mode="floor").float()
    x1, y1 = (idx1 % w1).float(), torch.div(idx1, w1, rounding_mode="floor").float()
    in0 = (x0 >= border) & (x0 < w0 - border) & (y0 >= border) & (y0 < h0 - border)
    in1 = (x1 >= border) & (x1 < w1 - border) & (y1 >= border) & (y1 < h1 - border)
    return MatchResult(xy0=torch.stack([x0, y0], dim=-1), xy1=torch.stack([x1, y1], dim=-1),
                       valid=frozen & in0 & in1, score=score)
