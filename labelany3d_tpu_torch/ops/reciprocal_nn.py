"""Reciprocal nearest-neighbour descriptor matching, batched over pairs.

Counterpart of `labelany3d_tpu/ops/reciprocal_nn.py`:

  nn_argmax            <- nn_argmax_tiled: per query row, the best bank row
                          by dot similarity (index, value), first maximum on
                          ties, bank rows >= n_real ignored; 'bf16' or
                          'bf16x3' operands. Kernel `csrc/nn_argmax.cu`.
  pad_bank_for_nn      <- pad_bank_for_nn: pad the descriptor width to the
                          kernel's MMA depth (32) once per bank.
  prepare_bank_for_nn  <- the operand split `nn_argmax_tiled` does outside
                          its kernel: the bank in bf16 at width 32, or
                          [hi | lo] at width 64 for 'bf16x3', once per bank.
  reciprocal_nn_match  <- reciprocal_nn_match, for (P, H, W, C) maps: the
                          same rounds for every pair, each NN call one
                          launch over all P pairs.

As in the JAX package, the CPU path of the matcher scores in float32
(`_argmax_nn`) and the card scores in the kernel's bf16, on banks prepared
once per match. `nn_argmax` on a CPU tensor runs its plain version, which
rounds as the kernel does.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from labelany3d_tpu_torch.ops.attention import LaunchCounter
from labelany3d_tpu_torch.utils.precision import full_f32

# K3: launches of csrc/nn_argmax.cu and calls of its plain version.
KERNEL_LAUNCHES = LaunchCounter()
PLAIN_CALLS = LaunchCounter()
# The same launches by (pairs, queries, bank chunks, precision); `clear()`
# resets it.
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

NN_WIDTH = 32            # the kernel's padded descriptor width (MMA depth)
_PRECISIONS = {"bf16": 0, "bf16x3": 1}
# bf16 values a row of a prepared bank: hi, or [hi | lo].
PREPARED_WIDTH = {"bf16": NN_WIDTH, "bf16x3": 2 * NN_WIDTH}
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


def prepare_bank_for_nn(bank: torch.Tensor,
                        precision: str = "bf16") -> tuple[torch.Tensor, int]:
    """(..., N, C) with C <= 32, padded or not -> ((..., N, W) bf16, N): the
    kernel's bank operand, made once per bank rather than in every launch.
    'bf16': the bank rounded to bf16, W = 32. 'bf16x3': [hi | lo], W = 64,
    with hi = bf16(x) and lo = bf16(x - hi), the split `nn_argmax_tiled`
    makes outside its kernel. Rows past a caller's n_real are converted as
    they are (NaN stays NaN) and never read."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")
    c = bank.shape[-1]
    if c > NN_WIDTH:
        raise ValueError(f"descriptor width {c} exceeds the kernel's {NN_WIDTH}")
    x = bank.float()
    hi = x.bfloat16()
    parts = [hi] if precision == "bf16" else [hi, (x - hi.float()).bfloat16()]
    return (torch.cat([torch.nn.functional.pad(t, (0, NN_WIDTH - c)) for t in parts], dim=-1),
            bank.shape[-2])


def _is_prepared(bank: torch.Tensor, precision: str) -> bool:
    return bank.dtype == torch.bfloat16 and bank.shape[-1] == PREPARED_WIDTH[precision]


def _bank_parts(bank: torch.Tensor, c: int,
                precision: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The hi and (for 'bf16x3') lo operands of a bank, f32, width c."""
    if _is_prepared(bank, precision):
        lo = bank[..., NN_WIDTH:NN_WIDTH + c].float() if precision == "bf16x3" else None
        return bank[..., :c].float(), lo
    hi, lo = _split_bf16(bank[..., :c].float())
    return hi, lo if precision == "bf16x3" else None


def nn_argmax_reference(query: torch.Tensor, bank: torch.Tensor, n_real: int | None = None,
                        precision: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `nn_argmax`, on the kernel's rounding:
    (P, S, C) against (P, N, C') -> (P, S) int32 indices, (P, S) values.
    The bank is float32, or prepared (`prepare_bank_for_nn`). Scores are
    formed per pair in blocks of query rows to bound memory."""
    PLAIN_CALLS.count += 1
    n = bank.shape[-2] if n_real is None else n_real
    c = query.shape[-1]
    rows = max(1, _PLAIN_BLOCK // n)
    idx = torch.empty(query.shape[:-1], dtype=torch.int32, device=query.device)
    best = torch.empty(query.shape[:-1], dtype=torch.float32, device=query.device)
    with full_f32():
        for p in range(query.shape[0]):
            bh, bl = _bank_parts(bank[p, :n], c, precision)
            for r0 in range(0, query.shape[1], rows):
                qh, ql = _split_bf16(query[p, r0:r0 + rows].float())
                sim = qh @ bh.T
                if bl is not None:
                    sim += qh @ bl.T + ql @ bh.T
                best[p, r0:r0 + rows], i = sim.max(dim=-1)
                idx[p, r0:r0 + rows] = i.to(torch.int32)
    return idx, best


def _lib() -> ctypes.CDLL:
    from labelany3d_tpu_torch.ops import build

    lib = build.load("nn_argmax")
    if lib.nn_argmax_fwd.argtypes is None:
        lib.nn_argmax_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.nn_argmax_fwd.restype = ctypes.c_int
        lib.nn_argmax_chunks.argtypes = [ctypes.c_int] * 3
        lib.nn_argmax_chunks.restype = ctypes.c_int
    return lib


def bank_chunks(pairs: int, s: int, n_real: int, device: torch.device | str = "cuda") -> int:
    """The bank chunks the kernel runs for this shape on `device`: the
    kernel splits the bank over blocks when query tiles x pairs leave SMs
    idle, and merges the chunks in a second kernel. 1 at the path's
    32-pair launches."""
    with torch.cuda.device(device):
        chunks = _lib().nn_argmax_chunks(pairs, s, n_real)
    if chunks < 1:
        raise RuntimeError(f"nn_argmax: no bank split for P={pairs}, S={s}, n_real={n_real}")
    return chunks


def nn_argmax_kernel(query: torch.Tensor, bank: torch.Tensor, n_real: int | None = None,
                     precision: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream; `bank` is
    prepared (`prepare_bank_for_nn`) for `precision`."""
    if query.device.type != "cuda" or bank.device != query.device:
        raise ValueError(f"nn_argmax kernel needs CUDA tensors on one device, got "
                         f"{query.device} and {bank.device}")
    if query.dim() != 3 or bank.dim() != 3 or bank.shape[0] != query.shape[0]:
        raise ValueError(f"need query (P, S, C) and bank (P, N, W), got "
                         f"{tuple(query.shape)} and {tuple(bank.shape)}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")
    if not _is_prepared(bank, precision) or not bank.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous bf16 bank of width "
                         f"{PREPARED_WIDTH[precision]} for {precision} (prepare_bank_for_nn), "
                         f"got {tuple(bank.shape)} {bank.dtype}")
    p, s, c = query.shape
    n_bank = bank.shape[1]
    n = n_bank if n_real is None else n_real
    if not 1 <= n <= n_bank:
        raise ValueError(f"need 1 <= n_real <= {n_bank}, got {n}")
    if c > NN_WIDTH:
        raise ValueError(f"descriptor width {c} exceeds the kernel's {NN_WIDTH}")
    query = torch.nn.functional.pad(query.float(), (0, NN_WIDTH - c)).contiguous()
    idx = torch.empty((p, s), dtype=torch.int32, device=query.device)
    best = torch.empty((p, s), dtype=torch.float32, device=query.device)
    chunks = bank_chunks(p, s, n, query.device)
    part_idx = part_best = None
    if chunks > 1:
        part_idx = torch.empty((chunks, p, s), dtype=torch.int32, device=query.device)
        part_best = torch.empty((chunks, p, s), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().nn_argmax_fwd(
            query.data_ptr(), bank.data_ptr(), idx.data_ptr(), best.data_ptr(),
            None if part_idx is None else part_idx.data_ptr(),
            None if part_best is None else part_best.data_ptr(), p, s, n_bank, n,
            bank.shape[-1], _PRECISIONS[precision], stream)
    if err:
        raise RuntimeError(f"nn_argmax kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.count += 1
    LAUNCHES_BY_SHAPE[(p, s, chunks, precision)] += 1
    return idx, best


def nn_argmax(query: torch.Tensor, bank: torch.Tensor, n_real: int | None = None,
              precision: str = "bf16") -> tuple[torch.Tensor, torch.Tensor]:
    """Per query row of (P, S, C), the best row of bank (P, N, C') by dot
    similarity: (P, S) int32 indices and (P, S) float32 values. The bank is
    float32 (as `pad_bank_for_nn` gives it) or prepared for `precision`
    (`prepare_bank_for_nn`, which callers that query a bank many times do
    once). `n_real` marks rows at and beyond it as padding (never read). CPU
    tensors take the plain version; CUDA tensors the kernel (or raise)."""
    if query.device.type == "cpu":
        return nn_argmax_reference(query, bank, n_real, precision)
    if precision in _PRECISIONS and not _is_prepared(bank, precision):
        bank, _ = prepare_bank_for_nn(bank, precision)
    return nn_argmax_kernel(query, bank.contiguous(), n_real, precision)


def _argmax_nn(query: torch.Tensor, bank: torch.Tensor,
               n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest row of a bank per query row; (P, S), (P, S). The card runs
    the kernel in bf16 on a prepared bank; the CPU scores a padded float32
    bank in float32, as the JAX package's non-TPU path does."""
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

    # Both banks once per match: padded on the CPU, prepared as the kernel's
    # bf16 operand on the card; every round of every pair reads them.
    prepare = pad_bank_for_nn if dev.type == "cpu" else prepare_bank_for_nn
    d0p, n0 = prepare(d0)
    d1p, n1 = prepare(d1)

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
