"""Frozen roofline and MFU arithmetic of the benchmark.

Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at the full
700 W): 989 TFLOP/s on the bf16 tensor cores, 3.35 TB/s of HBM3. A
roofline share is the least time these allow for the logical work of the
calls (the larger of operations over the peak rate and bytes over the
bandwidth) over the device time of the kernels that did it. Only real
query rows and real keys count: the padding a kernel computes is not
work. Every input byte is read once and every output byte written once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2


def least_s(flops: float, nbytes: float) -> float:
    """Least seconds for `flops` operations and `nbytes` of traffic."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def attention_fwd(b: int, nq: int, nk: int, heads: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one softmax-attention forward in bf16: QK^T
    and PV, 2 * nq * nk * d each a head; q and the output over the nq real
    rows, k and v over the nk real keys."""
    flops = 4.0 * b * heads * nq * nk * d
    nbytes = BF16 * b * heads * d * (2 * nq + 2 * nk)
    return flops, nbytes


def attention_bwd(b: int, nq: int, nk: int, heads: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one attention backward in bf16: QK^T
    recomputed, dP = dO V^T, dV, dK and dQ, five products of 2 * nq * nk * d
    a head; q, o, do read and dq written over the real rows, k, v read and
    dk, dv written over the real keys, the fp32 row LSE read."""
    flops = 10.0 * b * heads * nq * nk * d
    nbytes = BF16 * b * heads * d * (4 * nq + 4 * nk) + 4 * b * heads * nq
    return flops, nbytes


def nn_argmax(pairs: int, queries: int, bank: int, dim: int) -> tuple[float, float]:
    """(operations, bytes) of the reciprocal-NN argmax (K3) in bf16: a
    (queries x dim) by (dim x bank) product a pair, the best score and its
    index written a query (fp32 and int32)."""
    flops = 2.0 * pairs * queries * bank * dim
    nbytes = BF16 * pairs * dim * (queries + bank) + 8 * pairs * queries
    return flops, nbytes


def calls_least_s(calls, fn) -> float:
    """Least seconds of a list of (count, shape) calls of `fn(*shape)`."""
    return sum(n * least_s(*fn(*shape)) for n, shape in calls)


def share_pct(bound_s: float, device_s: float) -> float | None:
    """A roofline share in percent, or None when no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def mfu_pct(flops: float, seconds: float) -> float | None:
    """Model FLOPs over the window as a share of the bf16 peak, percent."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
