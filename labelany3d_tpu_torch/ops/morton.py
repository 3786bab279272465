"""Space-filling-curve codes for voxel serialization (vox2seq equivalent).

Counterpart of `labelany3d_tpu/ops/morton.py`: Z-order (Morton) and Hilbert
codes of 3D voxel coordinates, 10 bits per axis (grids up to 1024^3), as
30-bit int32 codes. Plain integer bit manipulation on int64 tensors; no
kernel. `ops/attention.py::serialized_attention` orders voxels by them.
"""

from __future__ import annotations

import torch

BITS = 10


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x.long() & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    x = x.long() & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def morton_encode_3d(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int voxel coords -> (...,) int32 Morton (z-order) codes."""
    x, y, z = (_part1by2(coords[..., i]) for i in range(3))
    return (x | (y << 1) | (z << 2)).to(torch.int32)


def morton_decode_3d(codes: torch.Tensor) -> torch.Tensor:
    """(...,) Morton codes -> (..., 3) int32 coords."""
    c = codes.long() & 0xFFFFFFFF
    return torch.stack([_compact1by2(c), _compact1by2(c >> 1), _compact1by2(c >> 2)],
                       dim=-1).to(torch.int32)


def _swap_or_invert(X: list, i: int, q: int) -> None:
    """One step of Skilling's transform: where bit q of X[i] is set, invert
    the low bits of X[0]; else exchange the low bits of X[0] and X[i]."""
    p = q - 1
    cond = (X[i] & q) != 0
    t = (X[0] ^ X[i]) & p
    xi_ex = X[i] ^ t
    X[0] = torch.where(cond, X[0] ^ p, X[0] ^ t)
    # Read after X[0] is written: for i == 0 this keeps the inversion.
    X[i] = torch.where(cond, X[i], xi_ex)


def hilbert_encode_3d(coords: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """(..., 3) coords -> Hilbert-curve indices (Skilling's transpose
    method), as vox2seq's hilbert.cu."""
    X = [coords[..., i].long() for i in range(3)]
    n = 3
    m = 1 << (bits - 1)
    q = m
    for _ in range(bits - 1):
        for i in range(n):
            _swap_or_invert(X, i, q)
        q >>= 1
    for i in range(1, n):  # Gray encode
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    q = m
    for _ in range(bits - 1):
        t = torch.where((X[n - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    X = [x ^ t for x in X]
    code = torch.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):  # interleave the transposed bits, x-major
        for i in range(n):
            code = (code << 1) | ((X[i] >> b) & 1)
    return code.to(torch.int32)


def hilbert_decode_3d(codes: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """Hilbert indices -> (..., 3) coords (inverse of `hilbert_encode_3d`)."""
    c = codes.long() & 0xFFFFFFFF
    n = 3
    X = [torch.zeros_like(c) for _ in range(n)]
    for b in range(bits):
        for i in range(n):
            shift = (bits - 1 - b) * n + (n - 1 - i)
            X[i] = X[i] | (((c >> shift) & 1) << (bits - 1 - b))
    t = X[n - 1] >> 1  # Gray decode
    for i in range(n - 1, 0, -1):
        X[i] = X[i] ^ X[i - 1]
    X[0] = X[0] ^ t
    q = 2
    while q != 2 << (bits - 1):  # undo excess work
        for i in range(n - 1, -1, -1):
            _swap_or_invert(X, i, q)
        q <<= 1
    return torch.stack(X, dim=-1).to(torch.int32)
