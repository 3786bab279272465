"""Plain softmax attention of the frozen reference, in float32 with TF32
off (fp8 operands under the control), computed over blocks of the batch
so that the (b, H, S, S) scores of a full-width cell fit beside the model.

`packed_sdpa` takes the port's packed layout (B, Npad, 3W) with keys past
`n_real` masked; `flash_sdpa` the (B, S, H, D) layout with keys of another
segment than the query's masked. Pad rows' outputs are zero: every caller
slices them off.
"""

from __future__ import annotations

import torch

from .precision import full_f32, operand

SCORE_ELEMENTS = 1 << 28   # fp32 scores a block may hold (1 GiB)


def _attend(q, k, v, keep=None):
    """q, k, v (b, H, S, D) float32; keep (b, Sq, Sk) bool or None."""
    with full_f32():
        s = torch.matmul(operand(q), operand(k).transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        if keep is not None:
            s = s.masked_fill(~keep[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.matmul(operand(p), operand(v))


def _blocks(b: int, heads: int, sq: int, sk: int):
    step = max(1, SCORE_ELEMENTS // max(1, heads * sq * sk))
    return [slice(i, min(i + step, b)) for i in range(0, b, step)]


def packed_sdpa(qkv: torch.Tensor, num_heads: int, n_real: int) -> torch.Tensor:
    b, n_pad, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    x = qkv[:, :n_real].float()

    def heads(t):
        return t.reshape(t.shape[0], n_real, num_heads, d).transpose(1, 2)

    outs = []
    for sl in _blocks(b, num_heads, n_real, n_real):
        xs = x[sl]
        o = _attend(heads(xs[..., :w]), heads(xs[..., w:2 * w]), heads(xs[..., 2 * w:]))
        outs.append(o.transpose(1, 2).reshape(xs.shape[0], n_real, w))
    out = torch.cat(outs)
    if n_pad > n_real:
        out = torch.cat([out, out.new_zeros(b, n_pad - n_real, w)], dim=1)
    return out.to(qkv.dtype)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    outs = []
    for sl in _blocks(b, h, sq, sk):
        keep = None
        if segment_ids is not None:
            seg = segment_ids[sl]
            keep = seg[:, :, None] == seg[:, None, :]
        qf, kf, vf = (t[sl].float().transpose(1, 2) for t in (q, k, v))
        outs.append(_attend(qf, kf, vf, keep).transpose(1, 2))
    out = torch.cat(outs)
    if segment_ids is not None:
        out = torch.where((segment_ids == 0)[:, :, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)
