"""Sequence-parallel attention over a mesh axis.

Counterpart of `labelany3d_tpu/parallel/sp.py`: attention whose sequence
is split over the ranks of one mesh axis, each rank holding (S_local, H,
D) of q, k and v.

  * `sp_attention_gathered`: K and V are all-gathered over the group; q
    stays local, so the output is split like q;
  * `sp_attention_ring`: K/V blocks rotate around the group (each rank
    sends to the next and receives from the previous, `batch_isend_irecv`)
    with an fp32 online softmax; memory O(S_local).

Both are plain PyTorch, as the JAX versions are plain `jnp`, and both are
forward only: no caller differentiates them, in either package. Both are
exact up to the order of the sums.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(q, H, k) fp32 scores of (Sq, H, D) q against (Sk, H, D) k, scaled
    by 1/sqrt(D)."""
    return torch.einsum("qhd,khd->qhk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)


def sp_attention_gathered(q, k, v, group=None) -> torch.Tensor:
    """Attention of this rank's q against every rank's k and v, gathered
    over `group` in rank order. q, k, v: (S_local, H, D)."""
    n = dist.get_world_size(group)
    ks, vs = [torch.empty_like(k) for _ in range(n)], [torch.empty_like(v) for _ in range(n)]
    dist.all_gather(ks, k.contiguous(), group=group)
    dist.all_gather(vs, v.contiguous(), group=group)
    w = torch.softmax(_scores(q, torch.cat(ks)), dim=-1)
    return torch.einsum("qhk,khd->qhd", w, torch.cat(vs).float()).to(q.dtype)


def sp_attention_ring(q, k, v, group=None) -> torch.Tensor:
    """Ring attention over `group`: n steps, each attending the K/V block
    in hand and passing it on; the online softmax keeps a running max, sum
    and weighted value in fp32. q, k, v: (S_local, H, D)."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n) if group is not None else (rank + 1) % n
    prv = dist.get_global_rank(group, (rank - 1) % n) if group is not None else (rank - 1) % n
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    den = torch.zeros((*q.shape[:2], 1), dtype=torch.float32, device=q.device)
    m_run = torch.full_like(den, float("-inf"))
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(n):
        if i < n - 1:
            k_next, v_next = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, nxt, group), dist.P2POp(dist.isend, vb, nxt, group),
                dist.P2POp(dist.irecv, k_next, prv, group),
                dist.P2POp(dist.irecv, v_next, prv, group)])
        s = _scores(q, kb)                                     # (q, H, k)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_run - m_new)
        acc = acc * corr + torch.einsum("qhk,khd->qhd", p, vb.float())
        den = den * corr + p.sum(-1, keepdim=True)
        m_run = m_new
        if i < n - 1:
            for r in reqs:
                r.wait()
            kb, vb = k_next, v_next
    return (acc / torch.clamp(den, min=1e-30)).to(q.dtype)


def make_sp_attention(mesh, axis: str = "data", mode: str = "gathered"):
    """fn(q, k, v) over this rank's (S_local, H, D) shards along `mesh`'s
    `axis`, returning this rank's output rows. `mode` is 'gathered' or
    'ring'."""
    if mode not in ("gathered", "ring"):
        raise ValueError(f"Unknown sequence-parallel mode {mode!r} (gathered | ring)")
    inner = sp_attention_gathered if mode == "gathered" else sp_attention_ring
    return functools.partial(inner, group=mesh.get_group(axis))
