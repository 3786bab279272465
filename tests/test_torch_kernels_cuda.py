"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests carry the `cuda` marker and
skip without a device. This file imports no JAX, so it also runs on a GPU
machine without it; `tests/conftest.py` imports JAX, hence:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Attention tolerances, against an fp32 plain version on the same bf16 inputs: 5e-3
absolute and 5e-3 relative L2 (||out - ref|| / ||ref||); K1's gradient
5e-3 relative L2 and 1e-2 of the largest gradient absolute. The output is
rounded to bf16 (relative 2^-9) and so is P before the PV product; a wrong
key tile (the last partial tile dropped, or its pad keys unmasked) moves
the output by a few percent of its scale.
"""

import pytest
import torch

from labelany3d_tpu_torch.ops import attention as port

MAX_ABS_TOL = 5e-3
REL_TOL = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_pad,n_real", [
    (2, 384, 325), (1, 1408, 1297), (1, 128, 1),
    (1, 256, 128),     # exactly one key tile of 128
    (1, 256, 129),     # one key past it
    (3, 64, 61),       # Npad = 64: two of a block's three warpgroups have no rows
    (36, 1408, 1297),  # the matcher encoder's batch
    (280, 640, 577),   # DepthPro35's patch encoder: 35 patches x 8 images
    (8, 640, 577),     # DepthPro35's image and FoV encoders
    (1, 1408, 1374),   # TRELLIS's DINOv2 conditioner: 1 + 4 registers + 37^2, batch 1
])
def test_packed_attention_kernel_matches_plain(b, n_pad, n_real):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(b, n_pad, 3 * 1024, device="cuda", generator=g).bfloat16()
    qkv[:, n_real:] = float("nan")  # pad rows must not reach real outputs
    launches = port.KERNEL_LAUNCHES.count
    got = port.packed_sdpa(qkv, 16, n_real).float()[:, :n_real]
    torch.cuda.synchronize()
    assert port.KERNEL_LAUNCHES.count == launches + 1
    want = port.packed_sdpa_reference(qkv.float(), 16, n_real)[:, :n_real]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= MAX_ABS_TOL
    assert ((got - want).norm() / want.norm()).item() <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_pad,n_real", [
    (1, 1408, 1374),   # DINOv2-giant: 1 + 4 registers + 37^2 tokens at 518 px, batch 1
    (2, 384, 325),     # a ragged last key tile at 24 heads
])
def test_packed_attention_kernel_giant_matches_plain(b, n_pad, n_real):
    """24 heads of 64 (width 1536): rows of 3 x 1536 bf16, the grid's y 24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(b, n_pad, 3 * 1536, device="cuda", generator=g).bfloat16()
    qkv[:, n_real:] = float("nan")  # pad rows must not reach real outputs
    launches = port.KERNEL_LAUNCHES.count
    got = port.packed_sdpa(qkv, 24, n_real).float()[:, :n_real]
    torch.cuda.synchronize()
    assert port.KERNEL_LAUNCHES.count == launches + 1
    want = port.packed_sdpa_reference(qkv.float(), 24, n_real)[:, :n_real]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= MAX_ABS_TOL
    assert ((got - want).norm() / want.norm()).item() <= REL_TOL


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


# K1's d`qkv` on the card (kernel forward, plain fp32 backward, rounded to
# bf16) against the fp32 plain version's autograd gradient from the same
# bf16 qkv and a bf16-exact cotangent: the bf16 rounding of the result puts
# the relative L2 error near 1e-3; a gradient cut off at the attention
# output would be 1.0.
GRAD_REL_TOL = 5e-3
GRAD_MAX_ABS_TOL = 1e-2   # times the largest |gradient|


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_pad,n_real", [
    (2, 384, 325),
    (2, 1408, 1370),   # MoGe ViT-L's 1 + 37^2 tokens at 518 px (the train step)
])
def test_packed_attention_is_differentiable_on_the_card(b, n_pad, n_real):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(4)
    base = torch.randn(b, n_pad, 3 * 1024, device="cuda", generator=g).bfloat16()
    cot = torch.randn(b, n_pad, 1024, device="cuda", generator=g).bfloat16().float()
    cot[:, n_real:] = 0.0  # pad rows feed nothing downstream, as in the ViT
    qkv = base.clone().requires_grad_()
    launches, backward = port.KERNEL_LAUNCHES.count, port.BACKWARD_CALLS.count
    out = port.packed_sdpa(qkv, 16, n_real)
    assert out.grad_fn is not None and port.KERNEL_LAUNCHES.count == launches + 1
    (out.float() * cot).sum().backward()
    assert port.BACKWARD_CALLS.count == backward + 1
    ref = base.float().requires_grad_()
    (port.packed_sdpa_reference(ref, 16, n_real) * cot).sum().backward()
    got, want = qkv.grad.float(), ref.grad
    assert ((got - want).norm() / want.norm()).item() <= GRAD_REL_TOL
    assert (got - want).abs().max().item() <= GRAD_MAX_ABS_TOL * want.abs().max().item()
    nan = base.clone()
    nan[:, n_real:] = float("nan")
    nan.requires_grad_()
    (port.packed_sdpa(nan, 16, n_real).float() * cot).sum().backward()
    assert torch.isfinite(nan.grad).all()
    assert torch.equal(nan.grad[:, :n_real], qkv.grad[:, :n_real])


@pytest.mark.cuda
def test_flash_attention_raises_under_grad_on_the_card():
    """K2 has no backward: with grad enabled and an input that requires
    grad it raises, rather than return an output cut from the graph."""
    _cuda_or_skip()
    q, k, v = (torch.randn(1, 128, 12, 64, device="cuda").bfloat16() for _ in range(3))
    out = port.flash_sdpa(q, k, v)  # nothing requires grad
    with torch.no_grad():
        assert torch.equal(port.flash_sdpa(q, k, v.requires_grad_()), out)
    with pytest.raises(RuntimeError, match="no backward"):
        port.flash_sdpa(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,masked,strided", [
    (4, 1296, 1296, None, False),         # the matcher decoder's self-attention
    (2, 1296, 777, None, True),           # cross shape, q read through strides
    (2, 1296, 1296, (1195, 1296), False),  # segment ids, NaN in every pad row
    (1, 5, 67, None, False),              # one partial tile each way
    (2, 1, 1296, None, False),            # Sq = 1
    (2, 300, 1, None, False),             # Sk = 1
    (2, 300, 129, None, False),           # one key past a whole tile
    (2, 1296, 1296, (128, 256), False),   # segment ids masking a whole key tile
    (2, 1296, 1296, (0, 1), False),       # segment ids masking key 0
])
def test_flash_attention_kernel_matches_plain(b, sq, sk, masked, strided):
    """`masked` = (lo, hi): keys lo..hi-1 carry a non-zero segment id, and
    those rows of q, k and v hold NaN; only the other rows are compared."""
    _flash_check(b, sq, sk, masked, strided, heads=12)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,masked", [
    (36, 1024, None),           # the MASt3R rope encoder: 4 references + 32 views
    (4, 1024, (923, 1024)),     # a padded rope encoder's segment ids
])
def test_flash_attention_kernel_16_heads(b, s, masked):
    _flash_check(b, s, s, masked, False, heads=16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,masked", [
    (2, 4096, 4096, None),           # TRELLIS's SS flow: 16^3 tokens, CFG as a batch of 2
    (2, 4096, 1374, None),           # its cross-attention to the DINOv2 tokens (ragged tail)
    (2, 8192, 8192, (7168, 8192)),   # the SLat torso's largest bucket, pad slots masked
    (2, 8192, 1374, None),           # the SLat torso's cross-attention
])
def test_flash_attention_kernel_trellis_shapes(b, sq, sk, masked):
    _flash_check(b, sq, sk, masked, False, heads=16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,heads", [
    (7, 1297, 1297, 12),     # SVRM's encoder: 7 views of 1 + 36^2 tokens (odd Sq)
    (1, 12288, 12288, 16),   # an LRM block's self-attention over 3 x 64^2 plane tokens
    (1, 12288, 9079, 16),    # its cross-attention to the 7 x 1297 view tokens
])
def test_flash_attention_kernel_svrm_shapes(b, sq, sk, heads):
    _flash_check(b, sq, sk, None, False, heads=heads)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_fused_qkv_columns():
    """SVRM's encoder splits one (B, S, 3W) projection: q, k and v are
    column views of it (row stride 3W), read in place."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn(7, 1297, 3 * 768, device="cuda", generator=g).bfloat16()
    q, k, v = (qkv[..., i * 768:(i + 1) * 768].unflatten(-1, (12, 64)) for i in range(3))
    launches = port.FLASH_LAUNCHES.count
    got = port.flash_sdpa(q, k, v).float()
    torch.cuda.synchronize()
    assert port.FLASH_LAUNCHES.count == launches + 1
    want = port.flash_sdpa_reference(q.float(), k.float(), v.float())
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= MAX_ABS_TOL
    assert ((got - want).norm() / want.norm()).item() <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_pad,n_real,heads", [
    (2, 1152, 1025, 2),   # the elevation matcher's tiny ViT: 256^2 views, patch 8, + cls
    (2, 128, 65, 2),      # the same at the tiny factory's 64-px views
    (3, 64, 61, 2),       # Npad = 64: two of a block's three warpgroups have no rows
    (1, 256, 129, 2),     # one key past a whole tile
    (4, 640, 577, 32),    # many heads of 32 (columns h * 32 of the packed rows)
])
def test_packed_attention_kernel_head_dim_32_matches_plain(b, n_pad, n_real, heads):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(b, n_pad, 3 * heads * 32, device="cuda", generator=g).bfloat16()
    qkv[:, n_real:] = float("nan")  # pad rows must not reach real outputs
    launches = port.KERNEL_LAUNCHES.count
    got = port.packed_sdpa(qkv, heads, n_real).float()[:, :n_real]
    torch.cuda.synchronize()
    assert port.KERNEL_LAUNCHES.count == launches + 1
    want = port.packed_sdpa_reference(qkv.float(), heads, n_real)[:, :n_real]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= MAX_ABS_TOL
    assert ((got - want).norm() / want.norm()).item() <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,masked,strided", [
    (1, 1024, 1024, None, False),         # the elevation matcher's tiny decoder at 256^2
    (1, 64, 64, None, False),             # the same at 64-px views
    (2, 1024, 777, None, True),           # cross shape, q read through strides
    (2, 300, 300, (250, 300), False),     # segment ids, NaN in every pad row
    (2, 5, 129, None, False),             # partial tiles, one key past a whole tile
])
def test_flash_attention_kernel_head_dim_32_matches_plain(b, sq, sk, masked, strided):
    _flash_check(b, sq, sk, masked, strided, heads=2, d=32)


def _flash_check(b, sq, sk, masked, strided, heads, d=64):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(1)

    def rand(s):
        return torch.randn(b, s, heads, d, device="cuda", generator=g).bfloat16()

    q, k, v = rand(sq), rand(sk), rand(sk)
    if strided:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    seg, real = None, slice(None)
    if masked:
        lo, hi = masked
        seg = torch.zeros(b, sk, dtype=torch.int32, device="cuda")
        seg[:, lo:hi] = 1
        for t in (q, k, v):
            t[:, lo:hi] = float("nan")
        real = (seg[0] == 0).nonzero()[:, 0]
    launches = port.FLASH_LAUNCHES.count
    got = port.flash_sdpa(q, k, v, seg).float()[:, real]
    torch.cuda.synchronize()
    assert port.FLASH_LAUNCHES.count == launches + 1
    want = port.flash_sdpa_reference(q.float(), k.float(), v.float(), seg)[:, real]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= MAX_ABS_TOL
    assert ((got - want).norm() / want.norm()).item() <= REL_TOL


@pytest.mark.cuda
def test_flash_attention_kernel_takes_broadcast_operands():
    """k and v broadcast over the batch (stride 0) and a single head: the
    tensor maps read them through their strides as they are."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn(3, 200, 1, 64, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(1, 150, 1, 64, device="cuda", generator=g).bfloat16().expand(3, -1, -1, -1)
            for _ in range(2))
    got = port.flash_sdpa(q, k, v).float()
    torch.cuda.synchronize()
    want = port.flash_sdpa_reference(q.float(), k.float(), v.float())
    assert (got - want).abs().max().item() <= MAX_ABS_TOL
    assert ((got - want).norm() / want.norm()).item() <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("pairs,s,n,pad", [(2, 1000, 70001, 0), (1, 64, 4096, 37)])
def test_nn_argmax_kernel_matches_plain(precision, pairs, s, n, pad):
    """Same bf16-rounded operands: best scores agree to 1e-5 (fp32 sums of
    24 products of unit vectors in another order); indices agree wherever
    the plain best beats the runner-up by more than that. Bank rows at and
    beyond n_real hold NaN and 1e30 and must never be read."""
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.nn.functional.normalize(torch.randn(pairs, s, 24, device="cuda", generator=g),
                                      dim=-1)
    bank = torch.nn.functional.normalize(torch.randn(pairs, n, 24, device="cuda", generator=g),
                                         dim=-1)
    bank[:, 5] = bank[:, 3]  # exact duplicate rows: ties go to the first
    bank_p, _ = rnn.pad_bank_for_nn(bank)
    n_real = n - pad
    bank_p[:, n_real::2] = float("nan")
    bank_p[:, n_real + 1::2] = 1e30
    launches = rnn.KERNEL_LAUNCHES.count
    idx, best = rnn.nn_argmax(q, bank_p, n_real=n_real, precision=precision)
    torch.cuda.synchronize()
    assert rnn.KERNEL_LAUNCHES.count == launches + 1
    ref_idx, ref_best = rnn.nn_argmax_reference(q, bank_p, n_real=n_real, precision=precision)
    assert ((idx >= 0) & (idx < n_real)).all()
    assert (best - ref_best).abs().max().item() <= 1e-5
    qh, ql = rnn._split_bf16(q)
    bh, bl = rnn._split_bf16(bank[:, :n_real])
    sim = torch.einsum("psc,pnc->psn", qh, bh)
    if precision == "bf16x3":
        sim += torch.einsum("psc,pnc->psn", qh, bl) + torch.einsum("psc,pnc->psn", ql, bh)
    top2 = sim.topk(2, dim=-1).values
    assert not (idx == 5).any()  # row 5 repeats row 3, which comes first
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5
    assert torch.equal(idx[clear], ref_idx[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("i,n", [(16, 500), (128, 512), (3, 1)])
def test_yaw_minarea_kernel_matches_plain(i, n):
    """Yaws equal wherever the best area beats the runner-up by more than
    1e-6 relative; elsewhere the kernel's area is within 1e-6 of the least."""
    import math

    from labelany3d_tpu_torch.ops import boxfit_yaw as by

    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(3)
    pts = torch.randn(i, n, 2, device="cuda", generator=g) * torch.tensor([2.0, 0.5],
                                                                          device="cuda")
    valid = torch.rand(i, n, device="cuda", generator=g) > 0.3
    valid[0] = False
    launches = by.KERNEL_LAUNCHES.count
    yaw = by.yaw_minarea(pts, valid)
    torch.cuda.synchronize()
    assert by.KERNEL_LAUNCHES.count == launches + 1
    ref = by.yaw_minarea_reference(pts, valid)
    area = by.footprint_areas(pts, valid)
    top2 = area.topk(2, dim=-1, largest=False).values
    finite = torch.isfinite(top2[:, 0])
    clear = ~finite | ((top2[:, 1] - top2[:, 0]) > 1e-6 * top2[:, 0].abs())
    assert torch.equal(yaw[clear], ref[clear])
    at_k = area.gather(1, torch.round(yaw / ((math.pi / 2) / 512)).long()[:, None])[:, 0]
    excess = ((at_k - top2[:, 0]) / top2[:, 0].abs().clamp_min(1e-30))[~clear]
    assert excess.numel() == 0 or excess.max().item() <= 1e-6


def _unit(g, *shape):
    return torch.nn.functional.normalize(torch.randn(*shape, device="cuda", generator=g), dim=-1)


def _nn_check(q, bank_p, n_real, precision):
    """The kernel on the prepared bank against the plain version on the
    float32 one: scores within 1e-5, indices equal wherever the plain best
    beats the runner-up by more than that."""
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    prep, _ = rnn.prepare_bank_for_nn(bank_p, precision)
    launches = rnn.KERNEL_LAUNCHES.count
    idx, best = rnn.nn_argmax(q, prep, n_real=n_real, precision=precision)
    torch.cuda.synchronize()
    assert rnn.KERNEL_LAUNCHES.count == launches + 1
    ref_idx, ref_best = rnn.nn_argmax_reference(q, bank_p, n_real=n_real, precision=precision)
    assert ((idx >= 0) & (idx < n_real)).all()
    assert (best - ref_best).abs().max().item() <= 1e-5
    bh, bl = rnn._bank_parts(bank_p[:, :n_real], q.shape[-1], precision)
    qh, ql = rnn._split_bf16(q)
    sim = torch.einsum("psc,pnc->psn", qh, bh)
    if bl is not None:
        sim += torch.einsum("psc,pnc->psn", qh, bl) + torch.einsum("psc,pnc->psn", ql, bh)
    top2 = sim.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5
    assert torch.equal(idx[clear], ref_idx[clear])
    return idx, best


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("pairs,s,n,n_real,negative", [
    (2, 1, 4096, 4096, False),       # S = 1
    (2, 191, 4096, 4000, False),     # S no multiple of a block's 256 query rows
    (2, 257, 4096, 4096, False),     # one query row past a block
    (3, 300, 4096, 128, False),      # n_real = one bank tile
    (3, 300, 4096, 129, False),      # one bank tile and one row
    (2, 500, 70001, 69964, True),    # every score negative, n_real inside a tile
    (1, 4096, 70000, 70000, False),  # P = 1: the bank split over blocks
    (32, 1024, 8192, 8000, False),   # P = 32, the matcher's pairs
])
def test_nn_argmax_kernel_edges(precision, pairs, s, n, n_real, negative):
    """Tile and block edges of the Hopper design. With `negative`, bank rows
    lie in the positive orthant and queries are negated bank rows: a
    zero-filled row past n_real, left unmasked, would score 0 and win."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(5)
    bank = _unit(g, pairs, n, 24)
    if negative:
        bank = bank.abs()
        q = -bank[:, torch.randperm(n_real, device="cuda", generator=g)[:s]]
    else:
        q = _unit(g, pairs, s, 24)
    bank_p = torch.nn.functional.pad(bank, (0, 8))
    bank_p[:, n_real:] = float("nan")
    _, best = _nn_check(q, bank_p, n_real, precision)
    if negative:
        assert best.max().item() < 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("where", ["tile", "split"])
def test_nn_argmax_kernel_first_of_duplicates(precision, where):
    """Bank rows repeated on both sides of every tile boundary, with 32
    pairs (one chunk) and with one pair (the bank cut over blocks, whose
    chunks hold whole tiles and are merged): every query equal to such a
    row gets the first of the two, across tiles and across chunks."""
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    _cuda_or_skip()
    pairs, s, n = (32, 1024, 4096) if where == "tile" else (1, 64, 4096)
    chunks = rnn.bank_chunks(pairs, s, n)
    assert chunks == 1 if where == "tile" else chunks > 1
    g = torch.Generator(device="cuda").manual_seed(6)
    bank = _unit(g, pairs, n, 24)
    firsts = torch.arange(127, n - 1, 128, device="cuda")  # the last row of each tile
    bank[:, firsts + 1] = bank[:, firsts]
    want = firsts[torch.arange(s, device="cuda") % firsts.numel()]
    q = bank[:, want]
    idx, _ = _nn_check(q, torch.nn.functional.pad(bank, (0, 8)), n, precision)
    assert (idx == want.to(idx.dtype)).all()


@pytest.mark.cuda
def test_nn_argmax_launches_by_shape():
    """Each launch is counted once, under its (pairs, queries, chunks,
    precision); the matcher's 32-pair rounds run one chunk, one pair
    splits the bank."""
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(9)
    n = 262144
    assert rnn.bank_chunks(32, 4096, n) == rnn.bank_chunks(32, 1024, n) == 1
    bank, _ = rnn.prepare_bank_for_nn(_unit(g, 1, 5000, 24))
    rnn.LAUNCHES_BY_SHAPE.clear()
    for s in (1, 300, 300):
        rnn.nn_argmax(_unit(g, 1, s, 24), bank)
    chunks = rnn.bank_chunks(1, 300, 5000)
    assert chunks > 1
    assert dict(rnn.LAUNCHES_BY_SHAPE) == {(1, 1, rnn.bank_chunks(1, 1, 5000), "bf16"): 1,
                                           (1, 300, chunks, "bf16"): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("i", [1, 128])
def test_yaw_minarea_kernel_degenerate_instances(i):
    """An instance with one valid point has area 0 at every angle, so yaw 0
    across all of its blocks; one with none has infinite area everywhere,
    yaw 0 too. Every other instance matches the plain version."""
    from labelany3d_tpu_torch.ops import boxfit_yaw as by

    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(7)
    pts = torch.randn(i, 500, 2, device="cuda", generator=g)
    valid = torch.rand(i, 500, device="cuda", generator=g) > 0.3
    valid[0] = False
    valid[0, 7] = True  # one valid point
    if i > 1:
        valid[1] = False  # none
    yaw = by.yaw_minarea(pts, valid)
    torch.cuda.synchronize()
    ref = by.yaw_minarea_reference(pts, valid)
    assert yaw[0].item() == 0.0 and ref[0].item() == 0.0
    if i > 1:
        assert yaw[1].item() == 0.0 and ref[1].item() == 0.0
    area = by.footprint_areas(pts, valid)
    top2 = area.topk(2, dim=-1, largest=False).values
    clear = ~torch.isfinite(top2[:, 0]) | ((top2[:, 1] - top2[:, 0]) > 1e-6 * top2[:, 0].abs())
    assert torch.equal(yaw[clear], ref[clear])


@pytest.mark.cuda
def test_reciprocal_nn_match_prepares_each_bank_once(monkeypatch):
    """A match prepares its two banks once and hands them to all of its
    kernel launches: 2 for round 1 and 2 for each later round."""
    from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

    _cuda_or_skip()
    calls = []
    prepare = rnn.prepare_bank_for_nn
    monkeypatch.setattr(rnn, "prepare_bank_for_nn",
                        lambda *a, **k: calls.append(1) or prepare(*a, **k))
    g = torch.Generator(device="cuda").manual_seed(8)
    d0, d1 = _unit(g, 3, 64, 48, 24), _unit(g, 3, 64, 48, 24)
    launches = rnn.KERNEL_LAUNCHES.count
    res = rnn.reciprocal_nn_match(d0, d1, subsample=4, compact=64)
    torch.cuda.synchronize()
    assert len(calls) == 2
    assert rnn.KERNEL_LAUNCHES.count - launches == 2 + 2 * 5
    assert res.xy0.shape == (3, 16 * 12, 2) and res.valid.dtype == torch.bool


@pytest.mark.cuda
def test_trellis_card_matches_cpu():
    """TRELLIS at a reduced config with head dim 64 (`chip_smoke.py`'s phase
    11(c)): the card, where K1 and K2 run, against the CPU's plain
    versions, stage by stage from the same inputs and weights; relative L2
    within `chip_smoke.TRELLIS_REL_TOL`."""
    _cuda_or_skip()
    import chip_smoke

    res = chip_smoke.trellis_card_vs_cpu()
    assert res["launches"]["k1"] > 0 and res["launches"]["k2"] > 0
    for name in ("cond", "latent", "slat", "means"):
        assert res[name] <= chip_smoke.TRELLIS_REL_TOL, (name, res[name])


@pytest.mark.cuda
def test_scoring_card_matches_cpu():
    """COCO3D scoring (`chip_smoke.py`'s phase 15(c)) at a small size: the
    card's per-pair IoUs against the CPU's on the same matched pairs, within
    `chip_smoke.SCORE_CARD_TOL`, and a file scored against itself gives 1.0."""
    _cuda_or_skip()
    import chip_smoke
    from labelany3d_tpu_torch.export import evaluate

    ours, theirs = chip_smoke.synthetic_coco3d_pair(64, 8, seed=121)
    ca, cb, _ = evaluate.matched_corners(ours, theirs)
    assert len(ca) > 256
    assert chip_smoke.score_card_vs_cpu(ca, cb) <= chip_smoke.SCORE_CARD_TOL
    assert evaluate.compare_coco3d(theirs, theirs, device="cuda")["mean_iou3d"] == 1.0
