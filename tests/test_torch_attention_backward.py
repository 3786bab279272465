"""K2's backward and the row log-sum-exp on the CPU: the port's plain
versions of the two backward kernels (`csrc/attention_bwd_sm90.cuh`)
against the Pallas TPU library's own references and against `jax.vjp` of
the JAX package's `flash_sdpa`, the port's attention under autograd against
`jax.grad`, and a rope ViT's parameter gradients against the JAX ViT's.

The library's references (`mha_reference_no_custom_vjp`,
`mha_reference_bwd`) are plain JAX, so they run on the CPU as they are;
`mha_reference_bwd` takes `sm_scale = 1` only, so q goes in pre-scaled by
1/sqrt(d) and its dq is scaled back. With segment ids the library masks
`q_id != kv_id`, so its pad queries attend only to pad keys, while the port
(and the JAX package's non-TPU path) masks keys only: the two agree wherever
the cotangent of the pad query rows is zero, which is what a ViT gives (it
slices the pad rows off), so those comparisons use that cotangent.

Everything is float32. Tolerances: 1e-5 absolute on LSE (one logsumexp in
another order); gradients within 1e-4 relative L2 of the yardstick and 1e-5
of its largest entry absolute (float32 products in another order, the
softmax's exp taken from the LSE rather than from m and l).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_bwd,
    mha_reference_no_custom_vjp,
)

from labelany3d_tpu.models.matcher import MatcherConfig as JMatcherConfig
from labelany3d_tpu.models.vit import ViT as JViT
from labelany3d_tpu.ops.attention import flash_sdpa as jflash_sdpa
from labelany3d_tpu.ops.attention import packed_flash_sdpa as jpacked
from labelany3d_tpu_torch.models.matcher import MatcherConfig
from labelany3d_tpu_torch.models.vit import ViT
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from labelany3d_tpu_torch.ops import attention as att
from tests.torch_parity import random_flax_params

LSE_TOL = 1e-5
GRAD_REL_TOL = 1e-4
GRAD_ABS_TOL = 1e-5   # times the largest |gradient| of the yardstick


def _close(got, want, err_msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    scale = max(np.abs(want).max(), 1e-30)
    assert np.linalg.norm(got - want) <= GRAD_REL_TOL * np.linalg.norm(want), err_msg
    assert np.abs(got - want).max() <= GRAD_ABS_TOL * scale, err_msg


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))
    cot = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, cot


def _ids(b, s, pad):
    ids = np.zeros((b, s), np.int32)
    if pad:
        ids[:, s - pad:] = 1
    return ids


def _port(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _library(q, k, v, cot, ids, q_ids):
    """The library's references in (B, H, S, D): out, m + log(l), and
    (dq, dk, dv), with q pre-scaled and dq scaled back; back in (B, S, H, D)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qs, kb, vb, gb = _bhsd(q * scale), _bhsd(k), _bhsd(v), _bhsd(cot)
    seg = None if ids is None else SegmentIds(jnp.asarray(q_ids), jnp.asarray(ids))
    out, l, m = mha_reference_no_custom_vjp(qs, kb, vb, None, seg, save_residuals=True)
    dq, dk, dv, _ = mha_reference_bwd(qs, kb, vb, None, seg, out, l, m, gb)
    back = lambda t: np.asarray(t).transpose(0, 2, 1, 3)  # noqa: E731
    return back(out), np.asarray(m + jnp.log(l)), (back(dq) * scale, back(dk), back(dv))


@pytest.mark.parametrize("b,sq,sk,h,d,pad", [
    (1, 256, 256, 2, 64, 56),   # 56 keys masked by segment ids
    (2, 200, 77, 2, 64, 0),     # cross attention, Sq != Sk
    (2, 96, 96, 2, 32, 17),     # head dim 32
])
def test_lse_reference_matches_library(b, sq, sk, h, d, pad):
    q, k, _, _ = _inputs(b, sq, sk, h, d)
    ids = _ids(b, sk, pad) if pad else None
    # Key ids only (query ids 0): the library's mask is then the port's.
    _, want, _ = _library(q, k, k, np.zeros_like(q), ids, np.zeros((b, sq), np.int32))
    got = att.flash_sdpa_lse_reference(*_port(q, k), None if ids is None else _port(ids)[0])
    assert got.shape == (b, h, sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LSE_TOL, rtol=0)


def test_lse_reference_of_a_fully_masked_row_is_inf():
    """A row whose keys are all masked has output 0 and LSE +inf, which
    makes its P = 0 in the backward."""
    q, k, _, _ = _inputs(1, 8, 8, 2, 32)
    got = att.flash_sdpa_lse_reference(*_port(q, k), torch.ones(1, 8, dtype=torch.int32))
    assert torch.isinf(got).all() and (got > 0).all()


@pytest.mark.parametrize("b,s,h,d,pad", [(1, 256, 2, 64, 56), (2, 96, 2, 32, 0)])
def test_backward_reference_matches_library(b, s, h, d, pad):
    q, k, v, cot = _inputs(b, s, s, h, d, seed=1)
    ids = _ids(b, s, pad) if pad else None
    if pad:
        # The library's pad queries attend only to pad keys; with their
        # cotangent zero (as the ViT's slicing gives) the two masks agree.
        cot[:, s - pad:] = 0.0
    out, lse, want = _library(q, k, v, cot, ids, ids if pad else None)
    tq, tk, tv, tcot, tout = _port(q, k, v, cot, out)
    seg = None if ids is None else _port(ids)[0]
    lse_port = att.flash_sdpa_lse_reference(tq, tk, seg)
    got = att.flash_sdpa_backward_reference(tq, tk, tv, tout, lse_port, tcot, seg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, name)


def _jax_vjp(q, k, v, cot, ids):
    seg = None if ids is None else jnp.asarray(ids)
    out, vjp = jax.vjp(lambda a, b_, c: jflash_sdpa(a, b_, c, seg), *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("b,sq,sk,h,d,pad", [
    (1, 256, 256, 2, 64, 56),
    (2, 128, 128, 3, 64, 0),
    (2, 200, 77, 2, 64, 0),     # Sq != Sk
    (1, 160, 160, 2, 32, 31),   # head dim 32 with segment ids
])
def test_backward_reference_matches_jax_vjp(b, sq, sk, h, d, pad):
    q, k, v, cot = _inputs(b, sq, sk, h, d, seed=2)
    ids = _ids(b, sk, pad) if pad else None
    out, want = _jax_vjp(q, k, v, cot, ids)
    tq, tk, tv, tcot, tout = _port(q, k, v, cot, out)
    seg = None if ids is None else _port(ids)[0]
    got = att.flash_sdpa_backward_reference(tq, tk, tv, tout,
                                            att.flash_sdpa_lse_reference(tq, tk, seg), tcot, seg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, name)


def test_backward_reference_reads_strided_and_broadcast_inputs():
    """q through a transposed view, k and v broadcast over the batch (the
    layouts the card's kernel reads in place): the gradients of the
    broadcast operands are per batch, and their sums are JAX's."""
    b, sq, sk, h, d = 3, 100, 70, 2, 64
    q, k, v, cot = _inputs(b, sq, sk, h, d, seed=3)
    k1, v1 = k[:1], v[:1]
    out, want = _jax_vjp(q, np.broadcast_to(k1, k.shape), np.broadcast_to(v1, v.shape), cot,
                         None)
    tq = torch.from_numpy(q.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
    assert not tq.is_contiguous()
    tk, tv = (torch.from_numpy(t).expand(b, -1, -1, -1) for t in (k1, v1))
    tout, tcot = _port(out, cot)
    dq, dk, dv = att.flash_sdpa_backward_reference(
        tq, tk, tv, tout, att.flash_sdpa_lse_reference(tq, tk), tcot)
    assert dk.shape == (b, sk, h, d)
    _close(dq.numpy(), want[0], "dq")
    _close(dk.sum(0).numpy(), want[1].sum(0), "dk")
    _close(dv.sum(0).numpy(), want[2].sum(0), "dv")


@pytest.mark.parametrize("b,sq,sk,h,d,pad", [
    (1, 256, 256, 2, 64, 56),
    (2, 200, 77, 2, 64, 0),
    (2, 96, 96, 2, 32, 0),
])
def test_flash_sdpa_autograd_matches_jax_grad(b, sq, sk, h, d, pad):
    """`flash_sdpa` on the CPU is differentiable (its plain version under
    autograd): its gradients against `jax.grad` through the JAX package's."""
    q, k, v, cot = _inputs(b, sq, sk, h, d, seed=4)
    ids = _ids(b, sk, pad) if pad else None
    _, want = _jax_vjp(q, k, v, cot, ids)
    tq, tk, tv = (t.requires_grad_() for t in _port(q, k, v))
    out = att.flash_sdpa(tq, tk, tv, None if ids is None else _port(ids)[0])
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        _close(t.grad.numpy(), w, name)


@pytest.mark.parametrize("b,n_pad,n_real,heads,d", [(2, 128, 101, 2, 32), (1, 256, 200, 2, 64)])
def test_packed_sdpa_autograd_matches_jax_grad(b, n_pad, n_real, heads, d):
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((b, n_pad, 3 * heads * d)).astype(np.float32)
    cot = rng.standard_normal((b, n_pad, heads * d)).astype(np.float32)
    cot[:, n_real:] = 0.0  # pad rows feed nothing downstream, as in the ViT
    want = jax.grad(lambda t: jnp.sum(jpacked(t, heads, n_real) * cot))(jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_()
    (att.packed_sdpa(t, heads, n_real) * torch.from_numpy(cot)).sum().backward()
    _close(t.grad.numpy(), np.asarray(want), "dqkv")


def test_packed_lse_reference_matches_flash():
    b, n_pad, n_real, heads, d = 2, 128, 90, 2, 32
    qkv = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, n_pad, 3 * heads * d)).astype(np.float32))
    q, k, _ = qkv.view(b, n_pad, 3, heads, d).unbind(2)
    ids = torch.zeros(b, n_pad, dtype=torch.int32)
    ids[:, n_real:] = 1
    torch.testing.assert_close(att.packed_sdpa_lse_reference(qkv, heads, n_real),
                               att.flash_sdpa_lse_reference(q, k, ids), rtol=0, atol=0)


def test_nan_in_masked_v_rows_reaches_no_gradient():
    """NaN in the masked keys' V (and K) rows, and in pad query rows whose
    cotangent is zero: every gradient finite and equal to the one without
    NaN (the kernels load masked rows as zeros and drop dead query rows)."""
    b, s, h, d, pad = 1, 128, 2, 64, 28
    q, k, v, cot = _inputs(b, s, s, h, d, seed=7)
    cot[:, s - pad:] = 0.0
    seg = torch.from_numpy(_ids(b, s, pad))
    tq, tk, tv, tcot = _port(q, k, v, cot)
    out = att.flash_sdpa_reference(tq, tk, tv, seg)
    lse = att.flash_sdpa_lse_reference(tq, tk, seg)
    clean = att.flash_sdpa_backward_reference(tq, tk, tv, out, lse, tcot, seg)
    nq, nk, nv, nout = (t.clone() for t in (tq, tk, tv, out))
    for t in (nq, nk, nv, nout):
        t[:, s - pad:] = float("nan")
    nan_lse = lse.clone()
    nan_lse[:, :, s - pad:] = float("nan")
    dirty = att.flash_sdpa_backward_reference(nq, nk, nv, nout, nan_lse, tcot, seg)
    for c, g in zip(clean, dirty):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, c, rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(48, 80)])  # 3 x 5 tokens, padded to 128
def test_rope_vit_parameter_gradients_match_jax(hw):
    """A depth-2 rope ViT (the tiny CroCo-style encoder: every block's
    attention through `flash_sdpa` with pad keys masked by segment ids):
    each parameter's gradient of a scalar of its tokens against `jax.grad`
    of the JAX ViT's, the parameters carried across by `models/weights.py`
    (its transposes are linear, so it carries the gradients too)."""
    jenc = JMatcherConfig.tiny_catmlpdpt_test().encoder
    tenc = MatcherConfig.tiny_catmlpdpt_test().encoder
    jcfg = dataclasses.replace(jenc, dtype=jnp.float32, depth=2, out_indices=(0, 1))
    tcfg = dataclasses.replace(tenc, dtype=torch.float32, depth=2, out_indices=(0, 1))
    rng = np.random.default_rng(8)
    images = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    jm = JViT(jcfg)
    params = random_flax_params(jm.init, jnp.asarray(images), seed=8)
    n = (hw[0] // tcfg.patch_size) * (hw[1] // tcfg.patch_size)
    cot = rng.standard_normal((2, n, tcfg.width)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda prm: jnp.sum(
        jm.apply({"params": prm}, jnp.asarray(images))["tokens"] * cot)))(params)
    model = ViT(tcfg, (hw[0] // tcfg.patch_size, hw[1] // tcfg.patch_size))
    model.load_state_dict(flax_to_state_dict(params, model))
    att.FLASH_PLAIN_CALLS.reset()
    (model(torch.from_numpy(images))["tokens"] * torch.from_numpy(cot)).sum().backward()
    assert att.FLASH_PLAIN_CALLS.count == tcfg.depth
    want = flax_to_state_dict(grads, model)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        if name.endswith("attn.qkv.bias"):
            # The key bias's gradient is zero in exact arithmetic (softmax
            # is shift-invariant per row): only rounding noise on both sides.
            w3 = p.shape[0] // 3
            keep = torch.ones(p.shape[0], dtype=torch.bool)
            keep[w3:2 * w3] = False
            _close(p.grad[keep].numpy(), want[name][keep].numpy(), name)
            continue
        _close(p.grad.numpy(), want[name].numpy(), name)


def test_backward_wrappers_raise_on_cpu_tensors_and_other_shapes():
    # The kernels' per-row scratch (LSE and D, written by the dQ kernel):
    # one fp32 array, its rows padded to the dK/dV kernel's 64-row tiles.
    rows = att._row_scratch(3, 2, 65, "cpu")
    assert rows.shape == (2, 3, 2, 128) and rows.dtype == torch.float32
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="needs CUDA"):
        att.flash_sdpa_backward_kernel(q, q, q, q, lse, q)
    q48 = torch.zeros(1, 64, 2, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        att.flash_sdpa_backward_kernel(q48, q48, q48, q48, lse, q48)
    qkv = torch.zeros(1, 128, 3 * 128, dtype=torch.bfloat16)
    out = torch.zeros(1, 128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        att.packed_sdpa_backward_kernel(qkv, out, out, torch.zeros(1, 2, 128), 2, 100)
    with pytest.raises(ValueError, match="head dims"):
        att.packed_sdpa_backward_kernel(torch.zeros(1, 128, 3 * 96, dtype=torch.bfloat16),
                                        out, out, lse, 2, 100)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        att.packed_sdpa_kernel(qkv, 2, 100, lse=True)
    with pytest.raises(ValueError, match="needs CUDA"):
        att.flash_sdpa_kernel(q, q, q, lse=True)
