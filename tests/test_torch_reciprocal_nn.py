"""Reciprocal nearest-neighbour matching: the port against the JAX package.

`nn_argmax` (the port's plain version of K3, on the CPU) is held against
`nn_argmax_tiled(..., interpret=True)` in both precisions: the same
bf16-rounded operands, fp32 sums in another order, so indices are equal and
best scores agree to 1e-6. One bank is pre-padded with garbage (NaN, 1e30)
beyond an `n_real` that is no multiple of the tile (ROADMAP F3).
`reciprocal_nn_match` scores in f32 on the CPU in both packages; its
matches must be equal and its scores agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.ops.reciprocal_nn import nn_argmax_tiled
from labelany3d_tpu.ops.reciprocal_nn import pad_bank_for_nn as jpad_bank_for_nn
from labelany3d_tpu.ops.reciprocal_nn import reciprocal_nn_match as jreciprocal_nn_match
from labelany3d_tpu_torch.ops import reciprocal_nn as rnn

SCORE_TOL = 1e-6
TILES = dict(block_s=32, block_n=64, inner_tiles=2)  # small tiles: several grid steps


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
def test_nn_argmax_matches_jax(precision):
    rng = np.random.default_rng(0)
    q, bank = _unit(rng, 70, 24), _unit(rng, 300, 24)
    bank[81] = bank[37]  # exact duplicate rows: ties go to the first index
    q[5] = bank[37]
    want_idx, want_best = nn_argmax_tiled(jnp.asarray(q), jnp.asarray(bank), interpret=True,
                                          precision=precision, **TILES)
    rnn.PLAIN_CALLS.reset()
    idx, best = rnn.nn_argmax(torch.from_numpy(q)[None], torch.from_numpy(bank)[None],
                              precision=precision)
    assert rnn.PLAIN_CALLS.count == 1 and rnn.KERNEL_LAUNCHES.count == 0
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(best[0].numpy(), np.asarray(want_best), atol=SCORE_TOL, rtol=0)
    assert idx[0, 5] == 37


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
def test_nn_argmax_prepadded_bank_matches_jax(precision):
    """A bank padded beyond n_real = 333 (no multiple of the 128-row tile)
    whose pad rows hold NaN and 1e30: neither package may read them."""
    rng = np.random.default_rng(1)
    q, bank = _unit(rng, 45, 24), _unit(rng, 333, 24)
    jbank, n = jpad_bank_for_nn(jnp.asarray(bank), block_n=TILES["block_n"],
                                inner_tiles=TILES["inner_tiles"])
    jbank = jbank.at[n::2].set(jnp.nan).at[n + 1::2].set(1e30)
    want_idx, want_best = nn_argmax_tiled(jnp.asarray(q), jbank, n_real=n, interpret=True,
                                          precision=precision, **TILES)
    tbank, n_t = rnn.pad_bank_for_nn(torch.from_numpy(bank)[None])
    assert n_t == n and tbank.shape[-1] == rnn.NN_WIDTH
    tbank = torch.cat([tbank, torch.full((1, 51, rnn.NN_WIDTH), float("nan"))], dim=1)
    tbank[:, n + 1::2] = 1e30
    idx, best = rnn.nn_argmax(torch.from_numpy(q)[None], tbank, n_real=n, precision=precision)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(best[0].numpy(), np.asarray(want_best), atol=SCORE_TOL, rtol=0)


def test_nn_argmax_batches_pairs_and_routes():
    rng = np.random.default_rng(2)
    q, bank = _unit(rng, 3, 40, 24), _unit(rng, 3, 200, 24)
    idx, best = rnn.nn_argmax(torch.from_numpy(q), torch.from_numpy(bank))
    for p in range(3):
        i1, b1 = rnn.nn_argmax(torch.from_numpy(q[p:p + 1]), torch.from_numpy(bank[p:p + 1]))
        assert torch.equal(idx[p], i1[0]) and torch.equal(best[p], b1[0])
    with pytest.raises(ValueError, match="CUDA"):
        rnn.nn_argmax_kernel(torch.from_numpy(q), torch.from_numpy(bank))
    with pytest.raises(ValueError, match="exceeds"):
        rnn.pad_bank_for_nn(torch.zeros(1, 4, 40))


def _desc_pair(rng, h, w, c):
    d0 = _unit(rng, h, w, c)
    d1 = np.roll(d0, (2, 3), axis=(0, 1)) + 0.3 * rng.standard_normal((h, w, c)).astype(
        np.float32)
    return d0, d1 / np.linalg.norm(d1, axis=-1, keepdims=True)


@pytest.mark.parametrize("compact", [32, 0])
def test_reciprocal_nn_match_matches_jax(compact):
    rng = np.random.default_rng(3)
    pairs = [_desc_pair(rng, 48, 40, 8) for _ in range(2)]
    got = rnn.reciprocal_nn_match(torch.from_numpy(np.stack([p[0] for p in pairs])),
                                  torch.from_numpy(np.stack([p[1] for p in pairs])),
                                  subsample=4, compact=compact)
    for k, (d0, d1) in enumerate(pairs):
        want = jreciprocal_nn_match(jnp.asarray(d0), jnp.asarray(d1), subsample=4,
                                    compact=compact)
        np.testing.assert_array_equal(got.xy0[k].numpy(), np.asarray(want.xy0))
        np.testing.assert_array_equal(got.xy1[k].numpy(), np.asarray(want.xy1))
        np.testing.assert_array_equal(got.valid[k].numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.score[k].numpy(), np.asarray(want.score),
                                   atol=SCORE_TOL, rtol=0)
        assert np.asarray(want.valid).any()
    one = rnn.reciprocal_nn_match(torch.from_numpy(pairs[0][0]), torch.from_numpy(pairs[0][1]),
                                  subsample=4, compact=compact)
    assert torch.equal(one.xy1, got.xy1[0]) and torch.equal(one.valid, got.valid[0])


def test_prepare_bank_for_nn_splits_as_jax():
    """The operands the port prepares once per match are those
    `nn_argmax_tiled` builds outside its kernel: hi = bf16(x) and
    lo = bf16(x - hi), the width zero-padded to 32 in each."""
    rng = np.random.default_rng(5)
    bank = _unit(rng, 3, 100, 24)
    x3, n = rnn.prepare_bank_for_nn(torch.from_numpy(bank), "bf16x3")
    hi, _ = rnn.prepare_bank_for_nn(torch.from_numpy(bank), "bf16")
    assert n == 100 and x3.dtype == hi.dtype == torch.bfloat16
    assert x3.shape == (3, 100, rnn.PREPARED_WIDTH["bf16x3"]) and hi.shape == (3, 100, 32)
    jb = jnp.asarray(bank)
    jh = jb.astype(jnp.bfloat16)
    jl = (jb - jh.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(x3[..., :24].float().numpy(), np.asarray(jh, np.float32))
    np.testing.assert_array_equal(x3[..., 32:56].float().numpy(), np.asarray(jl, np.float32))
    assert torch.equal(x3[..., :32], hi)
    assert not x3[..., 24:32].any() and not x3[..., 56:].any()


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
def test_nn_argmax_prepared_bank_matches_jax(precision):
    """The prepared bank through the plain version gives
    `nn_argmax_tiled(..., interpret=True)`'s indices exactly and its values
    within 1e-6, on a pre-padded bank whose rows past n_real = 333 (no
    multiple of the tile) hold NaN and 1e30, with a duplicate row."""
    rng = np.random.default_rng(6)
    q, bank = _unit(rng, 50, 24), _unit(rng, 333, 24)
    bank[200] = bank[100]
    q[3] = bank[100]
    jbank, n = jpad_bank_for_nn(jnp.asarray(bank), block_n=TILES["block_n"],
                                inner_tiles=TILES["inner_tiles"])
    jbank = jbank.at[n::2].set(jnp.nan).at[n + 1::2].set(1e30)
    want_idx, want_best = nn_argmax_tiled(jnp.asarray(q), jbank, n_real=n, interpret=True,
                                          precision=precision, **TILES)
    tbank, _ = rnn.pad_bank_for_nn(torch.from_numpy(bank)[None])
    tbank = torch.cat([tbank, torch.full((1, 51, rnn.NN_WIDTH), float("nan"))], dim=1)
    tbank[:, n + 1::2] = 1e30
    prep, _ = rnn.prepare_bank_for_nn(tbank, precision)
    rnn.PLAIN_CALLS.reset()
    idx, best = rnn.nn_argmax(torch.from_numpy(q)[None], prep, n_real=n, precision=precision)
    assert rnn.PLAIN_CALLS.count == 1
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(best[0].numpy(), np.asarray(want_best), atol=SCORE_TOL, rtol=0)
    assert idx[0, 3] == 100


@pytest.mark.parametrize("call", [
    lambda: rnn.prepare_bank_for_nn(torch.zeros(2, 5, 24), "fp32"),
    lambda: rnn.prepare_bank_for_nn(torch.zeros(2, 5, 33)),
    lambda: rnn.pad_bank_for_nn(torch.zeros(2, 5, 33)),
    lambda: rnn.nn_argmax_kernel(torch.zeros(1, 4, 24),
                                 torch.zeros(1, 8, 32, dtype=torch.bfloat16)),
], ids=["precision", "prepare_width", "pad_width", "kernel_on_cpu"])
def test_nn_inputs_are_checked(call):
    """Unknown precisions and descriptors wider than the kernel's 32 are
    refused, and the kernel's wrapper refuses CPU tensors (only
    `nn_argmax` routes them to the plain version)."""
    rnn.KERNEL_LAUNCHES.reset()
    rnn.LAUNCHES_BY_SHAPE.clear()
    with pytest.raises(ValueError):
        call()
    assert rnn.KERNEL_LAUNCHES.count == 0 and not rnn.LAUNCHES_BY_SHAPE
