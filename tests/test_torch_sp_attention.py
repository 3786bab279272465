"""Sequence-parallel attention (`parallel/sp.py`) over 4 gloo ranks on the
CPU, both modes, against JAX `make_sp_attention` on the conftest's
8-device mesh and against dense attention, at 2e-5 absolute and 2e-4
relative (`tests/test_sp_attention.py`'s tolerances). Each rank holds 16
of the 64 tokens; the ranks run through `parallel.launch.run_ranks`."""

import jax.numpy as jnp
import numpy as np
import pytest

from labelany3d_tpu.parallel.mesh import make_mesh as jmake_mesh
from labelany3d_tpu.parallel.sp import make_sp_attention as jmake_sp_attention
from labelany3d_tpu_torch.parallel.dryrun import sp_worker
from labelany3d_tpu_torch.parallel.launch import run_ranks


def _dense_reference(q, k, v):
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = np.einsum("qhd,khd->hqk", q, k) * scale
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("hqk,khd->qhd", p, v)


@pytest.mark.parametrize("mode", ["gathered", "ring"])
def test_sp_attention_matches_jax_and_dense(mode):
    rng = np.random.default_rng(0)
    s, h, d = 64, 2, 16
    q, k, v = (rng.normal(size=(s, h, d)).astype(np.float32) for _ in range(3))
    mesh = jmake_mesh(data=8, model=1)
    with mesh:
        want = np.asarray(jmake_sp_attention(mesh, axis="data", mode=mode)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    rows = run_ranks(sp_worker, 4, device="cpu", args=(q, k, v, mode), timeout=120.0)
    assert [r.shape for r in rows] == [(16, h, d)] * 4
    got = np.concatenate(rows)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(got, _dense_reference(q, k, v), atol=2e-5, rtol=2e-4)


def test_sp_attention_rejects_an_unknown_mode():
    from labelany3d_tpu_torch.parallel.sp import make_sp_attention

    with pytest.raises(ValueError, match="mode"):
        make_sp_attention(None, mode="striped")
