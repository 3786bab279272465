"""Packed attention: the port's plain version against the JAX package.

On the CPU `labelany3d_tpu.ops.attention.packed_flash_sdpa` runs its XLA
reference (`_packed_reference`); the port's `packed_sdpa` runs its plain
PyTorch version. Both in float32 on the same numpy inputs. Tolerance 2e-5
absolute: f32 softmax attention over <= 256 keys, summed in another order.
The CUDA kernel is compared with the plain version on the card by
`chip_smoke.py` and by `tests/test_torch_kernels_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from labelany3d_tpu.ops.attention import packed_flash_sdpa
from labelany3d_tpu_torch.ops import attention as port

TOL = 2e-5


@pytest.mark.parametrize("b,n_pad,heads,d,n_real", [
    (2, 128, 2, 64, 97),    # kernel head dim, partial last key tile
    (1, 256, 4, 32, 200),   # d=32 (plain version only)
    (2, 128, 2, 64, 128),   # no padding
])
def test_packed_sdpa_matches_jax(b, n_pad, heads, d, n_real):
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((b, n_pad, 3 * heads * d)).astype(np.float32)
    want = np.asarray(packed_flash_sdpa(jnp.asarray(qkv), heads, n_real))
    got = port.packed_sdpa(torch.from_numpy(qkv), heads, n_real).numpy()
    np.testing.assert_allclose(got[:, :n_real], want[:, :n_real], atol=TOL, rtol=0)


def test_pad_rows_do_not_leak():
    """Real rows are unchanged when pad rows hold large values or NaN."""
    rng = np.random.default_rng(1)
    b, n_pad, heads, d, n_real = 2, 128, 2, 64, 70
    qkv = rng.standard_normal((b, n_pad, 3 * heads * d)).astype(np.float32)
    base = port.packed_sdpa(torch.from_numpy(qkv), heads, n_real).numpy()
    for fill in (1e4, np.nan):
        poisoned = qkv.copy()
        poisoned[:, n_real:] = fill
        got = port.packed_sdpa(torch.from_numpy(poisoned), heads, n_real).numpy()
        np.testing.assert_array_equal(got[:, :n_real], base[:, :n_real])


def test_counters_and_cpu_route():
    port.KERNEL_LAUNCHES.reset()
    port.PLAIN_CALLS.reset()
    qkv = torch.zeros(1, 64, 3 * 64)
    port.packed_sdpa(qkv, 1, 10)
    assert port.PLAIN_CALLS.count == 1 and port.KERNEL_LAUNCHES.count == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.packed_sdpa_kernel(qkv, 1, 10)


@pytest.mark.parametrize("d", [16, 40, 48, 80, 128])
def test_kernel_wrappers_raise_for_other_head_dims(d):
    """K1 and K2 are built for head dims 32 and 64 (`attention_sm90.cuh`'s
    Tiles<D>); the wrappers refuse any other before reaching a device, so
    the CPU sees the refusal the card would. 32 and 64 pass the head-dim
    check and stop at the device check here."""
    heads = 2
    qkv = torch.zeros(1, 64, 3 * heads * d, dtype=torch.bfloat16)
    q = torch.zeros(1, 64, heads, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        port.packed_sdpa_kernel(qkv, heads, 64)
    with pytest.raises(ValueError, match="head dims"):
        port.flash_sdpa_kernel(q, q, q)
    assert port.KERNEL_HEAD_DIMS == (32, 64)
    for ok in port.KERNEL_HEAD_DIMS:
        with pytest.raises(ValueError, match="CUDA"):
            port.packed_sdpa_kernel(torch.zeros(1, 64, 3 * heads * ok), heads, 64)
        with pytest.raises(ValueError, match="CUDA"):
            port.flash_sdpa_kernel(*(torch.zeros(1, 64, heads, ok),) * 3)
