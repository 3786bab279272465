"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests carry the `cuda` marker and
skip without a device. This file imports no JAX, so it also runs on a GPU
machine without it; `tests/conftest.py` imports JAX, hence:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances, against an fp32 plain version on the same bf16 inputs: 5e-3
absolute and 5e-3 relative L2 (||out - ref|| / ||ref||). The output is
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
@pytest.mark.parametrize("b,n_pad,n_real", [(2, 384, 325), (1, 1408, 1297), (1, 128, 1)])
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
