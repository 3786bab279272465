"""The frozen roofline arithmetic against figures worked by hand."""

import pytest

from common import arith


def test_k1_at_the_moge_shape():
    # (8, 1408, 3072) packed qkv: 16 heads of 64; 1297 real rows and keys.
    flops, nbytes = arith.attention_fwd(8, 1297, 1297, 16, 64)
    assert flops == 4 * 8 * 16 * 64 * 1297 * 1297 == 55_122_624_512
    assert nbytes == 2 * 8 * 1024 * 4 * 1297 == 85_000_192
    assert arith.least_s(flops, nbytes) == pytest.approx(55_122_624_512 / 989e12)


def test_k2_at_the_decoder_shape():
    # (32, 1296, 12, 64): 1296 queries against 1296 keys.
    flops, nbytes = arith.attention_fwd(32, 1296, 1296, 12, 64)
    assert flops == 165_112_971_264
    assert nbytes == 254_803_968
    assert arith.least_s(flops, nbytes) * 1e3 == pytest.approx(0.16695, abs=5e-6)


def test_k3_at_the_registration_shape():
    # 32 pairs x 4096 queries against a 262144-row bank of 24-wide descriptors.
    flops, nbytes = arith.nn_argmax(32, 4096, 262144, 24)
    assert flops == 1_649_267_441_664
    assert nbytes == 2 * 32 * 24 * (4096 + 262144) + 8 * 32 * 4096 == 409_993_216
    assert arith.least_s(flops, nbytes) * 1e3 == pytest.approx(1.6676, abs=5e-5)


def test_backward_counts_five_products():
    f, _ = arith.attention_fwd(1, 100, 100, 2, 64)
    fb, nb = arith.attention_bwd(1, 100, 100, 2, 64)
    assert fb == 2.5 * f
    assert nb == 2 * 2 * 64 * 800 + 4 * 2 * 100


def test_shares_and_mfu():
    assert arith.share_pct(1.0, 4.0) == 25.0
    assert arith.share_pct(1.0, 0.0) is None
    assert arith.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
    assert arith.mfu_pct(0.0, 2.0) is None
    assert arith.calls_least_s([(3, (1, 10, 10, 1, 64))], arith.attention_fwd) == \
        pytest.approx(3 * arith.least_s(*arith.attention_fwd(1, 10, 10, 1, 64)))


def test_forward_flops_of_the_reference_vit():
    # A 2-block ViT at width 64 on 4 tokens + class token: per block the
    # qkv (3 w^2), projection (w^2) and MLP (8 w^2) products a token, and
    # the attention's two n x n x w products; the patch embedding too.
    import dataclasses

    import torch

    from common.flops import forward_flops
    from reference.vit import ViT, ViTConfig

    cfg = dataclasses.replace(ViTConfig.tiny_test(), dtype=torch.float32)
    with torch.device("meta"):
        vit = ViT(cfg, (2, 2))
    n, w = 5, 64
    per_block = 2 * n * 12 * w * w + 2 * 2 * n * n * w
    patch = 2 * 4 * (3 * 8 * 8) * w
    assert forward_flops(vit, (1, 16, 16, 3)) == 2 * per_block + patch
