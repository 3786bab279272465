"""The port's native RLE codec (`native/rle.cpp`, built with g++ into a
temporary directory and loaded with ctypes) against its numpy codec and the
JAX package's, plus `rle_area`.

Inputs: a seeded COCO-scale mask set (480 x 640, blobs of many sizes, an
empty and a full mask, masks touching the first and last pixel). Every path
must give the same run lengths, strings and masks, exactly. The numpy path
is taken when the codec cannot be built: the port says so once and counts
the calls each path served (`data.rle.PATHS`).
"""

import numpy as np
import pytest

from labelany3d_tpu.data import rle as jrle
from labelany3d_tpu_torch import native
from labelany3d_tpu_torch.data import rle
from labelany3d_tpu_torch.utils.logging import reset_warnings


def _masks(n=12, hw=(480, 640)):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    out = []
    for _ in range(n):
        m = np.zeros(hw, bool)
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(0, hw[0]), rng.uniform(0, hw[1])
            ry, rx = rng.uniform(2, 120), rng.uniform(2, 160)
            m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        out.append(m)
    edge = np.zeros(hw, bool)
    edge[0, 0] = edge[-1, -1] = True
    return out + [np.zeros(hw, bool), np.ones(hw, bool), edge]


@pytest.fixture
def native_codec(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    lib = native.load_rle()
    assert lib is not None and native.library_path().parent == tmp_path / "native"
    assert native.library_path().exists()
    return lib


def _codec_outputs(masks):
    counts = [rle.mask_to_rle(m) for m in masks]
    strings = [rle.rle_to_string(c) for c in counts]
    return counts, strings, [rle.rle_from_string(s) for s in strings], \
        [rle.rle_to_mask(c, *m.shape) for c, m in zip(counts, masks)]


def test_native_codec_matches_numpy_and_jax(native_codec, monkeypatch):
    masks = _masks()
    before = dict(rle.PATHS)
    nat = _codec_outputs(masks)
    assert rle.PATHS["native"] - before["native"] == 4 * len(masks)
    assert rle.PATHS["numpy"] == before["numpy"]
    monkeypatch.setattr(native, "load_rle", lambda: None)
    numpy_out = _codec_outputs(masks)
    assert rle.PATHS["numpy"] - before["numpy"] == 4 * len(masks)
    for got, want in zip(nat, numpy_out):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for m, c, s, back, dec in zip(masks, *nat):
        np.testing.assert_array_equal(c, jrle.mask_to_rle(m))
        assert s == jrle.rle_to_string(c)
        np.testing.assert_array_equal(back, c)
        np.testing.assert_array_equal(dec, m)


def test_numpy_fallback_warns_once(monkeypatch, capsys):
    monkeypatch.setattr(native, "load_rle", lambda: None)
    reset_warnings()
    m = _masks(n=1)[0]
    enc = rle.rle_encode(m)
    np.testing.assert_array_equal(rle.rle_decode(enc), m)
    err = capsys.readouterr().err
    assert err.count("numpy codec serves instead") == 1


def test_build_failure_means_numpy(tmp_path, monkeypatch):
    """No host compiler: `load_rle` returns None (and remembers it)."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nocompiler")
    assert native.load_rle() is None
    assert native.load_rle() is None and not (tmp_path / "nocompiler").exists()


@pytest.mark.parametrize("compressed", [True, False])
def test_rle_area_matches_jax(native_codec, compressed):
    for m in _masks(n=6):
        enc = rle.rle_encode(m, compress=compressed)
        assert rle.rle_area(enc) == jrle.rle_area(jrle.rle_encode(m, compress=compressed)) \
            == int(m.sum())
    assert rle.rle_area({"size": [2, 2], "counts": "04"}) == \
        jrle.rle_area({"size": [2, 2], "counts": "04"})
