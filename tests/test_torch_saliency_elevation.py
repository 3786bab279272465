"""The port's ISNet segmenter (`models/saliency.py`), elevation estimator
(`models/elevation.py`) and TRELLIS's segmenter path against the JAX
package's, on the CPU in float32.

  * ISNet at `tiny_test()` on the same input and parameters (a seeded tree
    of the JAX shapes with positive BatchNorm variances), at a size the
    pooling ladder divides and at one where ceil-mode pooling meets odd
    sizes: every side output within 1e-4 relative and absolute.
  * `convert_isnet` on a seeded state dict with DIS's names
    (`chip_smoke.released_isnet_state`) gives the JAX converter's tree
    exactly.
  * `post_process_mask` (OpenCV in both) equal; `RembgSegmenter.remove`
    with the same weights: the RGB equal, the matte (re-binarised at 127
    after Pillow's or the port's bilinear resizes, within one level) equal
    at all but ALPHA_SHARE of its pixels; `segment_completed` with a
    deterministic segmenter equal.
  * `MatchingElevationEstimator` on a stub view source with oracle matches
    from the true orbit geometry (as `tests/test_diffusion.py`): the JAX
    package's elevation exactly, within one grid step of the truth; the
    no-match fallback; `_fundamental` and `epipolar_error` within 1e-9
    (float64).
  * `TrellisPipeline.preprocess(segmenter=...)`: an RGB crop goes through
    the segmenter's `remove`, then as before, within one level of the JAX
    package's.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from labelany3d_tpu.models import elevation as jelev
from labelany3d_tpu.models import saliency as jsal
from labelany3d_tpu.models.trellis import pipeline as jtrellis
from labelany3d_tpu.registration.cameras import opencv_orbit_pose
from labelany3d_tpu_torch.models import elevation as telev
from labelany3d_tpu_torch.models import saliency as tsal
from labelany3d_tpu_torch.models.trellis import pipeline as ttrellis
from labelany3d_tpu_torch.models.weights import flax_to_state_dict
from tests.test_torch_convert import _assert_same_tree
from tests.test_torch_diffusion_pipelines import isnet_params

TOL = 1e-4
ALPHA_SHARE = 0.01


@pytest.fixture(scope="module")
def isnet():
    cfg = jsal.ISNetConfig.tiny_test()
    return cfg, isnet_params(cfg, 64, seed=3)


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)])
def test_isnet_matches_jax(isnet, hw):
    cfg, params = isnet
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (1,) + hw + (3,)).astype(np.float32)
    want = jax.jit(lambda p, v: jsal.ISNet(cfg).apply({"params": p}, v))(params, x)
    model = tsal.ISNet(tsal.ISNetConfig.tiny_test())
    model.load_state_dict(flax_to_state_dict(params, model))
    got = model.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == (1,) + hw + (1,)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_convert_isnet_matches_jax():
    cfg = tsal.ISNetConfig.tiny_test()
    state = chip_smoke.released_isnet_state(cfg, std=0.1)
    tree = tsal.convert_isnet(state, cfg)
    _assert_same_tree(tree, jsal.convert_isnet(state, jsal.ISNetConfig.tiny_test()))
    model = tsal.ISNet(cfg)
    model.load_state_dict(flax_to_state_dict(tree, model))


def test_post_process_and_segmenter_match_jax(isnet):
    cfg, params = isnet
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=(40, 30)) > 0.4).astype(np.uint8) * 255
    np.testing.assert_array_equal(tsal.post_process_mask(mask), jsal.post_process_mask(mask))
    rgb = rng.integers(0, 256, (50, 44, 3)).astype(np.uint8)
    jseg = jsal.RembgSegmenter(cfg, params=params, input_size=64)
    tseg = tsal.RembgSegmenter(tsal.ISNetConfig.tiny_test(), params=params, input_size=64,
                               device="cpu")
    want, got = jseg.remove(rgb), tseg.remove(rgb)
    assert got.shape == want.shape == (50, 44, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., :3], rgb)
    assert set(np.unique(got[..., 3])) <= {0, 255}
    assert (got[..., 3] != want[..., 3]).mean() <= ALPHA_SHARE


class _HalfSegmenter:
    """A deterministic segmenter: the left half is the object."""

    def remove(self, rgb):
        a = np.zeros(rgb.shape[:2], np.uint8)
        a[:, : rgb.shape[1] // 2] = 255
        return np.concatenate([rgb[..., :3], a[..., None]], axis=-1)


def test_segment_completed_matches_jax():
    rng = np.random.default_rng(2)
    completed = rng.integers(0, 256, (32, 36, 3)).astype(np.uint8)
    orig = rng.integers(0, 256, (32, 36, 4)).astype(np.uint8)
    got = tsal.segment_completed(completed, orig, _HalfSegmenter())
    np.testing.assert_array_equal(got, jsal.segment_completed(completed, orig, _HalfSegmenter()))
    assert (got[..., 3][orig[..., 3] > 127] == 255).all()


def _oracle(true_elev, K):
    pts3d = np.random.default_rng(0).uniform(-0.4, 0.4, (200, 3))

    def project(elev, azim):
        R, t = opencv_orbit_pose(elev, azim, 1.5)
        cam = pts3d @ R.T + t
        uv = cam @ K.T
        return uv[:, :2] / uv[:, 2:3], cam[:, 2] > 0

    class Views:
        def generate(self, crop, de, da, seed=0):
            return (de, da)  # a token passed through to the matcher

    def match(v0, v1):
        xy0, ok0 = project(true_elev + v0[0], v0[1])
        xy1, ok1 = project(true_elev + v1[0], v1[1])
        return xy0.astype(np.float32), xy1.astype(np.float32), ok0 & ok1

    return Views(), match


@pytest.mark.parametrize("true_elev", [24.0, -37.0])
def test_elevation_estimator_matches_jax(true_elev):
    K = np.array([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]])
    views, match = _oracle(true_elev, K)
    crop = np.zeros((8, 8, 4), np.uint8)
    got = telev.MatchingElevationEstimator(views, match, K).estimate(crop)
    assert got == jelev.MatchingElevationEstimator(views, match, K).estimate(crop)
    assert got == pytest.approx(true_elev, abs=2.0)

    R0, t0 = opencv_orbit_pose(true_elev, 0.0, 1.5)
    R1, t1 = opencv_orbit_pose(true_elev + 10.0, 0.0, 1.5)
    F = telev._fundamental(K, R0, t0, R1, t1)
    np.testing.assert_allclose(F, jelev._fundamental(K, R0, t0, R1, t1), rtol=1e-9, atol=1e-12)
    xy0, xy1, _ = match((0.0, 0.0), (10.0, 0.0))
    np.testing.assert_allclose(telev.epipolar_error(F, xy0, xy1),
                               jelev.epipolar_error(F, xy0, xy1), rtol=1e-9, atol=1e-9)


def test_elevation_estimator_fallback_no_matches():
    class Views:
        def generate(self, crop, de, da, seed=0):
            return None

    def no_match(v0, v1):
        z = np.zeros((4, 2), np.float32)
        return z, z, np.zeros(4, bool)

    assert telev.MatchingElevationEstimator(Views(), no_match, np.eye(3)).estimate(
        np.zeros((8, 8, 4))) == 0.0


def test_trellis_preprocess_with_segmenter_matches_jax():
    jp = jtrellis.TrellisPipeline(jtrellis.TrellisPipelineConfig.tiny_test())
    tp = ttrellis.TrellisPipeline(ttrellis.TrellisPipelineConfig.tiny_test(), device="cpu")
    rgb = np.random.default_rng(3).integers(0, 256, (40, 52, 3)).astype(np.uint8)
    want = np.asarray(jp.preprocess(rgb, segmenter=_HalfSegmenter()))
    got = tp.preprocess(rgb, segmenter=_HalfSegmenter()).numpy()
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1 / 255 + 1e-6)
    # The segmenter's box (the left half) is what was kept: without it the
    # whole image is taken.
    whole = tp.preprocess(rgb).numpy()
    assert np.abs(whole - got).max() > 0.1
    np.testing.assert_allclose(whole, np.asarray(jp.preprocess(rgb)), atol=1 / 255 + 1e-6)
