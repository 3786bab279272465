"""Camera-elevation estimation from novel views (stage 5's `zero123`).

Counterpart of `labelany3d_tpu/models/elevation.py`: Zero123 renders 4
nearby views (d_elev +-10, d_azim +-10 degrees), a matcher pairs them, and
the input camera's elevation is the candidate of a fixed grid whose orbit
geometry gives the smallest median symmetric epipolar error over the
matched pairs (the relative poses of the 4 views are known in closed form
for each candidate, so each pair's fundamental matrix is determined).
Host-side numpy in float64, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from labelany3d_tpu_torch.registration.cameras import opencv_orbit_pose

# The 4 view deltas (d_elev, d_azim) of the reference.
VIEW_DELTAS = [(-10.0, 0.0), (10.0, 0.0), (0.0, -10.0), (0.0, 10.0)]
_PAIRS = [(0, 1), (2, 3), (0, 2), (1, 3)]


def _fundamental(K: np.ndarray, R0, t0, R1, t1) -> np.ndarray:
    """F mapping view-0 pixels to view-1 epipolar lines."""
    R = R1 @ R0.T
    t = t1 - R @ t0
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(K)
    return Kinv.T @ tx @ R @ Kinv


def epipolar_error(F: np.ndarray, xy0: np.ndarray, xy1: np.ndarray) -> np.ndarray:
    """Symmetric epipolar distance of each correspondence."""
    ones = np.ones((len(xy0), 1))
    p0 = np.concatenate([xy0, ones], axis=1)
    p1 = np.concatenate([xy1, ones], axis=1)
    l1 = p0 @ F.T  # lines in image 1
    l0 = p1 @ F
    num = np.abs(np.sum(p1 * l1, axis=1))
    d1 = num / np.maximum(np.hypot(l1[:, 0], l1[:, 1]), 1e-9)
    d0 = num / np.maximum(np.hypot(l0[:, 0], l0[:, 1]), 1e-9)
    return 0.5 * (d0 + d1)


class MatchingElevationEstimator:
    """Stage-5 backend: novel views + matching -> elevation (degrees).

    `novel_views.generate(crop, d_elev, d_azim, seed=i)` gives view i;
    `pair_matcher(img0, img1) -> (xy0, xy1, valid)` matches two views."""

    def __init__(self, novel_views, pair_matcher, K: np.ndarray,
                 candidates=np.arange(-80.0, 81.0, 2.0), radius: float = 1.5):
        self.novel_views = novel_views
        self.pair_matcher = pair_matcher
        self.K = np.asarray(K, np.float64)
        self.candidates = np.asarray(candidates, np.float64)
        self.radius = radius

    def estimate(self, crop_rgba: np.ndarray) -> float:
        views = [self.novel_views.generate(crop_rgba, de, da, seed=i)
                 for i, (de, da) in enumerate(VIEW_DELTAS)]
        matches = []
        for i, j in _PAIRS:
            xy0, xy1, valid = self.pair_matcher(views[i], views[j])
            if valid.sum() >= 8:
                matches.append((i, j, xy0[valid], xy1[valid]))
        if not matches:
            return 0.0  # the reference's fallback

        best_err, best_elev = np.inf, 0.0
        for elev in self.candidates:
            errs = []
            for i, j, xy0, xy1 in matches:
                de_i, da_i = VIEW_DELTAS[i]
                de_j, da_j = VIEW_DELTAS[j]
                R0, t0 = opencv_orbit_pose(elev + de_i, da_i, self.radius)
                R1, t1 = opencv_orbit_pose(elev + de_j, da_j, self.radius)
                F = _fundamental(self.K, R0, t0, R1, t1)
                errs.append(np.median(epipolar_error(F, xy0, xy1)))
            err = float(np.mean(errs))
            if err < best_err:
                best_err, best_elev = err, float(elev)
        return best_elev
