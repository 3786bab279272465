"""Orbit cameras in OpenCV convention for the registration renderer.

A copy of `labelany3d_tpu/registration/cameras.py` (numpy only).

The reference renders with PyTorch3D's screen convention and fixed
intrinsics fx=fy=560.44, c=(256,256) at 512^2, distance 1.5
(`src/matching/renderer.py:34-39,96`), then un-flips coordinates in the
matcher (`matcher.py:79-84`). Here cameras are OpenCV (x right, y down,
z forward) end to end, so no flips exist anywhere downstream.
"""

from __future__ import annotations

import numpy as np

RENDER_SIZE = 512
RENDER_K = np.array(
    [[560.44, 0.0, 256.0], [0.0, 560.44, 256.0], [0.0, 0.0, 1.0]], np.float32
)
RENDER_DISTANCE = 1.5


def opencv_orbit_pose(
    elevation_deg: float, azimuth_deg: float, radius: float = RENDER_DISTANCE,
    target=None,
) -> tuple[np.ndarray, np.ndarray]:
    """World->camera (R, t) for an orbit viewpoint, OpenCV convention.

    Camera position follows the reference's orbit parameterization
    (`src/cam_utils.py:35-52`): elevation from +y toward -y, azimuth from
    +z toward +x. Returns R (3, 3), t (3,) with X_cam = R @ X_world + t.
    """
    elev = np.deg2rad(elevation_deg)
    azim = np.deg2rad(azimuth_deg)
    campos = np.array(
        [
            radius * np.cos(elev) * np.sin(azim),
            -radius * np.sin(elev),
            radius * np.cos(elev) * np.cos(azim),
        ]
    )
    if target is None:
        target = np.zeros(3)
    campos = campos + target

    z = target - campos
    z = z / np.linalg.norm(z)
    world_down = np.array([0.0, -1.0, 0.0])
    x = np.cross(world_down, z)
    n = np.linalg.norm(x)
    if n < 1e-8:  # looking straight up/down: pick a stable right axis
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / n
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)  # rows = camera axes in world coords
    t = -R @ campos
    return R.astype(np.float32), t.astype(np.float32)
