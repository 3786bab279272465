"""Overlay visualization: project 3D boxes onto the input image.

A copy of `labelany3d_tpu/utils/visualization.py` that skips boxes with a
corner at or behind the camera plane (the JAX version raises there); parity target
`src/util.py:232-289` (`draw_cube`) — green corner dots,
blue box edges, red category label at the topmost corner, written as
`vis_3dbox.png`.
"""

from __future__ import annotations

import json
import os

import numpy as np

_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_cube_overlay(scene, is_ground: bool = False, image: np.ndarray | None = None,
                      K: np.ndarray | None = None, cubes: list | None = None) -> str:
    """Render `vis_3dbox.png` for a SceneDir; returns the output path.

    `image`/`K`/`cubes` may be passed directly (RGB uint8 array, 3x3, parsed
    bbox list) to skip the artifact re-reads when the caller already holds
    them in memory (the fused fast stage)."""
    import cv2

    if K is None:
        cam = json.loads((scene.root / "cam_params.json").read_text())
        K = np.asarray(cam["K"], np.float64)
    K = np.asarray(K, np.float64)
    if cubes is None:
        bbox_file = scene.bbox3d_ground if is_ground else scene.bbox3d
        cubes = json.loads(bbox_file.read_text())
    if image is None:
        from PIL import Image

        with Image.open(scene.input_image) as im:
            image = np.asarray(im.convert("RGB"))
    image = cv2.cvtColor(np.ascontiguousarray(image), cv2.COLOR_RGB2BGR)
    for cube in cubes:
        verts = np.asarray(cube["bbox3D_cam"], np.float64)
        uvw = verts @ K.T
        if not (uvw[:, 2] > 1e-6).all():
            continue  # a corner at or behind the camera plane has no image point
        pts = uvw[:, :2] / uvw[:, 2:3]
        if np.abs(pts).max() > 1e6:
            continue  # too far outside the image for OpenCV's integer coordinates
        top = pts[np.argmin(pts[:, 1])]
        for p in pts:
            cv2.circle(image, tuple(np.round(p).astype(int)), 3, (0, 255, 0), -1)
        for a, b in _EDGES:
            cv2.line(
                image,
                tuple(np.round(pts[a]).astype(int)),
                tuple(np.round(pts[b]).astype(int)),
                (255, 0, 0), 2,
            )
        cv2.putText(
            image, str(cube.get("category_name", "")),
            (int(top[0]), int(top[1]) - 10),
            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 255), 1,
        )
    name = "vis_3dbox.png" if not is_ground else "vis_3dbox.png"
    out = os.path.join(str(scene.root), name)
    cv2.imwrite(out, image, [cv2.IMWRITE_PNG_COMPRESSION, 1])
    return out
