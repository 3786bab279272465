"""`utils/trajectory.py` against the JAX package on the CPU.

The host helpers (`adaptive_thickness`, `bbox_json_to_mesh`, `_raycast`,
`_look_at_rotation`, `_slerp`, `_smoothstep`) run the same numpy code, so
their outputs must be equal to 1e-6. `render_trajectory_video` renders a
scene of the textured cube and two boxes at `frames_per_segment=2`,
`image_size=96` (6 frames) in both packages; the decoded mp4 frames must
agree within a mean absolute difference of 2 levels of 255 (the two
rasterizers agree but for edge pixels, and mp4v is lossy; 0.155 was read),
and the frames must have content.
"""

import json

import numpy as np
import pytest
import torch

from labelany3d_tpu.pipeline.scene import SceneDir as JSceneDir
from labelany3d_tpu.utils import trajectory as jtraj
from labelany3d_tpu_torch.data import meshio
from labelany3d_tpu_torch.pipeline.scene import SceneDir
from labelany3d_tpu_torch.utils import trajectory
from tests.test_registration_pipeline import _textured_cube

torch.set_num_threads(1)

TOL = 1e-6
FRAME_MEAN_TOL = 2.0


def _box(center, dims, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    unit = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]]) * 0.5
    return {"bbox3D_cam": ((unit * dims) @ R.T + center).tolist(), "category_name": "box"}


BOXES = [_box([0.0, 0.0, 3.0], [1.0, 1.0, 1.0], 0.3), _box([0.8, 0.2, 4.0], [0.6, 0.4, 0.9], -0.5)]


def test_host_helpers_match_jax():
    assert trajectory.adaptive_thickness(BOXES) == pytest.approx(jtraj.adaptive_thickness(BOXES),
                                                                 abs=TOL)
    assert trajectory.adaptive_thickness([]) == jtraj.adaptive_thickness([]) == 0.01
    got, want = trajectory.bbox_json_to_mesh(BOXES), jtraj.bbox_json_to_mesh(BOXES)
    assert len(got.faces) == 2 * 12 * 12
    for a in ("vertices", "faces", "colors"):
        np.testing.assert_allclose(getattr(got, a), getattr(want, a), atol=TOL, err_msg=a)
    assert trajectory.bbox_json_to_mesh([]).is_empty
    cube = _textured_cube()
    cube.vertices = cube.vertices + np.float32([0, 0, 3])
    tcube = meshio.Mesh(cube.vertices.copy(), cube.faces.copy(), cube.colors.copy())
    for direction in ([0.0, 0.0, 1.0], [0.1, -0.05, 1.0], [1.0, 0.0, 0.0]):
        d = np.asarray(direction) / np.linalg.norm(direction)
        g, w = trajectory._raycast(np.zeros(3), d, tcube), jtraj._raycast(np.zeros(3), d, cube)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, w, atol=TOL)
            assert g[2] == pytest.approx(2.5, abs=0.05 + abs(d[0]) + abs(d[1]))
    pos, tgt, up = np.array([0.3, -0.2, 0.1]), np.array([0.0, 0.1, 3.0]), np.array([0, -1.0, 0])
    R0 = trajectory._look_at_rotation(pos, tgt, up)
    np.testing.assert_allclose(R0, jtraj._look_at_rotation(pos, tgt, up), atol=TOL)
    np.testing.assert_allclose(R0.T @ R0, np.eye(3), atol=1e-9)
    R1 = trajectory._look_at_rotation(-pos, tgt, up)
    for s in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(trajectory._slerp(R0, R1, s), jtraj._slerp(R0, R1, s),
                                   atol=TOL)
        assert trajectory._smoothstep(s) == jtraj._smoothstep(s)
    np.testing.assert_allclose(trajectory._slerp(R0, R1, 1.0), R1, atol=1e-9)


def _scene(root, pkg_scene):
    sd = pkg_scene(root)
    (sd.root / "reconstruction").mkdir(parents=True, exist_ok=True)
    cube = _textured_cube()
    mesh = meshio.Mesh(cube.vertices + np.float32([0, 0, 3]), cube.faces, cube.colors)
    meshio.save_glb(sd.root / "reconstruction" / "full_scene.glb", mesh)
    sd.bbox3d.write_text(json.dumps(BOXES))
    K = [[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]]
    (sd.root / "cam_params.json").write_text(json.dumps(
        {"K": K, "c2w": np.eye(4).tolist(), "W": 128, "H": 96}))
    return sd


def _frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


def test_render_trajectory_video_matches_jax(tmp_path):
    kw = dict(frames_per_segment=2, image_size=96)
    want_path = jtraj.render_trajectory_video(_scene(tmp_path / "j", JSceneDir),
                                              str(tmp_path / "j.mp4"), **kw)
    got_path = trajectory.render_trajectory_video(_scene(tmp_path / "t", SceneDir),
                                                  str(tmp_path / "t.mp4"), device="cpu", **kw)
    got, want = _frames(got_path), _frames(want_path)
    assert got.shape == want.shape == (6, 72, 96, 3)
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32)).mean()
    print(f"mean abs frame difference {diff:.4f} levels")
    assert diff <= FRAME_MEAN_TOL
    assert all(f.std() > 5.0 for f in got)  # each frame holds the cube and the boxes
