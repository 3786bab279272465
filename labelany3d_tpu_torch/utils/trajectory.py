"""Trajectory video of a labeled scene (bpy_render equivalent).

Counterpart of `labelany3d_tpu/utils/trajectory.py`. The reference
(`src/bpy_render/bpy_load_blender_pointmap_plot.py:158-615`) animates a
Blender camera around the emission-shaded scene mesh with thick-edge 3D
boxes and exports an H.264 mp4. Here the port's orbit renderer
(`registration/renderer.py`, the tiled rasterizer on the card unless
`device="cpu"`) draws each frame and cv2's `VideoWriter` writes an mp4:

  * `bbox_json_to_mesh`: one prism per box edge in the reference's 9-colour
    palette, thickness median(mean box dims) * 0.04, depth-tested against
    the scene;
  * flat vertex-colour shading (the rasterizer is unlit);
  * intrinsics from `cam_params.json`'s K/W/H, pose from its c2w;
  * the look-at target ray-cast from the camera (Moller-Trumbore,
    `_raycast`), the boxes' mean depth when the ray misses;
  * the 4-keyframe path [original, left-up, right-up, original], offsets
    0.8 x the largest box dimension in the original camera's axes, 30
    frames a segment with smoothstep easing and slerped orientation.
"""

from __future__ import annotations

import json

import numpy as np

from labelany3d_tpu_torch.data.meshio import Mesh, load_glb
from labelany3d_tpu_torch.registration.renderer import OrbitRenderer

_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]

# Reference color palette (bpy_load_blender_pointmap_plot.py:65-69).
_PALETTE = np.array([
    [255, 0, 0], [0, 255, 0], [0, 0, 255],
    [255, 255, 0], [255, 0, 255], [0, 255, 255],
    [255, 127, 0], [127, 0, 255], [0, 127, 255],
], np.float32) / 255.0

# Unit box triangulation for edge prisms.
_BOX_V = np.array([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
], np.float32) * 0.5
_BOX_F = np.array([
    [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
    [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
    [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
], np.int32)


def _thick_line(start: np.ndarray, end: np.ndarray, thickness: float) -> tuple:
    """Cuboid between two 3D points (`create_thick_line` :21-44)."""
    direction = end - start
    length = float(np.linalg.norm(direction))
    if length == 0:
        return None
    z = direction / length
    up = np.array([0, 1, 0], np.float64) if abs(z[1]) < 0.99 else np.array([1, 0, 0], np.float64)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=1)
    v = _BOX_V * np.array([thickness, thickness, length], np.float32)
    v = v + np.array([0, 0, length / 2], np.float32)
    v = v @ rot.T.astype(np.float32) + start.astype(np.float32)
    return v, _BOX_F.copy()


def adaptive_thickness(boxes: list[dict], ratio: float = 0.04) -> float:
    """median(mean(w, h, d)) * ratio (`compute_adaptive_thickness` :47-56)."""
    sizes = []
    for box in boxes:
        bbox = np.asarray(box["bbox3D_cam"], np.float32)
        w = np.linalg.norm(bbox[1] - bbox[0])
        h = np.linalg.norm(bbox[4] - bbox[0])
        d = np.linalg.norm(bbox[3] - bbox[0])
        sizes.append(np.mean([w, h, d]))
    return float(np.median(sizes) * ratio) if sizes else 0.01


def bbox_json_to_mesh(boxes: list[dict], thickness: float | None = None,
                      ratio: float = 0.04) -> Mesh:
    """Thick-edge box geometry (`convert_bbox_json_to_ply` :58-91): one
    colored prism per box edge, concatenated into one mesh — rendered as
    geometry, so edges are depth-tested against the scene."""
    if not boxes:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                    colors=np.zeros((0, 3), np.float32))
    if thickness is None:
        thickness = adaptive_thickness(boxes, ratio)
    all_v, all_f, all_c = [], [], []
    count = 0
    for i, box in enumerate(boxes):
        bbox = np.asarray(box["bbox3D_cam"], np.float64)
        color = _PALETTE[i % len(_PALETTE)]
        for a, b in _EDGES:
            bar = _thick_line(bbox[a], bbox[b], thickness)
            if bar is None:
                continue
            v, f = bar
            all_v.append(v)
            all_f.append(f + count)
            all_c.append(np.tile(color, (len(v), 1)))
            count += len(v)
    return Mesh(np.concatenate(all_v).astype(np.float32),
                np.concatenate(all_f).astype(np.int32),
                colors=np.concatenate(all_c).astype(np.float32))


def _raycast(origin: np.ndarray, direction: np.ndarray, mesh: Mesh,
             max_distance: float = 100.0) -> np.ndarray | None:
    """Nearest Moller-Trumbore triangle hit (the bpy `ray_cast` role)."""
    if mesh.is_empty:
        return None
    tri = mesh.vertices[mesh.faces].astype(np.float64)  # (F, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    p = np.cross(direction[None, :], e2)
    det = np.einsum("fc,fc->f", e1, p)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = origin[None, :] - tri[:, 0]
    u = np.einsum("fc,fc->f", s, p) * inv
    q = np.cross(s, e1)
    v = np.einsum("c,fc->f", direction, q) * inv
    t = np.einsum("fc,fc->f", e2, q) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (t < max_distance)
    if not hit.any():
        return None
    tmin = t[hit].min()
    return origin + direction * tmin


def _look_at_rotation(pos: np.ndarray, target: np.ndarray,
                      up_hint: np.ndarray) -> np.ndarray:
    """OpenCV-convention c2w rotation looking from pos to target."""
    z = target - pos
    z = z / (np.linalg.norm(z) + 1e-12)
    x = np.cross(up_hint, z) * -1.0  # right-handed with y-down camera
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def _slerp(R0: np.ndarray, R1: np.ndarray, s: float) -> np.ndarray:
    """Rotation interpolation via the matrix log (small-angle safe)."""
    M = R0.T @ R1
    cos = np.clip((np.trace(M) - 1) / 2, -1.0, 1.0)
    ang = np.arccos(cos)
    if ang < 1e-8:
        return R0
    axis = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    axis = axis / (2 * np.sin(ang))
    a = ang * s
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return R0 @ (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K))


def _smoothstep(t: float) -> float:
    """Ease-in-out (the Bezier AUTO_CLAMPED role, :586-596)."""
    return t * t * (3.0 - 2.0 * t)


def render_trajectory_video(
    scene_dir,
    out_path: str,
    frames_per_segment: int = 30,
    camera_offset_ratio: float = 0.8,
    image_size: int | None = None,
    fps: int = 30,
    *,
    device=None,
) -> str:
    """Render `<scene>/reconstruction/full_scene.glb` + thick-edge boxes to
    an mp4 along the reference's 4-keyframe path.

    Keyframes (:539-556): [original pose, left-up, right-up, original],
    offsets = camera_offset_ratio * max box dimension expressed in the
    original camera's axes; middle keyframes look at the ray-cast target
    (bbox-average-depth fallback), first/last keep the original c2w
    orientation. 3 segments x frames_per_segment frames (90 at defaults,
    the reference's frame_end). `scene_dir` is a `pipeline.scene.SceneDir`;
    frames render on `device` (CUDA unless "cpu").
    """
    import cv2

    mesh = load_glb(scene_dir.root / "reconstruction" / "full_scene.glb")
    boxes = json.loads(scene_dir.bbox3d.read_text()) if scene_dir.bbox3d.exists() else []
    bbox_mesh = bbox_json_to_mesh(boxes)

    cam = json.loads((scene_dir.root / "cam_params.json").read_text()) \
        if (scene_dir.root / "cam_params.json").exists() else {}
    c2w = np.asarray(cam.get("c2w", np.eye(4)), np.float64)
    W = int(cam.get("W", 320))
    H = int(cam.get("H", 320))
    K = np.asarray(cam.get("K", [[1.2 * W, 0, W / 2],
                                 [0, 1.2 * W, H / 2],
                                 [0, 0, 1]]), np.float32)
    if image_size is not None:
        # Optional downscale for quick renders; K rescales with it.
        s = image_size / max(W, H)
        K = K.copy()
        K[:2] *= s
        W, H = max(2, int(W * s)), max(2, int(H * s))
    W -= W % 2
    H -= H % 2

    # Scene + boxes as one depth-tested mesh set.
    if mesh.colors is None and len(mesh.vertices):
        mesh.colors = np.full((len(mesh.vertices), 3), 0.7, np.float32)
    combined = _concat_meshes(mesh, bbox_mesh)

    p0 = c2w[:3, 3]
    R0 = c2w[:3, :3]
    forward = R0[:, 2]  # OpenCV +z forward

    # Ray-cast look-at target (:512-537), bbox-average-depth fallback.
    target = _raycast(p0, forward, mesh)
    if target is None:
        if len(bbox_mesh.vertices):
            avg_z = float(bbox_mesh.vertices[:, 2].mean())
        elif len(mesh.vertices):
            avg_z = float(mesh.vertices[:, 2].mean())
        else:
            avg_z = 1.0
        target = np.array([p0[0], p0[1], avg_z])

    # Offset distance from the (scaled) bbox max dimension (:295-300).
    ref_mesh = bbox_mesh if len(bbox_mesh.vertices) else mesh
    if len(ref_mesh.vertices):
        dims = ref_mesh.vertices.max(axis=0) - ref_mesh.vertices.min(axis=0)
        d = float(dims.max()) * camera_offset_ratio
    else:
        d = 1.0
    x_ax, y_ax = R0[:, 0], R0[:, 1]
    up_hint = -y_ax  # camera up (y points down in OpenCV)
    positions = [
        p0,
        p0 - d * x_ax - 0.75 * d * y_ax,
        p0 + d * x_ax - 0.75 * d * y_ax,
        p0,
    ]
    rotations = [
        R0,
        _look_at_rotation(positions[1], target, up_hint),
        _look_at_rotation(positions[2], target, up_hint),
        R0,
    ]

    # The rasterizer renders a square canvas; the K principal point keeps
    # the image content in the top-left H x W crop.
    renderer = OrbitRenderer(image_size=max(H, W), K=K, device=device)
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(str(out_path), fourcc, fps, (W, H))
    try:
        for seg in range(3):
            for f in range(frames_per_segment):
                s = _smoothstep(f / max(frames_per_segment - 1, 1))
                pos = positions[seg] * (1 - s) + positions[seg + 1] * s
                Rc2w = _slerp(rotations[seg], rotations[seg + 1], s)
                Rw2c = Rc2w.T
                t = -Rw2c @ pos
                view = renderer.render_pose(combined, Rw2c, t)
                frame = (np.clip(view.rgba[..., :3], 0, 1) * 255).astype(np.uint8)
                frame = frame[:H, :W]
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return str(out_path)


def _concat_meshes(a: Mesh, b: Mesh) -> Mesh:
    if a.is_empty:
        return b
    if b.is_empty:
        return a
    ca = a.colors if a.colors is not None else np.full((len(a.vertices), 3), 0.7, np.float32)
    cb = b.colors if b.colors is not None else np.full((len(b.vertices), 3), 0.7, np.float32)
    ca = np.asarray(ca, np.float32)[:, :3]
    cb = np.asarray(cb, np.float32)[:, :3]
    if ca.max(initial=0) > 1.5:
        ca = ca / 255.0
    if cb.max(initial=0) > 1.5:
        cb = cb / 255.0
    return Mesh(
        np.concatenate([a.vertices, b.vertices]).astype(np.float32),
        np.concatenate([a.faces, b.faces + len(a.vertices)]).astype(np.int32),
        colors=np.concatenate([ca, cb]),
    )
