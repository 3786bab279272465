"""Object-to-scene registration (process_image_space equivalent), batched
over all of an image's objects.

Counterpart of `labelany3d_tpu/registration/process.py`:

  1. render 8 orbit views of each generated mesh at its elevation;
  2. match every reference crop against its views in one matcher call, and
     lift the render-side matches to object space through the render depth;
  3. RANSAC PnP under the render intrinsics for every object at once;
  4. re-render the survivors at their poses, re-match in one call, map crop
     pixels to image pixels, and solve PnP again under the image intrinsics;
  5. render each object at its final pose over the full image, and take the
     scale as median(scene depth / render depth) on the mask overlap;
  6. transform = s * [R | t] (OpenCV column convention end to end).

RANSAC draws come from `draws(stage, object_index, n_valid)` when given
(parity tests reproduce the JAX package's keys), else from `generator`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import Mesh
from labelany3d_tpu_torch.geometry.align import median_ratio_scale
from labelany3d_tpu_torch.geometry.pnp import draw_pnp_samples, solve_pnp_ransac
from labelany3d_tpu_torch.registration.renderer import OrbitRenderer, RenderedView

_TRIALS, _SAMPLE = 256, 6


class MatcherBackend(Protocol):
    """2D-2D correspondences between a reference crop and one render:
    (xy_ref (S, 2), xy_view (S, 2), valid (S,)) in pixels. Backends may also
    offer `match_batch(ref, views)` and `match_pairs(refs, views, ref_index)`,
    which serve many pairs in one model forward."""

    def match(self, ref_rgba: np.ndarray, view: RenderedView): ...


@dataclass
class RegistrationResult:
    rotation: np.ndarray        # (3, 3) object->camera
    translation: np.ndarray     # (3,)
    scale: float
    transform: np.ndarray       # (4, 4) = s * [R | t]
    render_depth: np.ndarray    # full-image render depth at the final pose
    render_mask: np.ndarray     # full-image coverage
    num_inliers: int
    error: float
    ok: bool


@dataclass
class ObjectToRegister:
    """Per-object inputs for the whole-image registration batch."""

    mesh: Mesh
    ref_crop_rgba: np.ndarray
    elevation_deg: float
    crop_params: tuple[float, float, float]   # (offset_x, offset_y, scale)
    scene_mask: np.ndarray                    # full-image instance mask


def _lift_matches_to_object(view: RenderedView, xy_view: np.ndarray, valid: np.ndarray,
                            K: np.ndarray):
    """Render-pixel matches -> object-space points through the render depth."""
    h, w = view.depth.shape
    xi = np.clip(np.round(xy_view[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(xy_view[:, 1]).astype(int), 0, h - 1)
    d = view.depth[yi, xi]
    valid = valid & (d > 0)
    pix = np.stack([xy_view[:, 0] * d, xy_view[:, 1] * d, d], axis=-1)
    cam = pix @ np.linalg.inv(K).T
    world = (cam - view.t) @ view.R  # R^T (cam - t), row-vectorised
    return world.astype(np.float32), valid


def _failed(image_hw) -> RegistrationResult:
    return RegistrationResult(
        rotation=np.eye(3), translation=np.zeros(3), scale=1.0, transform=np.eye(4),
        render_depth=np.full(image_hw, -1.0), render_mask=np.zeros(image_hw, bool),
        num_inliers=0, error=float("inf"), ok=False)


def _pad_stack(obj_pts, img_pts, valids):
    """Stack per-object correspondence sets, padding to the largest count
    with invalid rows (production matchers return equal counts)."""
    m = max(a.shape[0] for a in obj_pts)

    def pad(a, fill=0.0):
        if a.shape[0] == m:
            return a
        return np.pad(a, ((0, m - a.shape[0]),) + ((0, 0),) * (a.ndim - 1),
                      constant_values=fill)

    return (np.stack([pad(a) for a in obj_pts]), np.stack([pad(a) for a in img_pts]),
            np.stack([pad(v, False) for v in valids]))


def _match_pairs(matcher: MatcherBackend, refs, views, ref_index):
    """The matcher's widest capability: all pairs in one call (`match_pairs`),
    one call per reference (`match_batch`), or one per pair (`match`)."""
    if hasattr(matcher, "match_pairs"):
        return matcher.match_pairs(refs, views, ref_index)
    out = [None] * len(views)
    if hasattr(matcher, "match_batch"):
        by_ref: dict[int, list[int]] = {}
        for p, r in enumerate(ref_index):
            by_ref.setdefault(r, []).append(p)
        for r, ps in by_ref.items():
            for p, m in zip(ps, matcher.match_batch(refs[r], [views[p] for p in ps])):
                out[p] = m
        return out
    return [matcher.match(refs[r], views[p]) for p, r in enumerate(ref_index)]


DrawFn = Callable[[int, int, int], torch.Tensor]


def _pnp(obj, img, K, valid, objects_idx, stage, draws: DrawFn | None, generator, device,
         reproj_threshold):
    """Batched RANSAC PnP on `device`; results back as numpy."""
    obj_t = torch.as_tensor(obj, device=device)
    img_t = torch.as_tensor(img, device=device)
    valid_t = torch.as_tensor(valid, device=device)
    n_valid = valid_t.sum(-1)
    if draws is None:
        d = draw_pnp_samples(n_valid, _TRIALS, _SAMPLE, generator)
    else:
        counts = n_valid.tolist()
        d = torch.stack([torch.as_tensor(draws(stage, i, int(c)), device=device)
                         for i, c in zip(objects_idx, counts)]).long()
    res = solve_pnp_ransac(obj_t, img_t, torch.as_tensor(np.asarray(K, np.float32),
                                                         device=device),
                           valid_t, d, reproj_threshold=reproj_threshold)
    return type(res)(*(t.cpu().numpy() for t in res))


@torch.inference_mode()
def register_objects(objects: list[ObjectToRegister], K_img: np.ndarray, image_hw,
                     scene_depth: np.ndarray, matcher: MatcherBackend, *,
                     renderer: OrbitRenderer | None = None, reproj_threshold: float = 20.0,
                     draws: DrawFn | None = None,
                     generator: torch.Generator | None = None) -> list[RegistrationResult]:
    """Register all of an image's meshes in one batched pass; PnP and the
    scale run on the renderer's device."""
    n = len(objects)
    if n == 0:
        return []
    renderer = renderer or OrbitRenderer()
    dev = renderer.device
    image_hw = tuple(image_hw)
    azimuths = list(range(0, 360, 45))

    # Stage A: 8 orbit views per object at its elevation, one matcher call.
    views_flat, ref_index = [], []
    for i, ob in enumerate(objects):
        views_flat.extend(renderer.render_orbit_views(ob.mesh, [-ob.elevation_deg] * 8,
                                                      azimuths))
        ref_index.extend([i] * 8)
    refs = [ob.ref_crop_rgba for ob in objects]
    matches = _match_pairs(matcher, refs, views_flat, ref_index)

    obj_all, img_all, valid_all = [], [], []
    for i in range(n):
        o_pts, i_pts, vs = [], [], []
        for p in range(i * 8, i * 8 + 8):
            xy_ref, xy_view, valid = matches[p]
            world, valid = _lift_matches_to_object(views_flat[p], xy_view, valid, renderer.K)
            o_pts.append(world)
            i_pts.append(np.asarray(xy_ref, np.float32))
            vs.append(valid)
        obj_all.append(np.concatenate(o_pts))
        img_all.append(np.concatenate(i_pts))
        valid_all.append(np.concatenate(vs))
    o_s, i_s, v_s = _pad_stack(obj_all, img_all, valid_all)
    res1 = _pnp(o_s, i_s, renderer.K, v_s, list(range(n)), 0, draws, generator, dev,
                reproj_threshold)

    # Stage B: re-render the survivors at their poses, re-match, solve
    # against the full-image intrinsics.
    alive = [i for i in range(n) if bool(res1.ok[i])]
    results: list[RegistrationResult | None] = [
        None if i in alive else _failed(image_hw) for i in range(n)]
    if not alive:
        return results  # type: ignore[return-value]
    views1 = {i: renderer.render_pose(objects[i].mesh, res1.rotation[i], res1.translation[i])
              for i in alive}
    matches_b = _match_pairs(matcher, refs, [views1[i] for i in alive], list(alive))
    world_b, img_b, valid_b = [], [], []
    for j, i in enumerate(alive):
        xy_ref, xy_view, valid = matches_b[j]
        world, valid = _lift_matches_to_object(views1[i], xy_view, valid, renderer.K)
        ox, oy, scale_crop = objects[i].crop_params
        world_b.append(world)
        img_b.append((np.asarray(xy_ref) / scale_crop + np.array([[ox, oy]])).astype(np.float32))
        valid_b.append(valid)
    w_s, i_s, v_s = _pad_stack(world_b, img_b, valid_b)
    res2 = _pnp(w_s, i_s, K_img, v_s, alive, 1, draws, generator, dev, reproj_threshold)

    # Stage C: full-image render per object, then one batched median-ratio
    # scale.
    finals, poses = [], []
    for j, i in enumerate(alive):
        if bool(res2.ok[j]):
            R, t = res2.rotation[j], res2.translation[j]
            K_final = np.asarray(K_img, np.float32)
            inl, err = int(res2.inliers[j].sum()), float(res2.error[j])
        else:  # the stage-A pose under the render intrinsics
            R, t = res1.rotation[i], res1.translation[i]
            K_final = renderer.K
            inl, err = int(res1.inliers[i].sum()), float(res1.error[i])
        finals.append(renderer.render_pose(objects[i].mesh, R, t, image_size=image_hw,
                                           K=K_final))
        poses.append((R, t, inl, err))
    render_depths = torch.as_tensor(np.stack([f.depth for f in finals]), device=dev)
    overlaps = torch.as_tensor(np.stack([objects[i].scene_mask & (finals[j].depth > 0)
                                         for j, i in enumerate(alive)]), device=dev)
    s_all, has_all = median_ratio_scale(torch.as_tensor(scene_depth, device=dev),
                                        render_depths, overlaps)
    s_all, has_all = s_all.cpu().numpy(), has_all.cpu().numpy()

    for j, i in enumerate(alive):
        R, t, inl, err = poses[j]
        scale = float(s_all[j]) if bool(has_all[j]) else 1.0
        transform = np.eye(4)
        if bool(has_all[j]):
            transform[:3, :3] = R * scale
            transform[:3, 3] = t * scale
        results[i] = RegistrationResult(
            rotation=R, translation=t, scale=scale, transform=transform,
            render_depth=finals[j].depth, render_mask=finals[j].depth > 0,
            num_inliers=inl, error=err, ok=True)
    return results  # type: ignore[return-value]


def register_object(mesh: Mesh, ref_crop_rgba: np.ndarray, elevation_deg: float,
                    crop_params: tuple[float, float, float], K_img: np.ndarray, image_hw,
                    scene_depth: np.ndarray, scene_mask: np.ndarray,
                    matcher: MatcherBackend, *, renderer: OrbitRenderer | None = None,
                    reproj_threshold: float = 20.0, draws: DrawFn | None = None,
                    generator: torch.Generator | None = None) -> RegistrationResult:
    """Register one generated mesh into the scene (the batch of one)."""
    return register_objects(
        [ObjectToRegister(mesh, ref_crop_rgba, elevation_deg, crop_params, scene_mask)],
        K_img, image_hw, scene_depth, matcher, renderer=renderer,
        reproj_threshold=reproj_threshold, draws=draws, generator=generator)[0]


def align_to_depth_match(mesh: Mesh, mask: np.ndarray, depth_map: np.ndarray,
                         ref_crop_rgba: np.ndarray, elevation_deg: float, crop_params,
                         K_img: np.ndarray, matcher: MatcherBackend, *,
                         renderer: OrbitRenderer | None = None, draws: DrawFn | None = None,
                         generator: torch.Generator | None = None) -> np.ndarray:
    """The reference's `align_to_depth_match`: the 4x4 scene-placement
    transform, the identity when registration fails."""
    res = register_object(mesh, ref_crop_rgba, elevation_deg, crop_params, K_img,
                          depth_map.shape, depth_map, mask, matcher, renderer=renderer,
                          draws=draws, generator=generator)
    return res.transform if res.ok else np.eye(4)
