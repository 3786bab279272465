"""Helpers for the port's parity tests: reproduce the JAX package's random
draws from a key, so the PyTorch functions can be fed the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from labelany3d_tpu_torch.geometry.align import RansacDraws


def interpret_yaw_minarea(monkeypatch) -> None:
    """Run the JAX package's Pallas yaw kernel in interpret mode (the CPU has
    no TPU), as its own tests do."""
    import labelany3d_tpu.ops.boxfit_pallas as jbp

    orig = jbp.yaw_minarea_pallas
    monkeypatch.setattr(jbp, "yaw_minarea_pallas",
                        lambda p, v, num_angles=512, interpret=False:
                        orig(p, v, num_angles=num_angles, interpret=True))


def jax_ransac_draws(key, batch: int, n: int, num_trials=64, samples_per_trial=64,
                     max_points=16384) -> RansacDraws:
    """Draws of `labelany3d_tpu.pipeline.labeling.depth_fusion(..., key)`."""
    subs, trials = [], []
    for k in jax.random.split(key, batch):
        k_sub, k_trials = jax.random.split(k)
        subs.append(np.asarray(jax.random.randint(k_sub, (max_points,), 0, n)))
        trials.append(np.asarray(jax.random.randint(
            k_trials, (num_trials, samples_per_trial), 0, max_points)))
    return RansacDraws(torch.from_numpy(np.stack(subs)).long(),
                       torch.from_numpy(np.stack(trials)).long())


def jax_sample_draws(key, eff_masks: np.ndarray, num_samples: int) -> torch.Tensor:
    """Draws of `label_instances(..., key)` for (B, I, H, W) effective masks."""
    out = []
    for k, m in zip(jax.random.split(key, eff_masks.shape[0]), eff_masks):
        n_valid = jnp.asarray(m.reshape(m.shape[0], -1).sum(-1), jnp.int32)
        out.append(np.asarray(jax.random.randint(
            k, (m.shape[0], num_samples), 0, jnp.maximum(n_valid, 1)[:, None])))
    return torch.from_numpy(np.stack(out)).long()


def jax_box_stage_draws(seed: int, batches: list[np.ndarray], num_samples: int) -> list:
    """Draws of the JAX `BoxStage` (key `seed + 7`, split once per batch it
    labels), one (B, I, S) tensor per batch; `batches` holds each batch's
    (B, I, H, W) effective masks (instance masks where the depth is valid)."""
    key = jax.random.PRNGKey(seed + 7)
    out = []
    for eff in batches:
        key, sub = jax.random.split(key)
        out.append(jax_sample_draws(sub, eff, num_samples))
    return out


def depth_ok(depth: np.ndarray, max_depth_valid=9000.0) -> np.ndarray:
    return (depth > 0) & (depth < max_depth_valid) & np.isfinite(depth)


def jax_pnp_draws(key, n_objects: int, num_trials: int = 256, sample_size: int = 6):
    """Draws of `labelany3d_tpu.registration.process.register_objects(...,
    key)`: stage 0 (render intrinsics) takes `split(k1, n)[obj]`, stage 1
    (image intrinsics) `split(k2, n)[obj]`. Returns the port's
    `draws(stage, obj, n_valid)` callable."""
    k1, k2 = jax.random.split(key)
    keys = (jax.random.split(k1, n_objects), jax.random.split(k2, n_objects))

    def draws(stage, obj, n_valid):
        return torch.from_numpy(np.array(jax.random.randint(
            keys[stage][obj], (num_trials, sample_size), 0, max(int(n_valid), 1)))).long()

    return draws


def jax_layout_draws(seed: int, objects_per_image: list[int]):
    """Draws of the JAX `LayoutStage` (seed `cfg.seed`), which splits one key
    per image it registers, in order; image i registers
    `objects_per_image[i]` objects. Returns the port stage's
    `draws(image_index, stage, obj, n_valid)` callable."""
    key = jax.random.PRNGKey(seed + 21)
    per_image = []
    for n in objects_per_image:
        key, sub = jax.random.split(key)
        per_image.append(jax_pnp_draws(sub, n))
    return lambda i, stage, obj, n_valid: per_image[i](stage, obj, n_valid)


class OracleMatcher:
    """Geometry-derived correspondences, as the JAX registration test's
    `OracleMatcher`, for a renderer with intrinsics `K_render`: unproject the
    render's depth, place by the ground truth, project into the scene, and
    express the reference side in crop pixels."""

    def __init__(self, K_img, T_gt, image_hw, crop_params, K_render, num=256):
        self.K_img, self.T, self.hw = np.asarray(K_img, np.float64), T_gt, image_hw
        self.crop, self.Kinv, self.num = crop_params, np.linalg.inv(K_render), num

    def match(self, ref_rgba, view):
        ys, xs = np.nonzero(view.depth > 0)
        if len(ys) == 0:
            z = np.zeros((self.num, 2), np.float32)
            return z, z, np.zeros(self.num, bool)
        sel = np.linspace(0, len(ys) - 1, self.num).astype(int)
        yv, xv = ys[sel], xs[sel]
        d = view.depth[yv, xv].astype(np.float64)
        obj = (np.stack([xv * d, yv * d, d], -1) @ self.Kinv.T - view.t) @ view.R
        cam = obj @ self.T[:3, :3].T + self.T[:3, 3]
        uv = cam @ self.K_img.T
        uv = uv[:, :2] / uv[:, 2:3]
        valid = ((cam[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < self.hw[1])
                 & (uv[:, 1] >= 0) & (uv[:, 1] < self.hw[0]))
        ox, oy, sc = self.crop
        return (((uv - [[ox, oy]]) * sc).astype(np.float32), np.stack([xv, yv], -1).astype(
            np.float32), valid)


class PairsMatcher:
    """Pair p asks the oracle of its reference, `ref_index[p]`."""

    def __init__(self, oracles):
        self.oracles = oracles

    def match_pairs(self, refs, views, ref_index):
        return [self.oracles[r].match(refs[r], views[p]) for p, r in enumerate(ref_index)]


def flax_param_shapes(init, *args) -> dict:
    """The shapes of the Flax parameter tree `init(key, *args)` gives, from
    `jax.eval_shape` (no init runs)."""
    return jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]


def fill_flax_params(shapes, seed: int = 0) -> dict:
    """A Flax parameter tree of `shapes`, filled from a numpy generator:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), LayerScale gammas
    0.5 + N(0, 0.1^2), every other leaf N(0, 0.1^2). Numpy arrays; both
    packages take them as they are."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", "")
        z = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if leaf == "scale":
            return 1.0 + 0.1 * z
        if leaf == "gamma":
            return 0.5 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def random_flax_params(init, *args, seed: int = 0) -> dict:
    """A Flax parameter tree of the shapes `init(key, *args)` gives, filled
    as `fill_flax_params` does, instead of running the (slow, unjitted)
    init."""
    return fill_flax_params(flax_param_shapes(init, *args), seed)
