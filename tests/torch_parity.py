"""Helpers for the port's parity tests: reproduce the JAX package's random
draws from a key, so the PyTorch functions can be fed the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from labelany3d_tpu_torch.geometry.align import RansacDraws


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


def depth_ok(depth: np.ndarray, max_depth_valid=9000.0) -> np.ndarray:
    return (depth > 0) & (depth < max_depth_valid) & np.isfinite(depth)
