"""Entry points for a compile-and-run check of the flagship model, one card
or several: the analogue of the repository's `__graft_entry__.py`.

  * `entry(device=None)`: (fn, args), the full-width forward of the
    flagship model (MoGe ViT-L/14 with the checkpoint head, 518 x 518,
    batch 1, zero weights);
  * `dryrun_multichip(n, device=None)`: over `n` spawned ranks
    (`launch.run_ranks`; NCCL on CUDA, gloo with `device="cpu"`), the tiny
    dp x tp train step twice (tp 2 where `n` is even), then each rank's
    shard shapes of the production model (ViT-L at 518 px) on the `meta`
    device, and the data split of the labeling step (run on each rank's
    rows), the fused `fast` program and the matcher's 8 orbit pairs at
    production shapes.

The rank functions here (and `train_worker`, `labeling_worker`,
`sp_worker`) are what `run_ranks` sends to the children; they import the
port only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from labelany3d_tpu_torch.utils.device import resolve_device

ENTRY_HW = (518, 518)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "labelany3d_tpu")


def entry(device=None):
    """(fn, (model, images)): the forward `fn(model, images) -> points` of
    `MoGeModel(MoGeConfig.vitl())` at 518 x 518, batch 1, zero weights
    (the check needs the shapes and the kernels, not the values), bf16
    compute, on `device` (None: CUDA)."""
    from labelany3d_tpu_torch.models.moge import MoGeConfig, MoGeModel

    dev = resolve_device(device)
    with torch.device("meta"):
        model = MoGeModel(MoGeConfig.vitl(), ENTRY_HW)
    model = model.to_empty(device=dev).requires_grad_(False).eval()
    for t in (*model.parameters(), *model.buffers()):
        t.zero_()
    images = torch.zeros((1, *ENTRY_HW, 3), device=dev)

    def forward(model, images):
        with torch.inference_mode():
            return model(images)["points"]

    return forward, (model, images)


def tiny_moge_config():
    """The dry run's model: width 64, 2 blocks of 2 heads, 8-px patches,
    the 'tpu' head (`__graft_entry__.dryrun_multichip`'s)."""
    from labelany3d_tpu_torch.models.moge import MoGeConfig
    from labelany3d_tpu_torch.models.vit import ViTConfig

    return MoGeConfig(backbone=ViTConfig(width=64, depth=2, num_heads=2, patch_size=8,
                                         out_indices=(0, 1)),
                      head_width=32, num_upsamples=1)


def factor(n: int) -> tuple[int, int]:
    """(dp, tp) of `n` ranks: a model axis of 2 where `n` is even."""
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    return n // tp, tp


def forbidden_modules() -> list[str]:
    """The JAX-side modules this process has imported (none may be)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def train_worker(rank: int, world: int, cfg, hw, dp: int, tp: int, batch: tuple,
                 steps: int, params=None) -> dict:
    """One rank of a dp x tp run of `MoGeModel(cfg, hw)`: weights from the
    Flax-layout `params` (else Flax's initialisers from seed 0, the same on
    every rank), this rank's rows of `batch` = (images, target, valid),
    `steps` train steps. Returns the mesh coordinate, this rank's rows of
    `points` before training (no grad), the losses, and on rank 0 the full
    parameters after training (numpy)."""
    from labelany3d_tpu_torch.models.moge import MoGeModel
    from labelany3d_tpu_torch.parallel.mesh import make_mesh, mesh_device
    from labelany3d_tpu_torch.parallel.sharding import gather_params
    from labelany3d_tpu_torch.parallel.train import (
        init_train_state,
        make_train_step,
        prepare_batch,
    )

    mesh = make_mesh(dp, tp, device=mesh_device_type())
    dev = mesh_device(mesh)
    with torch.device(dev):
        model = MoGeModel(cfg, hw)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, opt = init_train_state(model, gen, mesh=mesh, params=params)
    images, target, valid = prepare_batch(mesh, *batch)
    out = {"coordinate": mesh.get_coordinate(), "forbidden": forbidden_modules()}
    with torch.no_grad():
        out["points"] = model(images)["points"].cpu().numpy()
    step = make_train_step(model, opt)
    losses = []
    for _ in range(steps):
        state, loss = step(state, images, target, valid)
        losses.append(float(loss))
    out["losses"], out["step"] = losses, state.step
    full = gather_params(mesh, model)
    if rank == 0:
        out["params"] = {k: v.float().cpu().numpy() for k, v in full.items()}
    return out


def mesh_device_type() -> str:
    """The device type of this rank's process group: 'cuda' under NCCL,
    'cpu' under gloo."""
    return "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"


def sp_worker(rank: int, world: int, q, k, v, mode: str):
    """This rank's rows of sequence-parallel attention of the full (S, H,
    D) q, k, v (numpy) over a data axis of `world` ranks."""
    from labelany3d_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from labelany3d_tpu_torch.parallel.sp import make_sp_attention

    mesh = make_mesh(world, 1, device=mesh_device_type())
    ql, kl, vl = shard_batch(mesh, (q, k, v))
    return make_sp_attention(mesh, "data", mode)(ql, kl, vl).cpu().numpy()


def labeling_batch(b: int = 8):
    """A small seeded labeling batch of `b` 64 x 96 images with 4
    instances each (relative, metric, depth_mask, K, masks), numpy, with
    its `LabelingDraws` for the whole batch (RANSAC and sample ranks from a
    seeded torch generator)."""
    h, w, i, seed = 64, 96, 4, 0
    from labelany3d_tpu_torch.geometry.align import draw_ransac
    from labelany3d_tpu_torch.geometry.backproject import draw_instance_ranks
    from labelany3d_tpu_torch.pipeline.labeling import LabelingDraws

    rng = np.random.default_rng(seed)
    rel = rng.uniform(2, 8, (b, h, w)).astype(np.float32)
    K = np.tile(np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]], np.float32),
                (b, 1, 1))
    masks = np.zeros((b, i, h, w), bool)
    for ii in range(i):
        y, x = 8 + 10 * (ii // 2), 8 + 30 * (ii % 2)
        masks[:, ii, y:y + 12, x:x + 20] = True
    gen = torch.Generator().manual_seed(seed)
    draws = LabelingDraws(
        draw_ransac(b, h * w, generator=gen),
        draw_instance_ranks(torch.from_numpy(masks.reshape(b, i, -1).sum(-1)), 64, gen))
    return (rel, rel * 2.0, np.ones((b, h, w), bool), K, masks), draws


def labeling_rows(mesh, inputs: tuple, draws, num_points: int = 64) -> dict:
    """`labeling_step` on this rank's rows, in the mesh's data group, of
    `inputs` and their `draws` (numpy results)."""
    from labelany3d_tpu_torch.parallel.mesh import shard_batch
    from labelany3d_tpu_torch.pipeline.labeling import labeling_step

    local, local_draws = shard_batch(mesh, (inputs, draws))
    aligned, out = labeling_step(*local, draws=local_draws, num_points=num_points)
    return {"aligned": aligned.cpu().numpy(), "center_cam": out.boxes.center_cam.cpu().numpy(),
            "num_valid": out.num_valid.cpu().numpy()}


def labeling_worker(rank: int, world: int, inputs: tuple, draws, num_points: int) -> dict:
    """`labeling_rows` over a data axis of `world` ranks."""
    from labelany3d_tpu_torch.parallel.mesh import make_mesh

    return labeling_rows(make_mesh(world, 1, device=mesh_device_type()), inputs, draws,
                         num_points)


def _production_shards(mesh, tp: int) -> dict:
    """Each parameter's shard of MoGe ViT-L at 518 px on `meta`, against
    the rule's shape; the qkv and fc1 output dims in particular."""
    from labelany3d_tpu_torch.models.moge import MoGeConfig, MoGeModel
    from labelany3d_tpu_torch.parallel.sharding import shard_params, shard_shape

    with torch.device("meta"):
        model = MoGeModel(MoGeConfig.vitl(), ENTRY_HW)
    full = {k: tuple(v.shape) for k, v in model.named_parameters()}
    shard_params(mesh, model)
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    bad = [k for k, s in got.items() if s != shard_shape(k, full[k], tp)]
    if bad or set(got) != set(full):
        raise AssertionError(f"production shards off the rule: {bad[:5]}")
    qkv, fc1 = got["backbone.block0.attn.qkv.weight"], got["backbone.block0.mlp.fc1.weight"]
    if qkv[0] * tp != 3072 or fc1[0] * tp != 4096:
        raise AssertionError(f"qkv {qkv}, fc1 {fc1} at tp={tp}")
    heads = model.backbone.block0.attn.num_heads
    if heads * tp != 16:
        raise AssertionError(f"{heads} local heads at tp={tp}")
    return {"qkv_out": qkv[0], "fc1_out": fc1[0], "local_heads": heads,
            "sharded": sum(s != full[k] for k, s in got.items()), "parameters": len(got)}


def _production_split(mesh, dp: int) -> dict:
    """The rows each rank takes of the labeling step's, the fused `fast`
    program's and the matcher's production inputs (`meta` tensors)."""
    from labelany3d_tpu_torch.parallel.mesh import shard_batch

    b, h, w, n_inst, pairs, size = 8, 480, 640, 8, 8, 512

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    labeling = (meta(b, h, w), meta(b, h, w), meta(b, h, w, dtype=torch.bool),
                meta(b, 3, 3), meta(b, n_inst, h, w, dtype=torch.bool))
    fast = (*labeling[:4], meta(b, h, w, dtype=torch.uint8))
    views = meta(pairs, size, size, 3)
    got = {"labeling": [t.shape[0] for t in shard_batch(mesh, labeling)],
           "fast": [t.shape[0] for t in shard_batch(mesh, fast)],
           "matcher_views": shard_batch(mesh, (views,))[0].shape[0]}
    if set(got["labeling"] + got["fast"]) != {b // dp} or got["matcher_views"] != pairs // dp:
        raise AssertionError(f"data split off b/dp at dp={dp}: {got}")
    return got


def _dryrun_rank(rank: int, world: int) -> dict:
    from labelany3d_tpu_torch.parallel.mesh import make_mesh

    dp, tp = factor(world)
    batch = max(dp, 2)
    h = w = 32
    images = np.random.default_rng(0).uniform(size=(batch, h, w, 3)).astype(np.float32)
    target = np.full((batch, h, w), 2.0, np.float32)
    valid = np.ones((batch, h, w), bool)
    res = train_worker(rank, world, tiny_moge_config(), (h, w), dp, tp,
                       (images, target, valid), steps=2)
    res.pop("params", None)
    res.pop("points")
    if not (np.isfinite(res["losses"]).all() and res["step"] == 2):
        raise AssertionError(f"dry-run steps: losses {res['losses']}, step {res['step']}")
    mesh = make_mesh(dp, tp, device=mesh_device_type())
    res["production_shards"] = _production_shards(mesh, tp)
    res["production_split"] = _production_split(mesh, dp)
    inputs, draws = labeling_batch(b=2 * dp)
    lab = labeling_rows(mesh, inputs, draws)
    if lab["aligned"].shape[0] != 2 or not np.isfinite(lab["aligned"]).all():
        raise AssertionError(f"labeling on this rank's rows: {lab['aligned'].shape}")
    res["labeling_rows"] = lab["aligned"].shape[0]
    res["forbidden"] = forbidden_modules()
    if res["forbidden"]:
        raise AssertionError(f"a rank imported {res['forbidden']}")
    return res


def dryrun_multichip(n: int, device=None, timeout: float = 300.0) -> list[dict]:
    """The tiny dp x tp train step twice over `n` ranks, the production
    shard shapes and data splits; returns each rank's report. Raises if any
    rank fails."""
    from labelany3d_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_dryrun_rank, n, device=device, timeout=timeout)
