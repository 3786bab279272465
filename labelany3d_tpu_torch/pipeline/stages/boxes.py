"""The boxes stage: depth-only 3D boxes from the aligned depth and the masks.

Counterpart of `labelany3d_tpu/pipeline/stages/boxes.py`: per scene whose
depth exists and whose boxes do not, the aligned depth and the instance
masks are resized nearest to the configured bucket (K scaled with them), the
masks padded to `cfg.max_instances` slots and bit-packed; per batch of
`cfg.batch_size` scenes `label_program` runs on the device (with
`bbox_method=minarea_pallas`, one launch of the yaw kernel a batch); then one
pool thread writes `3dbbox.json` (kept instances whose box is `ok`),
`bboxes.json` and the overlay while the next batch is labelled.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from labelany3d_tpu_torch.data.coconut import xywh_to_xyxy
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.labeling import label_program
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.pipeline.stages.common import (
    pack_instance_masks,
    pad_instances,
    resize_nearest,
)
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.png import read_png


class BoxStage:
    """`draws`, when given, holds each batch's (B, I, S) sample ranks in
    order (parity tests pass the JAX package's); otherwise they come from a
    generator seeded with `cfg.seed + 7`, the JAX stage's key."""

    def __init__(self, cfg: PipelineConfig, loader, save_dir: str, split: str,
                 instance_provider=None, device: str | torch.device | None = None,
                 draws=None):
        from labelany3d_tpu_torch.data.sources import CoconutInstanceProvider

        self.cfg = cfg
        self.loader = loader
        self.save_dir = save_dir
        self.split = split
        self.provider = instance_provider or CoconutInstanceProvider(loader)
        self.device = resolve_device(device)
        self.draws = draws
        self._batches = 0
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 7)

    def _scene(self, info: dict) -> SceneDir:
        return SceneDir(os.path.join(self.save_dir, self.split,
                                     scene_dir_name(info["file_name"]))).ensure()

    def _prep(self, item):
        """Host prep of one scene: instances, depth and K at the bucket,
        packed masks. None for a scene without instances."""
        info, scene = item
        cfg = self.cfg
        image = None
        if getattr(self.provider, "needs_image", True) and scene.input_image.exists():
            image = read_png(scene.input_image)
        inst = self.provider.instances(info, image)
        if len(inst) == 0:
            return None
        depth = scene.read_depth()
        K = np.asarray(scene.read_cam_params()["K"], np.float64)
        oh, ow = depth.shape
        bh, bw = cfg.image_height, cfg.image_width
        K_b = K.astype(np.float32)
        K_b[0] *= bw / ow
        K_b[1] *= bh / oh
        masks_p, kept = pad_instances(resize_nearest(inst.masks, bh, bw), cfg.max_instances)
        return (scene, inst.labels, xywh_to_xyxy(inst.bboxes), K,
                resize_nearest(depth, bh, bw).astype(np.float32), K_b,
                pack_instance_masks(masks_p), kept)

    def _write(self, group, boxes: dict) -> None:
        cfg = self.cfg
        for row, (scene, labels, bboxes_xyxy, K, _d, _k, _p, kept) in enumerate(group):
            bbox_list = []
            for i, label in enumerate(labels):
                if i >= cfg.max_instances or not kept[i] or not boxes["ok"][row, i]:
                    continue
                bbox_list.append({
                    "obj_id": str(i),
                    "category_name": label.replace(" ", "_"),
                    "center_cam": boxes["center_cam"][row, i].tolist(),
                    "R_cam": boxes["R_cam"][row, i].tolist(),
                    "dimensions": boxes["dimensions"][row, i].tolist(),
                    "bbox3D_cam": boxes["vertices"][row, i].tolist(),
                })
            scene.write_bbox3d(bbox_list)
            scene.write_bboxes2d(bboxes_xyxy)
            if not scene.input_image.exists():
                continue
            try:
                from labelany3d_tpu_torch.utils.visualization import draw_cube_overlay

                draw_cube_overlay(scene, image=read_png(scene.input_image), K=K,
                                  cubes=bbox_list)
            except ImportError as e:  # the overlay is optional (needs OpenCV)
                from labelany3d_tpu_torch.utils.logging import warn_once

                warn_once("overlay", f"vis_3dbox.png skipped: {e}")

    def label(self, group):
        """`label_program` over one prepared batch on the stage's device;
        returns its LabelingOutput."""
        dev, cfg = self.device, self.cfg
        packed = np.stack([g[6] for g in group])
        if packed.dtype == np.uint32:  # torch has few uint32 ops
            packed = packed.astype(np.int64)
        draws = None if self.draws is None else self.draws[self._batches]
        self._batches += 1
        return label_program(torch.as_tensor(np.stack([g[4] for g in group]), device=dev),
                             torch.as_tensor(np.stack([g[5] for g in group]), device=dev),
                             torch.as_tensor(packed, device=dev),
                             max_instances=cfg.max_instances, num_points=cfg.num_points,
                             method=cfg.bbox_method, draws=draws, generator=self.generator)

    @torch.inference_mode()
    def run(self, start_index: int, end_index: int) -> int:
        from concurrent.futures import ThreadPoolExecutor

        from labelany3d_tpu_torch.data.prefetch import Prefetcher

        cfg = self.cfg
        pending, writes = [], []
        done = 0
        io_pool = ThreadPoolExecutor(max_workers=1)

        def fetch_and_write(group, boxes_dev):
            self._write(group, {k: v.cpu().numpy() for k, v in boxes_dev._asdict().items()})

        def flush():
            nonlocal done
            if not pending:
                return
            group = list(pending)
            pending.clear()
            writes.append(io_pool.submit(fetch_and_write, group, self.label(group).boxes))
            done += len(group)

        todo = []
        for idx in range(start_index, end_index):
            info = self.loader.get_image_by_index(idx)
            scene = self._scene(info)
            if scene.boxes_done() or not scene.depth_done():
                continue
            todo.append((info, scene))
        try:
            for item in Prefetcher(todo, self._prep, depth=2 * cfg.batch_size, num_workers=4):
                if item is None:
                    continue
                pending.append(item)
                if len(pending) == cfg.batch_size:
                    flush()
            flush()
            for w in writes:
                w.result()
        finally:
            io_pool.shutdown(wait=True)
        return done
