"""Fused fast path: depth + 3D boxes in one pass, artifacts written once.

Counterpart of `labelany3d_tpu/pipeline/stages/fused.py`: per batch of
`cfg.batch_size` images at one bucket, the depth backend's forward and the
fused labeling program (RANSAC align + mask unpack + box fit) run on the
device, then one pool thread copies the results to the host and writes the
scene directory (depth_map.npy, cam_params.json, input.png, 3dbbox.json,
bboxes.json, vis_3dbox.png) while the next batch is dispatched.

Spans (`utils/profiling.py::annotate`): `fused.prefetch_wait` (the main
thread waiting on the prefetcher), `fused.prep` (one image, on a
prefetch thread), `fused.dispatch` (a batch up to its write's hand-off,
holding `depth.infer` and `labeling.program`), `fused.write` (on the
writer thread) and `fused.drain` (the wait for the last writes); a
batch's spans share its sequence number as their unit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from labelany3d_tpu_torch.data.coconut import xywh_to_xyxy
from labelany3d_tpu_torch.pipeline.backends import DepthBackend
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.labeling import fused_label_program
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.pipeline.stages.common import (
    ImageSource,
    pack_instance_masks,
    pad_instances,
    resize_image,
    resize_nearest,
)
from labelany3d_tpu_torch.utils.png import write_png
from labelany3d_tpu_torch.utils.profiling import annotate

_END = object()


class FusedFastStage:
    """Depth estimation + depth-only 3D box labeling, one pass per batch."""

    def __init__(self, cfg: PipelineConfig, backend: DepthBackend, loader,
                 image_source: ImageSource, save_dir: str, split: str,
                 instance_provider=None):
        from labelany3d_tpu_torch.data.sources import CoconutInstanceProvider

        self.cfg = cfg
        self.backend = backend
        self.loader = loader
        self.image_source = image_source
        self.save_dir = save_dir
        self.split = split
        self.provider = instance_provider or CoconutInstanceProvider(loader)
        self.device = backend.device
        # Sample draws of the labeling program (RANSAC, instance points).
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _scene(self, info: dict) -> SceneDir:
        return SceneDir(os.path.join(self.save_dir, self.split,
                                     scene_dir_name(info["file_name"]))).ensure()

    def _prep(self, item):
        """Worker-side decode + bucket resize + instance pack."""
        with annotate("fused.prep"):
            info, scene = item
            cfg = self.cfg
            img = self.image_source.get(info)
            bucket = cfg.pick_bucket(*img.shape[:2])
            resized = resize_image(img, *bucket)
            image_for_provider = img if getattr(self.provider, "needs_image", True) else None
            inst = self.provider.instances(info, image_for_provider)
            if len(inst) == 0:
                return None
            masks_p, kept = pad_instances(resize_nearest(inst.masks, *bucket), cfg.max_instances)
            return (info, scene, img, bucket, resized, pack_instance_masks(masks_p), kept,
                    inst.labels, xywh_to_xyxy(inst.bboxes))

    def _write(self, bucket, group, aligned, K_bucket, boxes):
        cfg = self.cfg
        bh, bw = bucket
        for row, (info, scene, img, _b, _r, _p, kept, labels, bb2d) in enumerate(group):
            oh, ow = img.shape[:2]
            K = K_bucket[row].copy()
            K[0] *= ow / bw
            K[1] *= oh / bh
            scene.write_depth(resize_nearest(aligned[row], oh, ow))
            scene.write_cam_params(K, np.eye(4), ow, oh)
            if not scene.input_image.exists():
                write_png(scene.input_image, img)
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
            scene.write_bboxes2d(bb2d)
            try:
                from labelany3d_tpu_torch.utils.visualization import draw_cube_overlay

                draw_cube_overlay(scene, image=img, K=K, cubes=bbox_list)
            except ImportError as e:  # the overlay is optional (needs OpenCV)
                from labelany3d_tpu_torch.utils.logging import warn_once

                warn_once("overlay", f"vis_3dbox.png skipped: {e}")

    @torch.inference_mode()
    def run(self, start_index: int, end_index: int) -> int:
        from concurrent.futures import ThreadPoolExecutor

        from labelany3d_tpu_torch.data.prefetch import Prefetcher

        cfg = self.cfg
        pending: dict[tuple, list] = {}
        writes = []
        done = 0
        io_pool = ThreadPoolExecutor(max_workers=1)

        def fetch_and_write(seq, bucket, group, aligned_dev, K_dev, boxes_dev):
            with annotate("fused.write", unit=seq):
                aligned = aligned_dev.cpu().numpy()
                K_bucket = K_dev.cpu().numpy().astype(np.float32)
                boxes = {k: v.cpu().numpy() for k, v in boxes_dev._asdict().items()}
                self._write(bucket, group, aligned, K_bucket, boxes)

        def flush(bucket):
            nonlocal done
            group = pending.pop(bucket, [])
            if not group:
                return
            seq = len(writes)
            with annotate("fused.dispatch", unit=seq):
                batch = np.stack([g[4] for g in group])  # uint8; normalised on device
                packed = np.stack([g[5] for g in group])
                if packed.dtype == np.uint32:  # torch has few uint32 ops
                    packed = packed.astype(np.int64)
                packed = torch.as_tensor(packed, device=self.device)
                with annotate("depth.infer"):
                    out = self.backend.infer(batch)
                with annotate("labeling.program"):
                    aligned, boxes = fused_label_program(
                        out["relative_depth"], out["metric_depth"], out["depth_mask"],
                        out["K_pixels"], packed, max_instances=cfg.max_instances,
                        num_points=cfg.num_points, method=cfg.bbox_method,
                        generator=self.generator)
            writes.append(io_pool.submit(fetch_and_write, seq, bucket, group, aligned,
                                         out["K_pixels"], boxes))
            done += len(group)

        todo = []
        for i in range(start_index, end_index):
            info = self.loader.get_image_by_index(i)
            scene = self._scene(info)
            if scene.depth_done() and scene.boxes_done():
                continue
            todo.append((info, scene))

        try:
            items = iter(Prefetcher(todo, self._prep, depth=2 * cfg.batch_size, num_workers=4))
            while True:
                with annotate("fused.prefetch_wait"):
                    item = next(items, _END)
                if item is _END:
                    break
                if item is None:
                    continue
                bucket = item[3]
                pending.setdefault(bucket, []).append(item)
                if len(pending[bucket]) == cfg.batch_size:
                    flush(bucket)
            for bucket in list(pending):
                flush(bucket)
            with annotate("fused.drain"):
                for w in writes:
                    w.result()
        finally:
            io_pool.shutdown(wait=True)
        return done
