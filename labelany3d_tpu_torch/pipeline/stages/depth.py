"""Stage 1: depth estimation + RANSAC alignment, batched on the device.

Counterpart of `labelany3d_tpu/pipeline/stages/depth.py`: per batch of
`cfg.batch_size` images at one bucket, the depth backend's forward and the
RANSAC depth fusion run on the device; then one pool thread copies the
results to the host and writes `depth_map.npy`, `cam_params.json` and
`input.png` while the next batch is dispatched. Scenes whose depth exists
are skipped. With `write_ply`, each scene also gets its point cloud
(`depth_scene.ply`, every pixel, coloured) and its edge-filtered mesh
(`depth_scene_no_edge.ply`), the edge filter on the backend's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from labelany3d_tpu_torch.data.meshio import save_ply_mesh, save_ply_points
from labelany3d_tpu_torch.geometry.backproject import depth_to_points
from labelany3d_tpu_torch.geometry.edges import edge_filtered_scene_mesh
from labelany3d_tpu_torch.pipeline.backends import DepthBackend
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.labeling import depth_fusion
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.pipeline.stages.common import ImageSource, resize_image, resize_nearest
from labelany3d_tpu_torch.utils.png import write_png


class DepthStage:
    def __init__(self, cfg: PipelineConfig, backend: DepthBackend, loader,
                 image_source: ImageSource, save_dir: str, split: str, write_ply: bool = False):
        self.cfg = cfg
        self.backend = backend
        self.loader = loader
        self.image_source = image_source
        self.save_dir = save_dir
        self.split = split
        self.write_ply = write_ply
        self.generator = torch.Generator(device=backend.device).manual_seed(cfg.seed)

    def _scene(self, info: dict) -> SceneDir:
        return SceneDir(os.path.join(self.save_dir, self.split,
                                     scene_dir_name(info["file_name"]))).ensure()

    def _load(self, item):
        info, scene = item
        img = self.image_source.get(info)
        bucket = self.cfg.pick_bucket(*img.shape[:2])
        return info, scene, img, bucket, resize_image(img, *bucket)

    def _write(self, bucket, group, aligned_dev, K_dev):
        aligned = aligned_dev.cpu().numpy()
        K_bucket = K_dev.cpu().numpy().astype(np.float32)
        bh, bw = bucket
        for row, (_info, scene, img, _b, _r) in enumerate(group):
            oh, ow = img.shape[:2]
            K = K_bucket[row].copy()
            K[0] *= ow / bw
            K[1] *= oh / bh
            depth = resize_nearest(aligned[row], oh, ow)
            scene.write_depth(depth)
            scene.write_cam_params(K, np.eye(4), ow, oh)
            if not scene.input_image.exists():
                write_png(scene.input_image, img)
            if self.write_ply:
                self._write_ply(scene, img, depth, K)

    def _write_ply(self, scene: SceneDir, img: np.ndarray, depth: np.ndarray, K: np.ndarray):
        dev = self.backend.device
        d = torch.as_tensor(depth, device=dev)
        pts = depth_to_points(d, torch.as_tensor(K, device=dev))
        save_ply_points(scene.root / "depth_scene.ply", pts.cpu().numpy().reshape(-1, 3),
                        img.reshape(-1, 3))
        mesh = edge_filtered_scene_mesh(pts, img, d, (d > 0) & (d < 9000))
        save_ply_mesh(scene.root / "depth_scene_no_edge.ply", *mesh)

    @torch.inference_mode()
    def run(self, start_index: int, end_index: int) -> int:
        """Process [start_index, end_index); returns the number of images."""
        from concurrent.futures import ThreadPoolExecutor

        from labelany3d_tpu_torch.data.prefetch import Prefetcher

        pending: dict[tuple, list] = {}
        writes = []
        done = 0
        io_pool = ThreadPoolExecutor(max_workers=1)

        def flush(bucket):
            nonlocal done
            group = pending.pop(bucket, [])
            if not group:
                return
            out = self.backend.infer(np.stack([g[4] for g in group]))
            aligned = depth_fusion(out["relative_depth"], out["metric_depth"],
                                   out["depth_mask"], generator=self.generator)
            writes.append(io_pool.submit(self._write, bucket, group, aligned,
                                         out["K_pixels"]))
            done += len(group)

        todo = []
        for i in range(start_index, end_index):
            info = self.loader.get_image_by_index(i)
            scene = self._scene(info)
            if not scene.depth_done():
                todo.append((info, scene))
        try:
            for item in Prefetcher(todo, self._load, depth=2 * self.cfg.batch_size,
                                   num_workers=4):
                bucket = item[3]
                pending.setdefault(bucket, []).append(item)
                if len(pending[bucket]) == self.cfg.batch_size:
                    flush(bucket)
            for bucket in list(pending):
                flush(bucket)
            for w in writes:
                w.result()
        finally:
            io_pool.shutdown(wait=True)
        return done
