"""Stage 3: per-instance square crops + crop params.

Counterpart of `labelany3d_tpu/pipeline/stages/crops.py`: per instance,
7x7 binary opening, a minimum mask area, a square padded crop resampled to
`crop_size`, crop params in original-image coordinates, and `bboxes.json`
with the selected XYXY boxes. The image goes to the device once per scene.
An enhanced image in the scene dir is used with the 4x bookkeeping.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from labelany3d_tpu_torch.data.coconut import xywh_to_xyxy
from labelany3d_tpu_torch.geometry.crops import crop_object_params, crop_resample
from labelany3d_tpu_torch.geometry.masks import binary_opening, upscale_mask_nearest
from labelany3d_tpu_torch.pipeline.config import PipelineConfig
from labelany3d_tpu_torch.pipeline.scene import SceneDir, scene_dir_name
from labelany3d_tpu_torch.pipeline.stages.common import ImageSource
from labelany3d_tpu_torch.utils.device import resolve_device
from labelany3d_tpu_torch.utils.png import read_png, write_png


class CropStage:
    def __init__(
        self,
        cfg: PipelineConfig,
        loader,
        image_source: ImageSource,
        save_dir: str,
        split: str,
        crop_size: int = 512,
        min_mask_pixels: int = 6400,
        instance_provider=None,
        device: str | torch.device | None = None,
    ):
        from labelany3d_tpu_torch.data.sources import CoconutInstanceProvider

        self.cfg = cfg
        self.loader = loader
        self.image_source = image_source
        self.save_dir = save_dir
        self.split = split
        self.crop_size = crop_size
        self.min_mask_pixels = min_mask_pixels
        self.provider = instance_provider or CoconutInstanceProvider(loader)
        self.device = resolve_device(device)

    def _crop(self, image: torch.Tensor, mask: torch.Tensor, factor: int):
        m = upscale_mask_nearest(mask, factor) if factor > 1 else mask
        m = binary_opening(m, size=7)
        params = crop_object_params(m, crop_size=self.crop_size)
        rgb, mcrop = crop_resample(image, m, params, self.crop_size)
        meta = torch.stack([params.offset_x, params.offset_y, params.scale])
        return rgb, mcrop, meta, m.sum()

    @torch.inference_mode()
    def run(self, start_index: int, end_index: int) -> int:
        done = 0
        for idx in range(start_index, end_index):
            info = self.loader.get_image_by_index(idx)
            scene = SceneDir(os.path.join(self.save_dir, self.split,
                                          scene_dir_name(info["file_name"]))).ensure()
            base_image = self.image_source.get(info)
            inst = self.provider.instances(info, base_image)
            if len(inst) == 0:
                continue
            if scene.enhanced_image.exists():
                image = read_png(scene.enhanced_image)[..., :3]
                factor = 4  # masks are upscaled 4x to the enhanced resolution
            else:
                image, factor = base_image, 1

            bboxes_xyxy = xywh_to_xyxy(inst.bboxes)
            img_dev = torch.tensor(image, device=self.device).float()  # copies
            masks_dev = torch.as_tensor(inst.masks, device=self.device)
            selected = []
            # Instances in reverse order, as the reference iterates them.
            for i in range(len(inst) - 1, -1, -1):
                label = inst.labels[i].replace(" (", ", ").replace(")", "")
                obj_id = f"{i}_{label.replace(' ', '_')}"
                rgb, mcrop, meta, msum = self._crop(img_dev, masks_dev[i], factor)
                if int(msum) < self.min_mask_pixels * (factor * factor) / 16:
                    continue  # 6400 px is defined at 4x; scaled for 1x crops
                selected.append(bboxes_xyxy[i])
                if scene.crops_done(obj_id):
                    continue
                rgba = np.concatenate([
                    rgb.clamp(0, 255).to(torch.uint8).cpu().numpy(),
                    (mcrop.cpu().numpy()[..., None] * 255).astype(np.uint8),
                ], axis=-1)
                write_png(scene.crop(obj_id), rgba)
                ox, oy, sc = meta.cpu().double().numpy()
                np.save(scene.crop_params(obj_id),
                        np.array([ox / factor, oy / factor, sc * factor]))
            scene.write_bboxes2d(np.asarray(selected, np.float64))
            done += 1
        return done
